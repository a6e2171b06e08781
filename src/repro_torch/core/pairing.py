"""Perfect-matching enumeration of the hungarian pairing policy.

Copy of ``ENUM_MAX_PAIRS`` and ``enumerate_matchings`` from
``src/repro/core/pairing.py``, in the same recursive order: that order is
the argmin-first tiebreak the enumeration shares with the reference.
"""
from __future__ import annotations

import functools

import numpy as np

# m <= this: the hungarian policy solves the bottleneck exactly by
# enumerating all perfect matchings (15 at m=3, 105 at m=4)
ENUM_MAX_PAIRS = 4


@functools.lru_cache(maxsize=None)
def enumerate_matchings(m: int) -> np.ndarray:
    """All perfect matchings of ``range(2m)`` as an (L, m, 2) int array,
    pairs normalized (lo, hi), in the reference's recursive order."""
    def rec(items):
        if not items:
            return [[]]
        a, out = items[0], []
        for i in range(1, len(items)):
            rest = items[1:i] + items[i + 1:]
            out += [[(a, items[i])] + sub for sub in rec(rest)]
        return out

    return np.array(rec(list(range(2 * m))),
                    dtype=np.int64).reshape(-1, max(m, 0), 2)
