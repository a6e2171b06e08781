"""Round-planner data types and diagnostics (numpy, host side).

Copy of ``RoundEnv``, ``Schedule``, ``schedule_diag``, ``JOINT_ENUM_MAX_N``,
``JOINT_SWAP_ITERS``, ``enumerate_subsets`` and ``cell_capacity`` from
``src/repro/core/plan.py``, and of ``AOU_BUCKET_EDGES`` and
``aou_histogram`` from ``src/repro/obs/metrics.py``. The engine
(core/engine.py) returns its batched result as tensors and hands one row
back as a ``Schedule``, the contract the FL server reads.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Optional, Sequence

import numpy as np

# AoU histogram bucket upper edges (ages are integers >= 1): bucket i
# counts ages in (edge[i-1], edge[i]], the last bucket counts > edge[-1].
AOU_BUCKET_EDGES = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0)

# n <= this: joint admission enumerates ALL C(n, c) candidate sets x all
# matchings; above it the swap/prune local search runs
JOINT_ENUM_MAX_N = 8

# swap/prune local search length: each iteration swaps the bottleneck
# client for the best-proxy non-member and keeps the swap only on a strict
# strong_weak-completion improvement
JOINT_SWAP_ITERS = 4


@functools.lru_cache(maxsize=None)
def enumerate_subsets(n: int, c: int) -> np.ndarray:
    """All size-``c`` subsets of ``range(n)`` as a (C(n,c), c) int array in
    ``itertools.combinations`` order (the argmin-first tiebreak of the
    joint enumeration)."""
    return np.array(list(itertools.combinations(range(n), c)),
                    dtype=np.int64).reshape(-1, c)


def cell_capacity(n: int, n_cells: int, slots: int) -> int:
    """Static per-cell member capacity of the cell-partitioned planner: the
    first ``cap`` members of a cell in client-index order are considered.
    ``2x`` the ceil-mean occupancy absorbs the imbalance of random
    placement; the ``2 * slots`` floor lets every cell fill its
    subchannels."""
    if n_cells <= 1:
        return n
    avg = -(-n // n_cells)
    return min(n, max(2 * avg, 2 * slots))


def aou_histogram(ages, edges: Sequence[float] = AOU_BUCKET_EDGES
                  ) -> np.ndarray:
    """Fixed-shape AoU bucket counts: ``ages`` (..., N) -> int64 counts
    (..., len(edges) + 1)."""
    ages = np.asarray(ages, dtype=np.float64)
    e = np.asarray(edges, dtype=np.float64)
    idx = np.searchsorted(e, ages, side="left")   # a <= e[i] -> bucket i
    k = len(e) + 1
    one_hot = idx[..., None] == np.arange(k)
    return one_hot.sum(axis=-2).astype(np.int64)


@dataclasses.dataclass
class RoundEnv:
    """Per-round wireless + client state visible to the scheduler."""
    gains: np.ndarray        # (N,) channel power gains this round
    n_samples: np.ndarray    # (N,) local dataset sizes
    cpu_freq: np.ndarray     # (N,) Hz
    ages: np.ndarray         # (N,) AoU
    model_bits: float        # uplink payload


@dataclasses.dataclass
class Schedule:
    selected: np.ndarray                 # (N,) bool
    pairs: list                          # [(strong, weak), ...]; weak=-1 solo
    rates: np.ndarray                    # (N,) bits/s (0 unselected)
    powers: np.ndarray                   # (N,) W
    t_cmp: np.ndarray                    # (N,) s
    t_com: np.ndarray                    # (N,) s
    t_round: float
    agg_weights: np.ndarray              # (N,) aggregation weights
    info: dict


def schedule_diag(sched: Schedule, ages: Optional[np.ndarray] = None, *,
                  cell: Optional[np.ndarray] = None,
                  n_cells: int = 1) -> dict:
    """Per-round diagnostics of a ``Schedule`` (DESIGN.md section 11): the
    bottleneck client's t_comp/t_up split (sums to t_round), selection and
    eviction counts, joint-swap acceptances, the population AoU histogram
    when ``ages`` is given, and ``sel_per_cell`` (selected clients per
    cell) when a cell map is given with ``n_cells > 1``."""
    sel = np.asarray(sched.selected, dtype=bool)
    tot = np.where(sel, sched.t_cmp + sched.t_com, 0.0)
    b = int(np.argmax(tot))
    any_sel = bool(sel.any())
    info = sched.info or {}
    diag = {
        "t_round": float(sched.t_round),
        "t_comp_bottleneck": float(sched.t_cmp[b]) if any_sel else 0.0,
        "t_up_bottleneck": float(sched.t_com[b]) if any_sel else 0.0,
        "n_selected": int(sel.sum()),
        "n_evicted": len(info.get("evicted", ())),
        "joint_swaps_accepted": int(info.get("joint_swaps_accepted", 0)),
    }
    if ages is not None:
        diag["aou_hist"] = aou_histogram(ages)
    if cell is not None and n_cells > 1:
        diag["sel_per_cell"] = np.bincount(
            np.asarray(cell, dtype=int)[sel], minlength=n_cells
        ).astype(np.int64)
    return diag
