"""Round metrics: counters/gauges/histograms, the AoU histogram and the
JSON scrubbing rule.

Copy of ``src/repro/obs/metrics.py``: ``AOU_BUCKET_EDGES``,
``aou_histogram``, ``json_safe``, ``Counter``, ``Gauge``, ``Histogram`` and
``MetricsRegistry`` (the first two live in ``core/plan.py`` and are
re-exported here). ``json_safe`` turns torch tensors into (nested) lists,
as the reference does for JAX arrays; a bf16 tensor goes through fp32.
``json_safe`` is the one scrubbing rule of ``History.as_dict``, the
Monte-Carlo summaries and the run ledger: arrays become lists, numpy
scalars Python scalars, non-finite floats ``None`` (bare NaN tokens break
strict JSON parsers).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.plan import AOU_BUCKET_EDGES, aou_histogram

__all__ = [
    "AOU_BUCKET_EDGES", "aou_histogram", "json_safe",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
]


def json_safe(v):
    """Recursively convert ``v`` to strict-JSON-safe types: ndarrays and
    tensors -> (nested) lists, numpy scalars -> Python scalars,
    non-finite floats -> None, dict keys -> str. Dataclasses pass through
    ``dataclasses.asdict``."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return json_safe(dataclasses.asdict(v))
    if isinstance(v, dict):
        return {str(k): json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [json_safe(x) for x in v]
    if isinstance(v, np.ndarray):
        return json_safe(v.tolist())
    if torch.is_tensor(v):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return json_safe(v.tolist())
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        v = float(v)
    if isinstance(v, float):
        return v if np.isfinite(v) else None
    if isinstance(v, (bool, int, str)) or v is None:
        return v
    return str(v)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


class Counter:
    """Monotone event count."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, k: int = 1) -> None:
        self.value += k

    def as_dict(self):
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins scalar."""
    __slots__ = ("value",)

    def __init__(self):
        self.value: Optional[float] = None

    def set(self, v) -> None:
        self.value = float(v)

    def as_dict(self):
        return {"type": "gauge", "value": json_safe(self.value)}


class Histogram:
    """Fixed-bucket histogram (same edge semantics as ``aou_histogram``:
    bucket i is (edges[i-1], edges[i]], last bucket > edges[-1])."""
    __slots__ = ("edges", "counts", "total", "sum")

    def __init__(self, edges: Sequence[float]):
        self.edges = tuple(float(e) for e in edges)
        self.counts = np.zeros(len(self.edges) + 1, dtype=np.int64)
        self.total = 0
        self.sum = 0.0

    def observe(self, v) -> None:
        self.observe_many(np.asarray([v], dtype=np.float64))

    def observe_many(self, values) -> None:
        values = np.asarray(values, dtype=np.float64).ravel()
        idx = np.searchsorted(np.asarray(self.edges), values, side="left")
        self.counts += np.bincount(idx, minlength=len(self.counts)
                                   ).astype(np.int64)
        self.total += values.size
        self.sum += float(values.sum())

    def as_dict(self):
        return {"type": "histogram", "edges": list(self.edges),
                "counts": self.counts.tolist(), "total": self.total,
                "sum": json_safe(self.sum)}


class MetricsRegistry:
    """Name -> instrument registry (get-or-create accessors). One registry
    per run; ``as_dict()`` snapshots everything JSON-safe for the
    ledger. Re-registering a histogram name with different edges raises —
    silently merging incompatible buckets corrupts counts."""

    def __init__(self):
        self._items: dict = {}

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, lambda: Counter())

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, lambda: Gauge())

    def histogram(self, name: str,
                  edges: Sequence[float] = AOU_BUCKET_EDGES) -> Histogram:
        h = self._get(name, Histogram, lambda: Histogram(edges))
        if h.edges != tuple(float(e) for e in edges):
            raise ValueError(
                f"histogram {name!r} already registered with edges "
                f"{h.edges}, got {tuple(edges)}")
        return h

    def _get(self, name, cls, make):
        item = self._items.get(name)
        if item is None:
            item = self._items[name] = make()
        elif not isinstance(item, cls):
            raise ValueError(f"metric {name!r} is a "
                             f"{type(item).__name__}, not a {cls.__name__}")
        return item

    def as_dict(self) -> dict:
        return {name: item.as_dict()
                for name, item in sorted(self._items.items())}
