"""Host-side tracing spans: where does a round's wall-clock go?

Counterpart of ``src/repro/obs/trace.py``. A ``Span`` is one timed region
of host code (a planner stage, an engine dispatch, a server round),
recorded on a monotonic clock (``time.perf_counter``) with explicit
nesting. Three contracts:

* **fencing**: a CUDA launch returns before the work finishes, so a span
  that closes without synchronising measures the enqueue, not the work.
  ``handle.fence(tensors)`` registers outputs whose CUDA devices are
  synchronised at span exit (a no-op for CPU tensors).
* **first-call split**: the first call of a kernel path pays the lazy
  ``nvcc`` build and the library load (kernels/build.py) on top of the
  work. Spans carry a ``cold`` flag (``Tracer.cold(key)`` marks the first
  sighting of a signature); ``compile_split`` times one first call apart
  from a steady one.
* **zero cost when disabled**: the global tracer is off by default and the
  disabled ``span`` is a shared no-op context (no allocation, no
  synchronisation), so the instrumentation stays on the hot paths.

Usage::

    from repro_torch.obs import trace
    with trace.tracing() as tr:
        with trace.span("engine.schedule_batch") as sp:
            out = eng.schedule_batch(...)
            sp.fence(out.t_round)
    print(trace.format_report(tr.summarize()))

``profile(outdir)`` wraps ``torch.profiler`` for the device timeline.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Callable, Optional

import torch

__all__ = [
    "Span", "Tracer", "tracing", "span", "cold", "get_tracer", "set_tracer",
    "fence", "compile_split", "profile", "summarize", "format_report",
]


@dataclasses.dataclass
class Span:
    """One closed timed region (monotonic-clock seconds)."""
    name: str
    t_start: float            # perf_counter() at entry
    duration_s: float         # fenced: includes the device synchronise
    depth: int                # nesting depth (0 = top level)
    parent: Optional[str]     # name of the enclosing span, None at top
    cold: bool                # first call of a signature
    meta: dict                # caller-attached key/values

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def fence(*objs) -> None:
    """Synchronise the CUDA device of every tensor in ``objs`` (tensors, or
    lists, tuples and dicts of them); CPU tensors need nothing."""
    devices = set()
    stack = list(objs)
    while stack:
        x = stack.pop()
        if torch.is_tensor(x):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for dev in devices:
        torch.cuda.synchronize(dev)


class _Handle:
    """The object a live ``span(...)`` yields: attach fences + metadata."""
    __slots__ = ("_fences", "meta")

    def __init__(self, meta: dict):
        self._fences: list = []
        self.meta = meta

    def fence(self, *tensors) -> None:
        """Register tensors whose devices are synchronised at exit."""
        self._fences.extend(tensors)

    def note(self, **meta) -> None:
        self.meta.update(meta)


class _NullHandle:
    """Shared no-op handle for the disabled tracer."""
    __slots__ = ()

    def fence(self, *tensors) -> None:
        pass

    def note(self, **meta) -> None:
        pass


_NULL_HANDLE = _NullHandle()


class _NullCtx:
    """Shared no-op context manager (no allocation per disabled span)."""
    __slots__ = ()

    def __enter__(self):
        return _NULL_HANDLE

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()


class _SpanCtx:
    """Live span context manager (a plain class: cheaper than a
    ``@contextmanager`` generator on hot paths)."""
    __slots__ = ("_tracer", "_name", "_cold", "_handle", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cold: bool, meta: dict):
        self._tracer = tracer
        self._name = name
        self._cold = cold
        self._handle = _Handle(meta)

    def __enter__(self):
        self._tracer._stack.append(self._name)
        self._t0 = time.perf_counter()
        return self._handle

    def __exit__(self, *exc):
        h = self._handle
        if h._fences:
            fence(*h._fences)
        dt = time.perf_counter() - self._t0
        tr = self._tracer
        tr._stack.pop()
        depth = len(tr._stack)
        parent = tr._stack[-1] if tr._stack else None
        # a late note(cold=...) overrides the entry-time flag, for spans
        # whose signature is only known mid-region
        cold = bool(h.meta.pop("cold", self._cold))
        tr.spans.append(Span(name=self._name, t_start=self._t0,
                             duration_s=dt, depth=depth, parent=parent,
                             cold=cold, meta=h.meta))
        return False


class Tracer:
    """Span collector. ``enabled=False`` makes every ``span`` a shared
    no-op. Not thread-safe by design: one tracer per calling thread."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.spans: list[Span] = []
        self._stack: list[str] = []
        self._seen: set = set()

    def span(self, name: str, *, cold: Optional[bool] = None, **meta):
        if not self.enabled:
            return _NULL_CTX
        return _SpanCtx(self, name, bool(cold), meta)

    def cold(self, key: Any) -> bool:
        """True exactly once per ``key``: mark the first call of a
        signature (where the build and load happen)."""
        if key in self._seen:
            return False
        self._seen.add(key)
        return True

    def clear(self) -> None:
        self.spans.clear()
        self._stack.clear()

    def summarize(self) -> list[dict]:
        return summarize(self.spans)


# -- global tracer -----------------------------------------------------------

_TRACER = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    global _TRACER
    old, _TRACER = _TRACER, tracer
    return old


def span(name: str, *, cold: Optional[bool] = None, **meta):
    """Open a span on the global tracer (no-op context when disabled)."""
    return _TRACER.span(name, cold=cold, **meta)


def cold(key: Any) -> bool:
    """``Tracer.cold`` on the global tracer (always False when disabled)."""
    return _TRACER.enabled and _TRACER.cold(key)


@contextlib.contextmanager
def tracing(enabled: bool = True):
    """Swap in a fresh enabled tracer for the block; restores the previous
    one on exit. Yields the new tracer."""
    old = set_tracer(Tracer(enabled=enabled))
    try:
        yield get_tracer()
    finally:
        set_tracer(old)


# -- first call against a steady call ----------------------------------------


def compile_split(fn: Callable, *args, **kwargs) -> tuple:
    """Call ``fn`` twice, each call fenced: returns ``(out, {"first_s",
    "steady_s"})``. On a fresh process the first call includes the lazy
    kernel build and the library load; the second is the steady cost."""
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        fence(out)
        times.append(time.perf_counter() - t0)
    return out, {"first_s": times[0], "steady_s": times[1]}


@contextlib.contextmanager
def profile(outdir: str):
    """``torch.profiler`` over the block (CPU, and CUDA where a card is
    visible); writes ``outdir/trace.json`` (a Chrome trace) at exit and
    yields the profiler (``key_averages()`` for sums by kernel)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with torch_profile(activities=acts) as prof:
        yield prof
    os.makedirs(outdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(outdir, "trace.json"))


# -- reporting ---------------------------------------------------------------


def summarize(spans: list[Span]) -> list[dict]:
    """Aggregate spans per name: call count, total/mean/max seconds, and
    the cold (first-call) vs warm split. Ordered by total descending."""
    agg: dict[str, dict] = {}
    for s in spans:
        a = agg.setdefault(s.name, {
            "name": s.name, "count": 0, "total_s": 0.0, "max_s": 0.0,
            "cold_count": 0, "cold_s": 0.0, "warm_s": 0.0,
        })
        a["count"] += 1
        a["total_s"] += s.duration_s
        a["max_s"] = max(a["max_s"], s.duration_s)
        if s.cold:
            a["cold_count"] += 1
            a["cold_s"] += s.duration_s
        else:
            a["warm_s"] += s.duration_s
    out = []
    for a in agg.values():
        warm_n = a["count"] - a["cold_count"]
        a["mean_s"] = a["total_s"] / a["count"]
        a["warm_mean_s"] = a["warm_s"] / warm_n if warm_n else None
        out.append(a)
    out.sort(key=lambda a: -a["total_s"])
    return out


def format_report(summary: list[dict]) -> str:
    """Fixed-width table of a ``summarize()`` result."""
    lines = [f"{'span':36s} {'calls':>6s} {'total':>10s} {'mean':>10s} "
             f"{'warm mean':>10s} {'cold':>10s}"]
    for a in summary:
        wm = a["warm_mean_s"]
        lines.append(
            f"{a['name'][:36]:36s} {a['count']:>6d} "
            f"{a['total_s'] * 1e3:>8.2f}ms {a['mean_s'] * 1e3:>8.2f}ms "
            f"{(wm * 1e3 if wm is not None else float('nan')):>8.2f}ms "
            f"{a['cold_s'] * 1e3:>8.2f}ms")
    return "\n".join(lines)
