"""Host-side tracing spans: where does a round's wall-clock go?

Counterpart of ``src/repro/obs/trace.py``. A ``Span`` is one timed region
of host code (a planner stage, an engine dispatch, a server round),
recorded on a monotonic clock (``time.perf_counter``) with explicit
nesting: its name, start, duration, parent and the counts its caller
notes at the same boundary. A layer's self time is its span minus its
children. Four contracts:

* **fencing at both ends**: a CUDA launch returns before the work
  finishes, so a span that closes without synchronising measures the
  enqueue, not the work. A span opened with ``fenced=True`` drains the
  current CUDA device at entry, so it holds no work queued before it, and
  at exit synchronises the devices of the outputs registered with
  ``handle.fence(tensors)`` (the current device when none is on a card).
  Its duration is the work launched inside it. Other spans never
  synchronise; they time the host and annotate the profiler's timeline.
* **one clock with the device trace**: whenever a ``torch.profiler`` is
  recording, every span opens ``torch.profiler.record_function(name)``,
  whether the tracer is on or not, so the profiler's timeline (and
  ``profile(outdir)``'s Chrome trace) shows the spans beside the kernels
  and names each idle gap by the innermost span.
* **first-call split**: the first call of a kernel path pays the lazy
  ``nvcc`` build and the library load (kernels/build.py) on top of the
  work. Spans carry a ``cold`` flag (``Tracer.cold(key)`` marks the first
  sighting of a signature).
* **zero cost when disabled**: the global tracer is off by default; with
  it off and no profiler recording, ``span`` returns a shared no-op
  context (no allocation, no synchronisation) after two flag reads, so the
  instrumentation stays on the hot paths.

Usage::

    from repro_torch.obs import trace
    with trace.tracing() as tr:
        with trace.span("engine.schedule_batch", fenced=True) as sp:
            out = eng.schedule_batch(...)
            sp.fence(out.t_round)
    print(trace.format_report(tr.summarize()))
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Optional

import torch
from torch.autograd import profiler as _profiler

__all__ = [
    "Span", "Tracer", "tracing", "span", "cold", "get_tracer", "set_tracer",
    "fence", "profile", "summarize", "format_report",
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


def fence(*objs) -> int:
    """Synchronise the CUDA device of every tensor in ``objs`` (tensors, or
    lists, tuples and dicts of them); CPU tensors need nothing. Returns
    the number of devices synchronised."""
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
    return len(devices)


def _drain() -> None:
    """Wait for the work queued on the current CUDA device (nothing where
    CUDA was never initialised)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _Handle:
    """The object a live ``span(...)`` yields: attach fences + metadata."""
    __slots__ = ("_fences", "_name", "meta")

    def __init__(self, name: str, fenced: bool, meta: dict):
        self._fences: Optional[list] = [] if fenced else None
        self._name = name
        self.meta = meta

    def fence(self, *tensors) -> None:
        """Register tensors whose devices are synchronised at exit."""
        if self._fences is None:
            raise ValueError(f"span {self._name!r} does not fence: open it "
                             f"with fenced=True")
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


def _annotation(name: str):
    """A profiler annotation over the block while a profiler records,
    else None."""
    if not _profiler._is_profiler_enabled:
        return None
    rf = _profiler.record_function(name)
    rf.__enter__()
    return rf


class _AnnotationCtx:
    """The span of a disabled tracer while a profiler records: an
    annotation on its timeline, nothing recorded, no synchronisation."""
    __slots__ = ("_name", "_rf")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        self._rf = _annotation(self._name)
        return _NULL_HANDLE

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


class _SpanCtx:
    """Live span context manager (a plain class: cheaper than a
    ``@contextmanager`` generator on hot paths)."""
    __slots__ = ("_tracer", "_name", "_cold", "_handle", "_t0", "_rf")

    def __init__(self, tracer: "Tracer", name: str, cold: bool,
                 fenced: bool, meta: dict):
        self._tracer = tracer
        self._name = name
        self._cold = cold
        self._handle = _Handle(name, fenced, meta)

    def __enter__(self):
        if self._handle._fences is not None:
            _drain()
        self._rf = _annotation(self._name)
        self._tracer._stack.append(self._name)
        self._t0 = time.perf_counter()
        return self._handle

    def __exit__(self, *exc):
        h = self._handle
        if h._fences is not None and not fence(*h._fences):
            _drain()
        dt = time.perf_counter() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
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
    """Span collector. ``enabled=False`` makes every ``span`` a profiler
    annotation while a profiler records, else a shared no-op. Not
    thread-safe by design: one tracer per calling thread."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.spans: list[Span] = []
        self._stack: list[str] = []
        self._seen: set = set()

    def span(self, name: str, *, cold: Optional[bool] = None,
             fenced: bool = False, **meta):
        if self.enabled:
            return _SpanCtx(self, name, bool(cold), fenced, meta)
        if _profiler._is_profiler_enabled:
            return _AnnotationCtx(name)
        return _NULL_CTX

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


def span(name: str, *, cold: Optional[bool] = None, fenced: bool = False,
         **meta):
    """Open a span on the global tracer (``fenced``: drain the device at
    entry and synchronise the registered outputs at exit; a profiler
    annotation only, or a no-op context, when the tracer is disabled)."""
    if not (_TRACER.enabled or _profiler._is_profiler_enabled):
        return _NULL_CTX
    return _TRACER.span(name, cold=cold, fenced=fenced, **meta)


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


# -- the device timeline ----------------------------------------------------


@contextlib.contextmanager
def profile(outdir: str):
    """``torch.profiler`` over the block (CPU, and CUDA where a card is
    visible); writes ``outdir/trace.json`` (a Chrome trace of the spans,
    host operations and kernels on one clock) at exit and yields the
    profiler (``key_averages()`` for sums by kernel)."""
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
