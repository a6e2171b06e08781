"""The benchmark's machinery, shared by every cell: finding a cell's files
by name, the measured window, the traced run's spans and device timeline,
the result line and the check that no JAX module was loaded.

A cell is ``workloads/<name>.json``; it names its configuration
(``configs/<config>.json``) and the driver that runs it
(``drivers/<driver>.py``). A per-layer metric is ``metrics/<name>.py``,
whose ``read(ctx)`` returns a number or None. Which metrics a cell
reports comes from ``BENCHMARK.json``, so a cell, a configuration or a
metric is added as files and entries, never by editing a file here.

A driver module defines ``Cell(cfg, workload, seed, device)`` with:
``warm_up()`` (set-up after construction: every shape of the window, and
the first rounds the check follows), ``unit()`` (one unit of work; returns
its work count), ``end_to_end(units, work, seconds)`` (the cell's
end-to-end metrics), ``trace_hooks(spans)`` (a context manager that turns
on the spans the traced run reads), ``layer_context()`` (the shapes its
metric readers need), ``release()`` (frees the program's state once the
window has closed) and ``check()`` (the comparison with the plain
reference: a list of (name, value, limit), each passing where value <=
limit). ``calibrate.py`` and the tests also call ``follow(control)``,
``compare(outputs, reference)``, ``outputs()`` and ``control()``, the
parts ``check`` is made of.
"""
from __future__ import annotations

import contextlib
import heapq
import importlib.util
import json
import math
import re
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names no run may load: the JAX stack and the JAX package
BANNED_MODULES = ("jax", "jaxlib", "flax", "repro")
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
SHORT_GAP_S = 20e-6


def check_name(name: str) -> str:
    if not NAME_RE.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(name: str) -> dict:
    return load_json(BENCH / "workloads" / f"{check_name(name)}.json")


def config(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{check_name(name)}.json")


def _module(path: Path, qualname: str):
    if qualname in sys.modules:
        return sys.modules[qualname]
    spec = importlib.util.spec_from_file_location(qualname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[qualname] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    return _module(BENCH / "drivers" / f"{check_name(kind)}.py",
                   f"portbench_driver_{kind}")


def metric_reader(name: str):
    """``read`` of ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{check_name(name)}.py"
    return _module(path, "portbench_metric_" + name.replace(".", "_")).read


def benchmark_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def metrics_of(cell: str, spec: dict) -> tuple[list, list]:
    """(end-to-end metric names, per-layer metric names) that ``cell``
    reports under ``spec`` (BENCHMARK.json): an end-to-end metric where it
    lists the cell or lists no cells; a per-layer metric where it lists
    the cell, or lists none and moves an end-to-end metric the cell
    reports."""
    e2e = [m["name"] for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    layer = [m["name"] for m in spec["per_layer"]
             if cell in m.get("workloads", [cell] if m["moves"] in e2e
                              else [])]
    return e2e, layer


def json_line(obj) -> str:
    """``obj`` as strict JSON on one line: a number that is not finite
    (a broken run's gap) is written as the largest double, so the line
    still parses and still fails its limit."""
    def finite(x):
        if isinstance(x, float) and not math.isfinite(x):
            return sys.float_info.max
        if isinstance(x, dict):
            return {k: finite(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [finite(v) for v in x]
        return x
    return json.dumps(finite(obj), allow_nan=False)


def banned_loaded() -> list:
    """Top-level names of loaded modules that no run may load."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(BANNED_MODULES))


# -- the traced run's spans --------------------------------------------------


class Spans:
    """Fenced host spans the benchmark puts around calls into the program
    (traced run only): the device is synchronised at each span's start
    and end, so a span holds the device work it caused. Each span is also
    a ``torch.profiler`` annotation, so the device timeline can name what
    the host was doing."""

    def __init__(self, torch, device):
        self.torch = torch
        self.cuda = device.type == "cuda"
        self.records: list = []          # (name, seconds, meta)
        self._open: list = []

    def _sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        """A fenced span; a span inside another takes its ``profiled``."""
        if self._open and "profiled" not in meta:
            meta["profiled"] = self._open[-1].get("profiled")
        self._sync()
        self._open.append(meta)
        t0 = time.perf_counter()
        try:
            with self.torch.profiler.record_function("bench." + name):
                yield meta
                self._sync()
        finally:
            self._open.pop()
        self.records.append((name, time.perf_counter() - t0, meta))

    @contextlib.contextmanager
    def wrap(self, obj, attr: str, name: str):
        """Within the block, every call of ``obj.attr`` is a span."""
        had = attr in vars(obj)
        orig = getattr(obj, attr)

        def wrapped(*args, **kwargs):
            with self.span(name):
                return orig(*args, **kwargs)

        setattr(obj, attr, wrapped)
        try:
            yield
        finally:
            if had:
                setattr(obj, attr, orig)
            else:
                delattr(obj, attr)

    def steady(self, name: str) -> list:
        """(seconds, meta) of the spans called ``name`` outside the
        profiled units (all of them where every unit was profiled)."""
        hits = [(s, m) for n, s, m in self.records if n == name]
        plain = [h for h in hits if not h[1].get("profiled")]
        return plain or hits


# -- the device timeline -----------------------------------------------------


def _kineto_events(prof):
    """(device events, host events): lists of (name, start_s, end_s) from
    the profiler's raw events; device events are the card's kernels,
    copies and sets."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            t0, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        else:
            t0, dur = e.start_us() * 1e-6, e.duration_us() * 1e-6
        rec = (e.name(), t0, t0 + dur)
        if e.device_type() == DeviceType.CUDA:
            # an annotation's copy on the device timeline runs nothing
            if not _annotation(e):
                dev.append(rec)
        elif dur > 0:
            host.append(rec)
    return dev, host


def _annotation(e) -> bool:
    if hasattr(e, "is_user_annotation") and e.is_user_annotation():
        return True
    if hasattr(e, "activity_type") and "annotation" in str(e.activity_type()):
        return True
    return e.name().startswith("bench.")


def _busy_intervals(dev):
    ivs = sorted((s, e) for _, s, e in dev)
    merged: list = []
    for s, e in ivs:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(host, points):
    """For each time in ``points`` (sorted), the name of the latest-started
    host event that spans it (None where none does)."""
    evs = sorted(host, key=lambda r: r[1])
    active: list = []                   # heap of (end, -start, name)
    out, i = [], 0
    for p in points:
        while i < len(evs) and evs[i][1] <= p:
            heapq.heappush(active, (evs[i][2], -evs[i][1], evs[i][0]))
            i += 1
        while active and active[0][0] < p:
            heapq.heappop(active)
        best = min(active, key=lambda a: a[1], default=None)
        out.append(None if best is None else best[2])
    return out


def timeline(prof, top: int = 10) -> dict:
    """Device busy seconds, kernel seconds and counts by name, the device
    operations that took most time and the idle gaps between them named
    by the innermost host event at each gap's middle (gaps under
    SHORT_GAP_S summed as launch gaps)."""
    dev, host = _kineto_events(prof)
    merged = _busy_intervals(dev)
    busy = sum(e - s for s, e in merged)
    by_name: dict = {}
    for name, s, e in dev:
        c, t = by_name.get(name, (0, 0.0))
        by_name[name] = (c + 1, t + (e - s))
    ops = sorted(((n, t) for n, (_, t) in by_name.items()),
                 key=lambda x: -x[1])[:top]
    gaps = [(s1, e0) for (_, e0), (s1, _) in zip(merged, merged[1:])]
    short = sum(s1 - e0 for s1, e0 in gaps if s1 - e0 < SHORT_GAP_S)
    long_gaps = sorted(((s1 - e0, 0.5 * (s1 + e0)) for s1, e0 in gaps
                        if s1 - e0 >= SHORT_GAP_S), key=lambda g: g[1])
    names = _innermost(host, [m for _, m in long_gaps])
    idle: dict = {}
    for (length, _), name in zip(long_gaps, names):
        key = name or "host outside any traced op"
        idle[key] = idle.get(key, 0.0) + length
    if short:
        idle[f"launch gaps under {SHORT_GAP_S * 1e6:.0f} us"] = short
    idle_top = sorted(idle.items(), key=lambda x: -x[1])[:top]
    return {"busy_s": busy, "kernels": by_name,
            "device_ops": [[n[:200], t] for n, t in ops],
            "idle_gaps": [[n[:200], t] for n, t in idle_top]}


def kernel_time(kernels: dict, needle: str) -> tuple[int, float]:
    """(launches, device seconds) of the kernels whose name holds
    ``needle``."""
    hits = [v for k, v in kernels.items() if needle in k]
    return sum(c for c, _ in hits), sum(t for _, t in hits)


# -- one run of a cell -------------------------------------------------------


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device=None, wl: dict | None = None,
             cfg: dict | None = None, spec: dict | None = None,
             log=print) -> dict:
    """Set up ``cell``, warm it up, measure it for ``seconds``, check it
    against the plain reference; returns the result line as a dict (with
    ``checks`` last). ``wl``, ``cfg`` and ``spec`` default to the files of
    ``cell``; ``device`` to the first card."""
    import torch
    wl = wl if wl is not None else workload(cell)
    cfg = cfg if cfg is not None else config(wl["config"])
    spec = spec if spec is not None else benchmark_spec()
    e2e_names, layer_names = metrics_of(cell, spec)
    device = torch.device(device or "cuda")
    mod = driver(wl["driver"])
    run = mod.Cell(cfg, wl, seed, device)
    run.warm_up()
    _sync(torch, device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    spans = Spans(torch, device)
    units = work = 0
    traced_s = 0.0
    with contextlib.ExitStack() as stack:
        if trace:
            stack.enter_context(run.trace_hooks(spans))
        t0 = time.perf_counter()
        if trace:
            # the first units under the profiler, the rest under spans only
            with torch.profiler.profile(
                    activities=_activities(torch, device)) as prof:
                tp = time.perf_counter()
                for _ in range(int(wl.get("profile_units", 1))):
                    with spans.span("unit", profiled=True) as meta:
                        meta["work"] = run.unit()
                    work += meta["work"]
                    units += 1
                traced_s = time.perf_counter() - tp
        per_unit = []                    # (host seconds to return, work)
        while time.perf_counter() - t0 < seconds:
            tu = time.perf_counter()
            with (spans.span("unit", profiled=False) if trace
                  else contextlib.nullcontext({})) as meta:
                meta["work"] = run.unit()
            per_unit.append((time.perf_counter() - tu, meta["work"]))
            work += meta["work"]
            units += 1
        _sync(torch, device)
        window_s = time.perf_counter() - t0
    log(f"window {window_s:.3f} s, {units} units, work {work}")
    log("units (s, work): " + " ".join(f"{s:.4f}/{w}" for s, w in per_unit))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    tl = timeline(prof) if trace else None
    layer_ctx = run.layer_context() if trace else None
    run.release()
    checks = run.check()
    failed = run.failed_units() if hasattr(run, "failed_units") else 0

    if trace:
        ctx = {"spans": spans, "timeline": tl, "traced_window_s": traced_s,
               "window_s": window_s, "units": units, "work": work,
               **layer_ctx}
        metrics = {}
        units_of = {m["name"]: m["unit"] for m in spec["per_layer"]}
        for name in layer_names:
            val = metric_reader(name)(ctx)
            if val is not None:
                metrics[name] = {"value": float(val), "unit": units_of[name]}
    else:
        units_of = {m["name"]: m["unit"] for m in spec["end_to_end"]}
        vals = {"setup_s": setup_s,
                **run.end_to_end(units, work, window_s)}
        metrics = {n: {"value": float(vals[n]), "unit": units_of[n]}
                   for n in e2e_names if n in vals}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(wl.get("chips", 1)),
           "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = tl["busy_s"]
        dev["window_s"] = traced_s
    correct = all(v <= lim for _, v, lim in checks)
    out = {"correct": bool(correct), "attempted": units,
           "failed": int(failed), "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = {"device_ops": tl["device_ops"],
                            "idle_gaps": tl["idle_gaps"]}
    out["checks"] = {n: {"value": float(v), "limit": float(lim)}
                     for n, v, lim in checks}
    return out


def _activities(torch, device):
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
