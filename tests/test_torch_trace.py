"""The port's tracer (src/repro_torch/obs/trace.py), its spans on the FL,
engine and planner paths, and the roofline placement
(src/repro_torch/launch/roofline.py) against the reference's
(src/repro/obs/trace.py, src/repro/launch/roofline.py). The tracer tests
mirror tests/test_obs.py's."""
import dataclasses
import json

import numpy as np
import pytest
import torch

import chip_smoke
from repro.launch import roofline as jroofline
from repro_torch.configs import FLConfig, NOMAConfig, get_config
from repro_torch.core.engine import WirelessEngine
from repro_torch.data import TaskConfig
from repro_torch.fl import FLServer
from repro_torch.launch import roofline
from repro_torch.obs import trace

TINY_KW = dict(d_model=32, d_ff=64, vocab_size=32, n_layers=2)


def test_span_nesting_and_parent():
    with trace.tracing() as tr:
        with trace.span("outer"):
            with trace.span("inner", k=1):
                pass
        with trace.span("outer2"):
            pass
    names = [s.name for s in tr.spans]
    assert names == ["inner", "outer", "outer2"]  # post-order append
    by = {s.name: s for s in tr.spans}
    assert by["inner"].parent == "outer" and by["inner"].depth == 1
    assert by["outer"].parent is None and by["outer"].depth == 0
    assert by["inner"].meta == {"k": 1}
    assert all(s.duration_s >= 0 for s in tr.spans)


def test_span_disabled_is_noop():
    before = list(trace.get_tracer().spans)
    with trace.span("nope") as h:
        h.note(x=1)
        h.fence(torch.zeros(3))
    assert list(trace.get_tracer().spans) == before
    assert trace.cold(("some", "key")) is False
    # one shared context and handle: nothing is allocated per span
    assert trace.span("a") is trace.span("b")


def test_cold_fires_once_per_key():
    with trace.tracing() as tr:
        assert trace.cold(("sig", 1)) is True
        assert trace.cold(("sig", 1)) is False
        assert trace.cold(("sig", 2)) is True
        with trace.span("s", cold=trace.cold(("sig", 1))):
            pass
    assert tr.spans[0].cold is False


def test_span_note_late_cold_override():
    with trace.tracing() as tr:
        with trace.span("s", cold=False) as h:
            h.note(cold=True, extra=7)
    s = tr.spans[0]
    assert s.cold is True
    assert s.meta == {"extra": 7}  # cold consumed, not left in meta


def test_summarize_and_report():
    with trace.tracing() as tr:
        for i in range(3):
            with trace.span("work", cold=(i == 0)):
                pass
    summ = trace.summarize(tr.spans)
    row = next(r for r in summ if r["name"] == "work")
    assert row["count"] == 3 and row["cold_count"] == 1
    assert row["total_s"] == pytest.approx(
        row["cold_s"] + row["warm_s"], rel=1e-9)
    assert "work" in trace.format_report(summ)
    assert json.loads(json.dumps(tr.spans[0].as_dict(),
                                 allow_nan=False))["name"] == "work"


def test_fence_compile_split_and_profile(tmp_path):
    """``fence`` synchronises no device for CPU tensors; ``profile``
    exports the port's spans and the operations on one clock."""
    x = torch.arange(6.0)
    # CPU: nothing to do
    assert trace.fence(x, [x, {"k": (x,)}], "not a tensor") == 0
    with trace.tracing() as tr, \
            trace.profile(str(tmp_path / "prof")) as prof:
        with trace.span("port.mm"):
            torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert any("mm" in e.key for e in prof.key_averages())
    assert [s.name for s in tr.spans] == ["port.mm"]
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    ev = {e["name"]: e for e in events["traceEvents"] if "ts" in e}
    assert "port.mm" in ev and "aten::mm" in ev
    span, mm = ev["port.mm"], ev["aten::mm"]
    assert span["ts"] <= mm["ts"]
    assert mm["ts"] + mm["dur"] <= span["ts"] + span["dur"]


@pytest.mark.parametrize("tracer_on", [True, False])
def test_span_opens_a_profiler_annotation(tracer_on):
    """Under ``torch.profiler`` every span is an annotation of the
    profiler's timeline, with the tracer on and with it off; with
    neither, the shared no-op context."""
    from torch.profiler import ProfilerActivity, profile
    assert trace.span("a") is trace.span("b")
    with trace.tracing(enabled=tracer_on) as tr:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            assert (trace.span("a") is trace.span("b")) is False
            with trace.span("port.outer", fenced=True) as sp:
                with trace.span("port.inner"):
                    torch.add(torch.ones(4), 1.0)
                sp.fence(torch.ones(1))
    assert trace.span("a") is trace.span("b")
    keys = {e.key for e in prof.key_averages()}
    assert {"port.outer", "port.inner"} <= keys
    assert [s.name for s in tr.spans] == (
        ["port.inner", "port.outer"] if tracer_on else [])


def test_fenced_span_drains_at_entry_and_exit(monkeypatch):
    """A live fenced span synchronises the device at entry and at exit;
    an annotation span never does, and nothing does with the tracer
    off."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    with trace.tracing() as tr:
        with trace.span("fenced", fenced=True) as sp:
            assert len(calls) == 1           # drained at entry
            sp.fence(torch.zeros(2))         # CPU: the current device
        assert len(calls) == 2
        with trace.span("annotation") as sp:
            with pytest.raises(ValueError, match="fenced=True"):
                sp.fence(torch.zeros(2))
        assert len(calls) == 2
    assert [s.name for s in tr.spans] == ["fenced", "annotation"]
    with trace.span("off", fenced=True) as sp:
        sp.fence(torch.zeros(2))
    assert len(calls) == 2


def _tree_of(spans, root):
    """The spans inside each ``root`` span (by time), each root's in
    start order."""
    trees = []
    for top in (s for s in spans if s.name == root):
        end = top.t_start + top.duration_s
        trees.append((top, sorted(
            (s for s in spans if s is not top and s.depth > top.depth
             and top.t_start <= s.t_start
             and s.t_start + s.duration_s <= end),
            key=lambda s: s.t_start)))
    return trees


def test_fl_round_span_tree():
    """One traced ``run_round`` without the predictor: the server and
    client spans nested as the call tree, one ``client.local_update`` a
    selected client, and steps and tokens equal to the batches each
    client trained on."""
    from repro_torch import kernels
    srv = FLServer(dataclasses.replace(get_config("smollm_135m").reduced(),
                                       **TINY_KW),
                   FLConfig(n_clients=8, local_batch=8, lr=0.2,
                            samples_per_client=(16, 40)),
                   NOMAConfig(n_subchannels=2),
                   TaskConfig(vocab_size=32, n_topics=4, seq_len=17),
                   device="cpu")
    srv.run_round()
    trained = []
    local_update = srv.trainer.local_update

    def recorded(model, batches, delta_out):
        batches = list(batches)
        trained.append([b.size for b in batches])
        return local_update(model, batches, delta_out)

    srv.trainer.local_update = recorded
    with trace.tracing() as tr:
        sched = srv.run_round()
    sel = np.flatnonzero(sched.selected).tolist()
    assert len(sel) == len(trained) > 0
    [(top, inside)] = _tree_of(tr.spans, "server.round")
    assert top.parent is None and top.meta["r"] == 1
    assert top.meta["selected"] == sel
    assert top.meta["steps"] == sum(len(t) for t in trained)
    assert top.meta["tokens"] == sum(map(sum, trained))
    assert set(top.meta["launches"]) == set(kernels.WRAPPERS)
    parent = {"server.scenario": "server.round",
              "server.select": "server.round",
              "engine.schedule_batch": "server.select",
              "client.local_update": "server.round",
              "client.step": "client.local_update",
              "client.upload": "client.step",
              "client.forward": "client.step",
              "client.backward": "client.step",
              "client.sgd": "client.step",
              "client.delta": "client.local_update",
              "server.aggregate": "server.round",
              "server.apply": "server.round"}
    assert len(inside) == len(tr.spans) - 1
    for s in inside:
        if s.name in parent:
            assert s.parent == parent[s.name], s.name
        else:
            assert s.name.startswith("plan."), s.name
    order = [s.name for s in inside if s.parent == "server.round"]
    assert order == (["server.scenario", "server.select"]
                     + ["client.local_update"] * len(sel)
                     + ["server.aggregate", "server.apply"])
    updates = [s for s in inside if s.name == "client.local_update"]
    assert [u.meta for u in updates] == [
        {"steps": len(t), "tokens": sum(t)} for t in trained]
    steps = [s for s in inside if s.name == "client.step"]
    assert [s.meta["tokens"] for s in steps] == [x for t in trained
                                                 for x in t]
    for name in ("server.aggregate", "server.apply"):
        [agg] = [s for s in inside if s.name == name]
        assert agg.meta == {"rows": len(sel)}
    for step in steps:
        kids = [s.name for s in inside if s.parent == "client.step"
                and step.t_start <= s.t_start
                <= step.t_start + step.duration_s]
        assert kids == ["client.upload", "client.forward",
                        "client.backward", "client.sgd"]


def test_mc_round_span_tree():
    """A 3-round ``montecarlo_rounds``: each ``mc.round`` holds
    ``plan.priority``, ``plan.admit``, ``plan.finalize`` (holding
    ``plan.compact``) and ``plan.diag``, in that order and without
    overlap, with the keys the sorts take."""
    rng = np.random.default_rng(1)
    eng = WirelessEngine(NOMAConfig(n_subchannels=2), FLConfig(),
                         device="cpu")
    b, n = 4, 12
    c = min(eng.prm.slots, n)
    with trace.tracing() as tr:
        eng.montecarlo_rounds(rng.exponential(size=(3, b, n)) * 1e-9,
                              np.full((b, n), 50.0), np.full((b, n), 1e9),
                              1e6, policy="age_noma")
    trees = _tree_of(tr.spans, "mc.round")
    assert [top.meta for top, _ in trees] == [
        {"i": i, "s": b, "n": n} for i in range(3)]
    for top, inside in trees:
        assert top.parent == "engine.mc_loop"
        stages = [s for s in inside if s.parent == "mc.round"]
        assert [s.name for s in stages] == ["plan.priority", "plan.admit",
                                            "plan.finalize", "plan.diag"]
        for a, z in zip(stages, stages[1:]):
            assert a.t_start + a.duration_s <= z.t_start
        [compact] = [s for s in inside if s.name == "plan.compact"]
        assert compact.parent == "plan.finalize"
        fin = stages[2]
        assert fin.t_start <= compact.t_start
        assert (compact.t_start + compact.duration_s
                <= fin.t_start + fin.duration_s)
        assert compact.meta == {"keys": b * (n + c)}
        assert stages[1].meta["keys"] == 2 * b * n


def test_fl_round_spans_with_the_predictor():
    """One traced FL run with the ANN predictor: the server, predictor,
    engine and planner spans, nested as the call tree."""
    srv = FLServer(dataclasses.replace(get_config("smollm_135m").reduced(),
                                       **TINY_KW),
                   FLConfig(n_clients=8, local_batch=8, lr=0.2,
                            samples_per_client=(24, 48)),
                   NOMAConfig(n_subchannels=2),
                   TaskConfig(vocab_size=32, n_topics=4, seq_len=17),
                   device="cpu", predictor="ann", eval_every=10)
    with trace.tracing() as tr:
        hist = srv.run(3)
    by = {}
    for s in tr.spans:
        by.setdefault(s.name, []).append(s)
    assert len(by["server.round"]) == 3
    assert len(by["engine.schedule_batch"]) == 3
    assert [s.cold for s in by["engine.schedule_batch"]] == [True, False,
                                                             False]
    for name in ("predictor.observe", "predictor.predict", "server.blend"):
        assert len(by[name]) == 3, name
        assert {s.parent for s in by[name]} == {"server.round"}
    assert [s.meta["m"] for s in by["predictor.predict"]] == \
        hist.n_predicted
    assert {s.parent for s in by["plan.admit"]} == {"engine.schedule_batch"}
    assert "plan.finalize" in by
    assert hist.n_predicted[1:] == [4, 4]


def test_engine_budget_cells_and_montecarlo_spans():
    rng = np.random.default_rng(0)
    fl = FLConfig(pairing="hungarian", selection="joint")
    eng = WirelessEngine(NOMAConfig(n_subchannels=2), fl, device="cpu")
    b, n = 4, 12
    g = rng.exponential(size=(b, n)) * 1e-9
    ns, cpu = np.full((b, n), 50.0), np.full((b, n), 1e9)
    with trace.tracing() as tr:
        fast = eng.schedule_batch(g, ns, cpu, np.ones((b, n)), 1e6)
        eng.schedule_batch(g, ns, cpu, np.ones((b, n)), 1e6,
                           t_budget=np.asarray(fast.t_round) * 0.5)
        eng.schedule_batch(g, ns, cpu, np.ones((b, n)), 1e6,
                           cell=rng.integers(0, 2, (b, n)), n_cells=2)
        eng.montecarlo_rounds(rng.exponential(size=(3, b, n)) * 1e-9, ns,
                              cpu, 1e6, policy="age_noma")
    names = {s.name for s in tr.spans}
    assert {"engine.schedule_batch", "engine.mc_loop", "plan.admit",
            "plan.joint", "plan.finalize", "plan.evict",
            "plan.multicell"} <= names
    mc = next(s for s in tr.spans if s.name == "engine.mc_loop")
    assert mc.meta == {"rounds": 3, "policy": "age_noma", "s": b, "n": n}
    assert mc.cold is True


@pytest.mark.parametrize("flops,bytes_", [(2.0e9, 1.0e9), (1e15, 1e9),
                                          (0.0, 4096.0), (5.0, 0.0)])
def test_kernel_roof_point_equals_reference(flops, bytes_):
    peaks = dict(peak_flops=roofline.PEAK_FP32_S,
                 hbm_bw=roofline.PEAK_BYTES_S)
    got = roofline.kernel_roof_point(flops, bytes_, **peaks)
    want = jroofline.kernel_roof_point(flops, bytes_, **peaks)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(roofline.kernel_roof_point(flops, bytes_)) \
        == dataclasses.asdict(got)


def test_chip_smoke_bounds_come_from_the_roofline():
    """chip_smoke's bound: bytes over 3.35 TB/s or operations over the
    given peak (67 TFLOP/s fp32 by default), whichever is larger."""
    assert (roofline.PEAK_BYTES_S, roofline.PEAK_FP32_S,
            roofline.PEAK_BF16_S, roofline.PEAK_TF32_S) == \
        (3.35e12, 67e12, 989e12, 495e12)
    c, n = 50, 134_515_008
    ms, by = chip_smoke.bound(c * n * 4 + c * 4 + n * 4, 2 * c * n)
    assert by == "bytes"
    assert ms == max((c * n * 4 + c * 4 + n * 4) / 3.35e12,
                     2 * c * n / 67e12) * 1e3
    ms, by = chip_smoke.bound(1e6, 1e12, roofline.PEAK_BF16_S)
    assert by == "operations" and ms == 1e12 / 989e12 * 1e3
