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
    x = torch.arange(6.0)
    trace.fence(x, [x, {"k": (x,)}], "not a tensor")   # CPU: nothing to do
    out, split = trace.compile_split(torch.add, x, 1.0)
    assert torch.equal(out, x + 1.0)
    assert set(split) == {"first_s", "steady_s"}
    assert all(v >= 0 for v in split.values())
    with trace.profile(str(tmp_path / "prof")) as prof:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert any("mm" in e.key for e in prof.key_averages())
    assert json.loads((tmp_path / "prof" / "trace.json").read_text())


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
