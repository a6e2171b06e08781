"""The readers of the Monte-Carlo round's port spans (``plan.diag`` and
``plan.compact``) on a made-up context, and a traced run of the tiny
Monte-Carlo cell on the CPU that reports them."""
from __future__ import annotations

import time

import pytest

from portbench import harness
from portbench.tests import tiny

SEED = 2 ** 31 + 23


@pytest.mark.parametrize("metric,span", [("plan.diag_ms.mc", "plan.diag"),
                                         ("plan.compact_ms.mc",
                                          "plan.compact")])
def test_reader_means_its_span(metric, span):
    read = harness.metric_reader(metric)
    ctx = {"port_spans": [(span, 0.002), ("plan.admit", 0.5), (span, 0.004),
                          ("mc.round", 1.0)]}
    assert read(ctx) == pytest.approx(3.0)
    assert read({"port_spans": [("plan.admit", 0.5)]}) is None
    assert read({"port_spans": []}) is None


def test_traced_tiny_cell_reports_the_round_stages():
    cfg, wl = tiny.mc_cell()
    out = harness.run_cell("mc_noma_10k.static", SEED, 0.5, True,
                           t_start=time.perf_counter(), device="cpu", wl=wl,
                           cfg=cfg, spec=harness.benchmark_spec(),
                           log=lambda m: None)
    assert out["correct"], out["checks"]
    for name in ("plan.admit_ms.mc", "plan.finalize_ms.mc",
                 "plan.diag_ms.mc", "plan.compact_ms.mc"):
        assert out["metrics"][name]["value"] > 0, name
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["plan.compact_ms.mc"] < m["plan.finalize_ms.mc"]
