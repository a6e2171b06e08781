"""The comparison that decides ``correct``, shown to fail: a whole run of
each tiny cell on the CPU (the harness's look for a card skipped) comes
out correct as it stands, and not correct with each fault of
``portbench/faults.py`` planted under the timed path, or with the control
(the reference in the precision below the configuration's) in the
program's place. The control at the cells' own sizes runs on the card
(``test_control_at_cell_size``)."""
from __future__ import annotations

import time

import pytest
import torch

from portbench import faults, harness
from portbench.tests import tiny

SEED = 2 ** 31 + 11


def _run(cell: str):
    cfg, wl = tiny.CELLS[cell]()
    return harness.run_cell(cell, SEED, 0.5, False, t_start=time.perf_counter(),
                            device="cpu", wl=wl, cfg=cfg,
                            spec=harness.benchmark_spec(), log=lambda m: None)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_planted_fault_is_not_correct(cell, fault):
    with faults.plant(harness.workload(cell)["driver"], fault):
        out = _run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_control_is_not_correct(cell):
    cfg, wl = tiny.CELLS[cell]()
    run = harness.driver(wl["driver"]).Cell(cfg, wl, SEED,
                                            torch.device("cpu"))
    run.warm_up()
    run.release()
    vals = run.compare(run.control(), run.follow())
    assert any(vals[k] > lim for k, lim in wl["limits"].items()), vals


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_control_at_cell_size(cell):
    """The control at the cell's own size on the card, three seeds: it
    fails at least one compared number each time, while the program
    passes them all."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    wl = harness.workload(cell)
    cfg = harness.config(wl["config"])
    mod = harness.driver(wl["driver"])
    for seed in (SEED, SEED + 1, SEED + 2):
        run = mod.Cell(cfg, wl, seed, torch.device("cuda"))
        run.warm_up()
        run.release()
        ref = run.follow()
        prog = run.compare(run.outputs(), ref)
        ctl = run.compare(run.control(), ref)
        assert all(prog[k] <= lim for k, lim in wl["limits"].items()), prog
        assert any(ctl[k] > lim for k, lim in wl["limits"].items()), ctl
        del run, ref
        torch.cuda.empty_cache()
