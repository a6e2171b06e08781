"""Faults planted under the timed path, to show that the comparison which
decides ``correct`` catches them: each is a context manager that patches
the program for the block and restores it after.

FL round (``fl_round`` driver):
  frozen_step     the local SGD step leaves the weights unchanged;
  half_batch      each local step trains on half of its batch, the loss
                  the mean over the rest;
  altered_answer  the schedule's selection has one client swapped for an
                  unselected one where the engine produces it.
Monte-Carlo rollout (``mc_rounds`` driver):
  frozen_step     a round returns the ages and participation unchanged;
  half_batch      a round computes the first half of the drops and copies
                  them over the second;
  altered_answer  every drop's first client's age is one too high where a
                  round produces it.
"""
from __future__ import annotations

import contextlib
import dataclasses

FAULTS = ("frozen_step", "half_batch", "altered_answer")


@contextlib.contextmanager
def _patched(obj, attr: str, make):
    orig = getattr(obj, attr)
    setattr(obj, attr, make(orig))
    try:
        yield
    finally:
        setattr(obj, attr, orig)


def plant(driver: str, fault: str):
    """The context manager of ``fault`` for cells of ``driver``."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    return {"fl_round": _fl, "mc_rounds": _mc}[driver](fault)


def _fl(fault: str):
    from repro_torch.core.engine import WirelessEngine
    from repro_torch.fl.client import LocalTrainer
    from repro_torch.optim.sgd import SGD
    if fault == "frozen_step":
        return _patched(SGD, "step",
                        lambda orig: lambda self, params, grads, state: None)
    if fault == "half_batch":
        return _patched(LocalTrainer, "step", lambda orig: (
            lambda self, params, state, tokens: orig(
                self, params, state, tokens[:tokens.shape[0] // 2])))

    def swap(orig):
        def schedule(self, env, **kw):
            import numpy as np
            s = orig(self, env, **kw)
            sel = s.selected.copy()
            if sel.any() and not sel.all():
                sel[np.flatnonzero(sel)[0]] = False
                sel[np.flatnonzero(~sel)[0]] = True
            return dataclasses.replace(s, selected=sel)
        return schedule
    return _patched(WirelessEngine, "schedule", swap)


def _mc(fault: str):
    import torch
    from repro_torch.core import engine

    def make(orig):
        def step(ages, part, gains, *args, **kwargs):
            if fault == "half_batch":
                h = gains.shape[0] // 2
                halves = [a[:h] if torch.is_tensor(a) and a.dim() == 2
                          and a.shape[0] == gains.shape[0] else a
                          for a in args]
                a, p, d = orig(ages[:h], part[:h], gains[:h], *halves,
                               **kwargs)
                dup = lambda t: torch.cat([t, t[:gains.shape[0] - h]])
                return dup(a), dup(p), {k: dup(v) for k, v in d.items()}
            a, p, d = orig(ages, part, gains, *args, **kwargs)
            if fault == "frozen_step":
                return ages, part, d
            a = a.clone()
            a[:, 0] += 1.0
            return a, p, d
        return step
    return _patched(engine, "_montecarlo_step", make)
