"""Batched PyTorch wireless engine: the paper's joint round (AoU selection,
strong/weak SIC pairing, closed-form power allocation, round time) over a
batch of environments, on one device.

Counterpart of the no-budget, single-cell fast path of
``src/repro/core/engine.py``: ``EngineParams``/``EngineSchedule``,
``schedule_diag``, ``_age_priority``, ``round_robin_priority``,
``_compute_times``, the admission contract of ``_admit_fast`` /
``_admit_fast_seg``, ``_fast_finish`` with the strong_weak branch and the
odd-candidate solo row, ``WirelessEngine`` and
``engine_schedule_to_numpy``.

Stages (DESIGN.md section 8), all fixed-shape tensor ops, no host sync:

  * admit     top-``c`` clients by (priority desc, gain desc, index asc):
              a stable descending sort by gain, then a stable descending
              sort by priority — the lexicographic order of
              ``plan.admission_order`` (``torch.topk`` leaves the order of
              equal keys undefined, so it is not used). Ages and sample
              counts are integers in FL, so equal priorities are common;
              the priority is computed exactly as the reference does
              (fp32 ``n / sum(n)`` times the age), so masks match it bit
              for bit;
  * rank      one stable descending sort of the admitted gains: ties go by
              client index, the plan.py contract;
  * allocate  rank p pairs with rank c_pair-1-p; the pair power/rate math
              runs in the pairscore kernel (kernels/pairscore.py); an odd
              count parks the weakest candidate alone at full power;
  * time      T_round = max over the admitted of T_cmp + S / R.

The pairing policies other than strong_weak, ``selection="joint"``, a
round-time budget and ``n_cells > 1`` are later slices of the port
(ROADMAP queues 2 and 3) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import (ADMISSIONS, PAIRINGS, SELECTIONS,
                                      FLConfig, NOMAConfig)
from repro_torch.core.plan import AOU_BUCKET_EDGES, RoundEnv, Schedule
from repro_torch.kernels import pairscore
from repro_torch.kernels.backend import resolve_backend

_LATER = {
    "pairing": "the adjacent/hungarian/greedy_matching pairing policies "
               "are ROADMAP queue 2 (planner kernel)",
    "selection": "selection='joint' is ROADMAP queue 2",
    "budget": "a round-time budget (t_budget > 0) is ROADMAP queue 3 "
              "(budget eviction loop)",
    "cells": "n_cells > 1 is ROADMAP queue 3 (multi-cell)",
}


# ---------------------------------------------------------------------------
# static parameters and the batched schedule
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EngineParams:
    """Scalars of the round model."""
    slots: int               # K * J candidate slots
    bandwidth_hz: float
    noise_power_w: float     # N0 * B
    max_power_w: float
    cycles_per_sample: float
    local_epochs: int
    ref_path_loss: float
    path_loss_exp: float
    min_radius_m: float
    cell_radius_m: float

    @classmethod
    def from_configs(cls, ncfg: NOMAConfig, flcfg: FLConfig
                     ) -> "EngineParams":
        return cls(
            slots=ncfg.n_subchannels * ncfg.users_per_subchannel,
            bandwidth_hz=ncfg.bandwidth_hz,
            noise_power_w=ncfg.noise_density * ncfg.bandwidth_hz,
            max_power_w=ncfg.max_power_w,
            cycles_per_sample=flcfg.cpu_cycles_per_sample,
            local_epochs=flcfg.local_epochs,
            ref_path_loss=ncfg.ref_path_loss,
            path_loss_exp=ncfg.path_loss_exp,
            min_radius_m=ncfg.min_radius_m,
            cell_radius_m=ncfg.cell_radius_m,
        )


class EngineSchedule(NamedTuple):
    """Fixed-shape schedule: tensors carry a leading batch dim B.

    ``pair_strong/pair_weak`` are (B, P) int64; row p is a SIC pair when
    ``pair_weak[p] >= 0``, a solo subchannel when ``pair_strong[p] >= 0 >
    pair_weak[p]``, padding when ``pair_strong[p] < 0``.
    """
    selected: torch.Tensor      # (B, N) bool
    pair_strong: torch.Tensor   # (B, P) int64
    pair_weak: torch.Tensor     # (B, P) int64
    rates: torch.Tensor         # (B, N) fp32 bits/s (0 unselected)
    powers: torch.Tensor        # (B, N) fp32 W
    t_cmp: torch.Tensor         # (B, N) fp32 s
    t_com: torch.Tensor         # (B, N) fp32 s
    t_round: torch.Tensor       # (B,)   fp32 s
    agg_weights: torch.Tensor   # (B, N) fp32
    evicted: torch.Tensor       # (B, N) bool (budget-loop evictions)


# ---------------------------------------------------------------------------
# diagnostics (numpy reference: ``plan.schedule_diag``)
# ---------------------------------------------------------------------------


def schedule_diag(out: EngineSchedule, ages=None) -> dict:
    """Per-round diagnostics with a leading batch dim on every leaf:
    t_round/t_comp_bottleneck/t_up_bottleneck (B,) fp32,
    n_selected/n_evicted (B,) int64, plus aou_hist (B, 7) int64 when
    ``ages`` is given (DESIGN.md section 11)."""
    sel = out.selected
    tot = torch.where(sel, out.t_cmp + out.t_com, 0.0)
    bi = torch.argmax(tot, dim=-1, keepdim=True)
    any_sel = sel.any(dim=-1)
    take = lambda a: torch.where(any_sel, a.gather(-1, bi)[..., 0], 0.0)
    diag = {
        "t_round": out.t_round,
        "t_comp_bottleneck": take(out.t_cmp),
        "t_up_bottleneck": take(out.t_com),
        "n_selected": sel.sum(dim=-1),
        "n_evicted": out.evicted.sum(dim=-1),
    }
    if ages is not None:
        ages = torch.as_tensor(ages, dtype=torch.float32,
                               device=sel.device)
        edges = torch.tensor(AOU_BUCKET_EDGES, dtype=torch.float32,
                             device=sel.device)
        idx = (ages[..., None] > edges).sum(dim=-1)
        k = len(AOU_BUCKET_EDGES) + 1
        diag["aou_hist"] = (idx[..., None] == torch.arange(
            k, device=sel.device)).sum(dim=-2)
    return diag


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


def _age_priority(ages, n_samples, gamma: float):
    """The paper's selection key A^gamma * w, with the reference's fp32
    operation order (ties resolve lexicographically in ``_admit``)."""
    w = n_samples / n_samples.sum(dim=-1, keepdim=True)
    a = ages.to(torch.float32)
    if gamma != 1.0:
        a = a ** gamma
    return a * w


def round_robin_priority(round_idx: int, n: int, n_window: int, device):
    """(n,) priority whose top-``n_window`` set is the rotating window
    ``[(t*slots + i) % n]``."""
    start = (round_idx * n_window) % n
    return -(((torch.arange(n, device=device) - start) % n)
             .to(torch.float32))


def _compute_times(prm: EngineParams, n_samples, cpu_freq):
    """T_cmp = E * C * D_n / f_n, in the reference's fp32 order."""
    return (prm.local_epochs * prm.cycles_per_sample * n_samples
            / cpu_freq).to(torch.float32)


def _admit(priority, gains, c: int):
    """Top-``c`` admission mask by (priority desc, gain desc, index asc):
    two stable descending sorts, the second over the first's order."""
    b, n = gains.shape
    if c >= n:
        return torch.ones((b, n), dtype=torch.bool, device=gains.device)
    g_order = torch.sort(gains, dim=1, descending=True, stable=True).indices
    p_order = torch.sort(priority.gather(1, g_order), dim=1,
                         descending=True, stable=True).indices
    top = g_order.gather(1, p_order[:, :c])
    return torch.zeros((b, n), dtype=torch.bool,
                       device=gains.device).scatter_(1, top, True)


def _fast_finish(cand, gains, t_cmp, n_samples, model_bits,
                 prm: EngineParams, oma: bool, c: int) -> EngineSchedule:
    """Stages 3-5 for an admission mask with exactly ``c`` members per
    row: rank, strong_weak pairing, power/rates (the pairscore kernel on a
    CUDA device), round time, client-space outputs."""
    b, n = gains.shape
    n0b, pmax, bw = prm.noise_power_w, prm.max_power_w, prm.bandwidth_hz
    odd = c % 2
    c_pair = c - odd
    m = c_pair // 2

    # admitted client ids in index order (stable sort of the mask), then
    # by rank: one stable descending sort of their gains (ties by index)
    comp = torch.sort(cand.to(torch.uint8), dim=1, descending=True,
                      stable=True).indices[:, :c]
    g_c = gains.gather(1, comp)
    sg_c, sidx_c = torch.sort(g_c, dim=1, descending=True, stable=True)
    sid_c = comp.gather(1, sidx_c)                     # client id by rank

    # rates/powers by rank: rank p (strong) pairs rank c_pair-1-p (weak)
    parts_r, parts_p = [], []
    if m:
        g_str = sg_c[:, :m]
        g_wk = sg_c[:, m:c_pair].flip(1)
        p_i, p_j, r_i, r_j = pairscore.pairscore(
            g_str, g_wk, n0b=n0b, pmax=pmax, bw=bw, oma=oma)
        parts_r += [r_i, r_j.flip(1)]
        parts_p += [p_i, p_j.flip(1)]
    if odd:
        parts_r.append(pairscore.solo_rate_math(sg_c[:, c - 1:c], n0b=n0b,
                                                pmax=pmax, bw=bw))
        parts_p.append(torch.full((b, 1), pmax, dtype=torch.float32,
                                  device=gains.device))
    rate_srt = torch.cat(parts_r, dim=1)
    pow_srt = torch.cat(parts_p, dim=1)

    # round time over the admitted (max is order-free), then client space
    mb = model_bits[:, None]
    tot = t_cmp.gather(1, sid_c) + mb / torch.clamp(rate_srt, min=1e-9)
    t_round = tot.max(dim=1).values
    zeros = torch.zeros((b, n), dtype=torch.float32, device=gains.device)
    rates = zeros.scatter(1, sid_c, rate_srt)
    powers = zeros.scatter(1, sid_c, pow_srt)
    t_com = mb / torch.clamp(rates, min=1e-9)
    w = n_samples * cand
    w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-12)

    # pair table: strong ranks, their weak partners, the solo row
    # ((c + 1) // 2 rows: no padding, since c >= 1)
    strong_tab = [sid_c[:, :m]]
    weak_tab = [sid_c[:, m:c_pair].flip(1)]
    fill = lambda k: torch.full((b, k), -1, dtype=torch.int64,
                                device=gains.device)
    if odd:
        strong_tab.append(sid_c[:, c - 1:c])
        weak_tab.append(fill(1))

    return EngineSchedule(
        selected=cand, pair_strong=torch.cat(strong_tab, dim=1),
        pair_weak=torch.cat(weak_tab, dim=1), rates=rates, powers=powers,
        t_cmp=t_cmp, t_com=t_com, t_round=t_round, agg_weights=w,
        evicted=torch.zeros((b, n), dtype=torch.bool, device=gains.device))


# ---------------------------------------------------------------------------
# engine facade
# ---------------------------------------------------------------------------


class WirelessEngine:
    """Batched scheduler with the reference engine's semantics, on
    ``device`` (default ``"cuda"``; the CPU only when asked for).

    ``kernel_backend`` (default ``FLConfig.kernel_backend``) is checked
    against the device (kernels/backend.py): the CUDA kernels run on a
    CUDA device and the plain PyTorch versions on the CPU. Building an
    engine on a CUDA device runs the probe kernel once per process; a
    failed probe raises.
    """

    def __init__(self, ncfg: NOMAConfig, flcfg: FLConfig, *,
                 device="cuda", kernel_backend: Optional[str] = None,
                 pairing: Optional[str] = None,
                 selection: Optional[str] = None,
                 admission: Optional[str] = None):
        self.ncfg = ncfg
        self.flcfg = flcfg
        self.prm = EngineParams.from_configs(ncfg, flcfg)
        self.pairing = _check_pairing(
            flcfg.pairing if pairing is None else pairing)
        self.selection = _check_selection(
            flcfg.selection if selection is None else selection)
        self.admission = _check_admission(
            flcfg.admission if admission is None else admission)
        if flcfg.n_cells > 1:
            raise NotImplementedError(_LATER["cells"])
        self.device = resolve_backend(
            flcfg.kernel_backend if kernel_backend is None
            else kernel_backend, device)

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x, device=self.device).to(torch.float32)

    def schedule_batch(self, gains, n_samples, cpu_freq, ages, model_bits,
                       *, t_budget=0.0, oma: bool = False, priority=None,
                       pairing: Optional[str] = None,
                       selection: Optional[str] = None,
                       admission: Optional[str] = None) -> EngineSchedule:
        """Joint round over a batch of environments.

        gains/n_samples/cpu_freq/ages: (B, N) arrays or tensors;
        model_bits: scalar or (B,). ``priority=None`` uses the paper's age
        priority. ``admission`` (auto | full_sort | segmented) names the
        reference's implementation choice; all three give one mask here.
        """
        if _check_pairing(pairing or self.pairing) != "strong_weak":
            raise NotImplementedError(_LATER["pairing"])
        if _check_selection(selection or self.selection) != "greedy_set":
            raise NotImplementedError(_LATER["selection"])
        _check_admission(admission or self.admission)
        if torch.is_tensor(t_budget) or float(t_budget) > 0.0:
            raise NotImplementedError(_LATER["budget"])
        gains = self._tensor(gains)
        n_samples = self._tensor(n_samples)
        b, n = gains.shape
        model_bits = self._tensor(model_bits).expand(b).contiguous()
        c = min(self.prm.slots, n)
        if priority is None:
            priority = _age_priority(self._tensor(ages), n_samples,
                                     self.flcfg.age_exponent)
        else:
            priority = self._tensor(priority)
        t_cmp = _compute_times(self.prm, n_samples, self._tensor(cpu_freq))
        cand = _admit(priority, gains, c)
        return _fast_finish(cand, gains, t_cmp, n_samples, model_bits,
                            self.prm, oma, c)

    def schedule(self, env: RoundEnv, *, t_budget: Optional[float] = None,
                 oma: bool = False, priority=None,
                 policy: str = "age_noma",
                 pairing: Optional[str] = None,
                 selection: Optional[str] = None) -> Schedule:
        """Single-env wrapper returning the numpy ``Schedule`` (used by
        ``FLServer``)."""
        if t_budget is None:
            t_budget = self.flcfg.t_budget_s
        batchify = lambda a: a[None] if torch.is_tensor(a) \
            else np.asarray(a)[None]
        out = self.schedule_batch(
            batchify(env.gains), batchify(env.n_samples),
            batchify(env.cpu_freq), batchify(env.ages), env.model_bits,
            t_budget=t_budget, oma=oma, pairing=pairing,
            selection=selection,
            priority=None if priority is None else batchify(priority))
        return engine_schedule_to_numpy(out, 0, info={
            "policy": policy, "engine": "torch",
            "evicted": np.flatnonzero(
                out.evicted[0].cpu().numpy()).tolist()})


def _check_pairing(pairing: str) -> str:
    if pairing not in PAIRINGS:
        raise ValueError(f"unknown pairing policy {pairing!r} "
                         f"(expected one of {PAIRINGS})")
    return pairing


def _check_selection(selection: str) -> str:
    if selection not in SELECTIONS:
        raise ValueError(f"unknown selection mode {selection!r} "
                         f"(expected one of {SELECTIONS})")
    return selection


def _check_admission(admission: str) -> str:
    if admission not in ADMISSIONS:
        raise ValueError(f"unknown admission mode {admission!r} "
                         f"(expected one of {ADMISSIONS})")
    return admission


def engine_schedule_to_numpy(out: EngineSchedule, b: int,
                             info: Optional[dict] = None) -> Schedule:
    """Batch element ``b`` as the host-side ``Schedule`` (pairs as
    [(strong, weak)] with weak=-1 solo, pad rows removed); fp32 values
    widen to the fp64 contract of the numpy reference."""
    row = lambda t: t[b].cpu().numpy()
    strong, weak = row(out.pair_strong), row(out.pair_weak)
    pairs = [(int(i), int(j)) for i, j in zip(strong, weak) if i >= 0]
    return Schedule(
        selected=row(out.selected),
        pairs=pairs,
        rates=row(out.rates).astype(np.float64),
        powers=row(out.powers).astype(np.float64),
        t_cmp=row(out.t_cmp).astype(np.float64),
        t_com=row(out.t_com).astype(np.float64),
        t_round=float(out.t_round[b]),
        agg_weights=row(out.agg_weights).astype(np.float64),
        info=info or {"engine": "torch"},
    )
