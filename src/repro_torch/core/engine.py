"""Batched PyTorch wireless engine: the paper's joint round (AoU selection,
SIC pairing under a policy, closed-form power allocation, round time) over
a batch of environments, on one device, and the pre-sampled Monte-Carlo
rollout built on it.

Counterpart of ``src/repro/core/engine.py``: ``EngineParams`` /
``EngineSchedule``, ``schedule_diag``, ``_age_priority``,
``round_robin_priority``, ``_compute_times``, the admission contract of
``_admit_fast`` / ``_admit_fast_seg``, ``_fast_finish`` under every
pairing policy (strong_weak, adjacent, hungarian, greedy_matching) with
the odd-candidate solo row, ``_completion_table``, ``_sw_completion``, the
joint selection stage (``_joint_enum_mask``, ``_joint_swap_mask``,
``_joint_refine_mask``, ``_pick_faster``), the round-time budget core
(``_assemble``, ``_LoopState``, ``_schedule_one`` as
``_budget_schedule``), the cell-partitioned planner
(``_cell_member_table``, ``_multicell_schedule``, ``_merge_cells``),
``WirelessEngine`` with ``montecarlo_rounds`` / ``montecarlo_scenario`` /
``_mc_loop`` / ``_montecarlo_step``, and ``engine_schedule_to_numpy``.

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
  * match     the pairing policy (DESIGN.md section 7): strong_weak pairs
              rank p with rank c_pair-1-p, adjacent pairs neighbours;
              greedy_matching runs ``matching.greedy_assignment`` on the
              effective-power table; hungarian takes the planner kernel's
              bf16 completion table and fp32 strong_weak bottleneck
              (kernels/planner.py), enumerates every matching for
              m <= ``ENUM_MAX_PAIRS``, else runs the Hungarian assignment
              and a three-start bottleneck 2-opt (core/matching.py), and
              keeps strong_weak unless strictly faster;
  * allocate  the pair power/rate math runs in the pairscore kernel
              (kernels/pairscore.py); an odd count parks the weakest
              candidate alone at full power;
  * time      T_round = max over the admitted of T_cmp + S / R.

``selection="joint"`` refines the admitted set (exhaustive enumeration for
N <= ``JOINT_ENUM_MAX_N``, else a swap search scored by strong_weak
completions through the pairscore kernel) and keeps the refined schedule
only where strictly faster.

A positive round-time budget runs the eviction loop (``plan.plan_round``'s
budget loop) as batched tensor code: every row carries its own candidate
count, so ``_assemble`` derives each rank index from a (B,) count, scores
all B x P pair rows in one pairscore launch and scatters into a (B, n + 1)
buffer whose last column takes the rows that do not exist (the reference's
index-n drop target, DESIGN.md section 5.1). The hungarian policy there
reads the fp32 ``completion_table`` (scored by the pairscore kernel), not
the planner's bf16 tiles, as the reference's budget core does. The loop
runs while any row is not done, one device-to-host read per iteration;
rows that are done are frozen with ``torch.where``. Because the loop
scores through the pairscore kernel itself, the reference's post-hoc
``_rescore_pallas`` (which recomputes XLA-scored rates with the Pallas
kernel) has no counterpart: it would recompute the same values.

``n_cells > 1`` with a ``cell`` map partitions the clients by cell into a
(B * C, cap) sub-batch (padding lanes: priority -inf, gain 0), runs the
fast path or the budget loop on it, and merges back to client space
(round time = max over cells, weights pooled over all selected clients).
``montecarlo_scenario`` steps a scenario (sim/scenario.py) on the engine's
device between rounds, so no (R, S, N) array exists. ``shard=True`` on
either Monte-Carlo entry point splits the S seeds into contiguous blocks,
one a visible CUDA device, when there is more than one and S divides by
their count (the reference's rule), and otherwise runs as ``shard=False``.
Each block runs in its own worker thread (the budget loop reads the host
once an iteration), draws the whole batch's random numbers and keeps its
rows, so the split equals the unsplit run bitwise for every policy.

Tracing spans (obs/trace.py, off by default) mark the reference's sites:
``engine.schedule_batch``, ``engine.mc_loop``, and the stages the
reference's numpy planner marks (``plan.admit``, ``plan.joint``,
``plan.finalize``, ``plan.evict``, ``plan.multicell``) at their
counterparts here. A Monte-Carlo rollout adds ``mc.round`` (``i``, ``s``,
``n``) around each round, holding ``plan.priority`` (compute times and
the policy's priority), the schedule's stages and ``plan.diag`` (the age
update and the round's diagnostics); ``plan.compact`` (the admitted set's
mask sort and rank sort, inside ``plan.finalize``) and ``plan.admit``
count the keys their sorts take (``keys``). A live span drains the device at entry and
fences its stage's outputs at exit; a split Monte-Carlo run traces from
several threads, which one tracer does not keep apart.
"""
from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import (ADMISSIONS, PAIRINGS, SELECTIONS,
                                      FLConfig, NOMAConfig)
from repro_torch.core import matching
from repro_torch.core.pairing import ENUM_MAX_PAIRS, enumerate_matchings
from repro_torch.core.plan import (AOU_BUCKET_EDGES, JOINT_ENUM_MAX_N,
                                   JOINT_SWAP_ITERS, RoundEnv, Schedule,
                                   cell_capacity, enumerate_subsets)
from repro_torch.kernels import pairscore, planner
from repro_torch.kernels.backend import resolve_backend
from repro_torch.obs import trace

# the no-budget policies montecarlo_rounds resolves to a priority vector;
# it also takes "age_noma_budget" (the age priority under the caller's
# t_budget)
MC_POLICIES = ("age_noma", "oma_age", "channel", "round_robin", "random")


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


def schedule_diag(out: EngineSchedule, ages=None, *, cell=None,
                  n_cells: int = 1) -> dict:
    """Per-round diagnostics with a leading batch dim on every leaf:
    t_round/t_comp_bottleneck/t_up_bottleneck (B,) fp32,
    n_selected/n_evicted (B,) int64, plus aou_hist (B, 7) int64 when
    ``ages`` is given and sel_per_cell (B, n_cells) int64 when a cell map
    is given with ``n_cells > 1`` (DESIGN.md section 11)."""
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
    if cell is not None and n_cells > 1:
        one_hot = torch.as_tensor(cell, device=sel.device)[..., None] \
            == torch.arange(n_cells, device=sel.device)
        diag["sel_per_cell"] = (sel[..., None] & one_hot).sum(dim=-2)
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


def _admission_order(priority, gains):
    """(B, n) client ids by (priority desc, gain desc, index asc): two
    stable descending sorts, the second over the first's order (the
    reference's ``jnp.lexsort``)."""
    g_order = torch.sort(gains, dim=1, descending=True, stable=True).indices
    p_order = torch.sort(priority.gather(1, g_order), dim=1,
                         descending=True, stable=True).indices
    return g_order.gather(1, p_order)


def _admit(priority, gains, c: int):
    """Top-``c`` admission mask of ``_admission_order``."""
    b, n = gains.shape
    if c >= n:
        return torch.ones((b, n), dtype=torch.bool, device=gains.device)
    top = _admission_order(priority, gains)[:, :c]
    return torch.zeros((b, n), dtype=torch.bool,
                       device=gains.device).scatter_(1, top, True)


def _sort_admitted(cand, gains, c: int):
    """Admitted client ids in index order (stable sort of the mask), then
    by rank: one stable descending sort of their gains (ties by index).
    Returns (gains by rank (B, c), client id by rank (B, c))."""
    comp = torch.sort(cand.to(torch.uint8), dim=1, descending=True,
                      stable=True).indices[:, :c]
    g_c = gains.gather(1, comp)
    sg_c, sidx_c = torch.sort(g_c, dim=1, descending=True, stable=True)
    return sg_c, comp.gather(1, sidx_c)


def _matching_positions(sg_c, sid_c, t_cmp, model_bits, prm: EngineParams,
                        oma: bool, pairing: str, c_pair: int):
    """Rank positions (strong (B, m), weak (B, m)) of the hungarian or
    greedy_matching pairs over the gain-sorted half-split."""
    b = sg_c.shape[0]
    m = c_pair // 2
    dev = sg_c.device
    ar_m = torch.arange(m, device=dev).expand(b, m)
    if pairing == "greedy_matching":
        # effective-power surrogate: precision-exact structural ties
        score = pairscore.effective_power_table(
            sg_c[:, :m], sg_c[:, m:c_pair], n0b=prm.noise_power_w,
            pmax=prm.max_power_w)
        return ar_m, m + matching.greedy_assignment(score)
    # hungarian: the planner kernel's bf16 completion table (upcast fp32)
    # over the sorted ranks, and its fp32 strong_weak bottleneck t_sw
    table_t, _, t_sw = planner.planner_tables(
        sg_c[:, :c_pair], t_cmp.gather(1, sid_c)[:, :c_pair], model_bits,
        n0b=prm.noise_power_w, pmax=prm.max_power_w, bw=prm.bandwidth_hz,
        oma=oma)
    table = table_t.float()
    rev = torch.arange(c_pair - 1, m - 1, -1, device=dev).expand(b, m)
    if m <= ENUM_MAX_PAIRS:
        # exact bottleneck by enumeration (L = 1/3/15/105)
        mt = torch.as_tensor(enumerate_matchings(m), device=dev)
        vals = table[:, mt[:, :, 0], mt[:, :, 1]]            # (B, L, m)
        best = vals.amax(dim=2).argmin(dim=1)
        a_p, b_p = mt[best, :, 0], mt[best, :, 1]
    else:
        # min-sum assignment init + multi-start bottleneck 2-opt
        sigma = matching.hungarian_assignment(table[:, :m, m:c_pair])
        adj = (2 * torch.arange(m, device=dev)).expand(b, m)
        a_p, b_p = matching.best_bottleneck_matching(
            table, ((ar_m, m + sigma), (ar_m, rev), (adj, adj + 1)))
    # never-slower guard against strong_weak (t_sw is the fp32 threshold)
    use = (matching.pair_bottleneck(table, a_p, b_p) < t_sw)[:, None]
    return torch.where(use, a_p, ar_m), torch.where(use, b_p, rev)


def _fast_finish(cand, gains, t_cmp, n_samples, model_bits,
                 prm: EngineParams, oma: bool, c: int,
                 pairing: str) -> EngineSchedule:
    """Stages 3-5 for an admission mask with exactly ``c`` members per
    row: rank, pairing under the policy, power/rates (the pairscore
    kernel on a CUDA device), round time, client-space outputs."""
    b, n = gains.shape
    n0b, pmax, bw = prm.noise_power_w, prm.max_power_w, prm.bandwidth_hz
    dev = gains.device
    odd = c % 2
    c_pair = c - odd
    m = c_pair // 2
    with trace.span("plan.compact", fenced=True, keys=b * (n + c)) as sp:
        sg_c, sid_c = _sort_admitted(cand, gains, c)
        sp.fence(sg_c, sid_c)
    score = lambda g_i, g_j: pairscore.pairscore(g_i, g_j, n0b=n0b,
                                                 pmax=pmax, bw=bw, oma=oma)

    # rates/powers in rank space and the (strong, weak) client ids
    parts_r, parts_p = [], []
    if pairing == "strong_weak" or m == 0:
        # rank p (strong) pairs rank c_pair-1-p (weak)
        if m:
            p_i, p_j, r_i, r_j = score(sg_c[:, :m],
                                       sg_c[:, m:c_pair].flip(1))
            parts_r += [r_i, r_j.flip(1)]
            parts_p += [p_i, p_j.flip(1)]
        strong_tab = [sid_c[:, :m]]
        weak_tab = [sid_c[:, m:c_pair].flip(1)]
    elif pairing == "adjacent":
        p_i, p_j, r_i, r_j = score(sg_c[:, 0:c_pair:2], sg_c[:, 1:c_pair:2])
        parts_r.append(torch.stack([r_i, r_j], dim=-1).reshape(b, c_pair))
        parts_p.append(torch.stack([p_i, p_j], dim=-1).reshape(b, c_pair))
        strong_tab = [sid_c[:, 0:c_pair:2]]
        weak_tab = [sid_c[:, 1:c_pair:2]]
    else:
        strong_pos, weak_pos = _matching_positions(
            sg_c, sid_c, t_cmp, model_bits, prm, oma, pairing, c_pair)
        p_i, p_j, r_i, r_j = score(sg_c.gather(1, strong_pos),
                                   sg_c.gather(1, weak_pos))
        # back to rank space: [strong_pos | weak_pos] is a permutation
        pos = torch.cat([strong_pos, weak_pos], dim=1)
        zeros = torch.zeros((b, c_pair), dtype=torch.float32, device=dev)
        parts_r.append(zeros.scatter(1, pos, torch.cat([r_i, r_j], dim=1)))
        parts_p.append(zeros.scatter(1, pos, torch.cat([p_i, p_j], dim=1)))
        strong_tab = [sid_c.gather(1, strong_pos)]
        weak_tab = [sid_c.gather(1, weak_pos)]
    if odd:
        parts_r.append(pairscore.solo_rate_math(sg_c[:, c - 1:c], n0b=n0b,
                                                pmax=pmax, bw=bw))
        parts_p.append(torch.full((b, 1), pmax, dtype=torch.float32,
                                  device=dev))
        strong_tab.append(sid_c[:, c - 1:c])
        weak_tab.append(torch.full((b, 1), -1, dtype=torch.int64,
                                   device=dev))
    rate_srt = torch.cat(parts_r, dim=1)
    pow_srt = torch.cat(parts_p, dim=1)

    # round time over the admitted (max is order-free), then client space
    mb = model_bits[:, None]
    tot = t_cmp.gather(1, sid_c) + mb / torch.clamp(rate_srt, min=1e-9)
    t_round = tot.max(dim=1).values
    zeros = torch.zeros((b, n), dtype=torch.float32, device=dev)
    rates = zeros.scatter(1, sid_c, rate_srt)
    powers = zeros.scatter(1, sid_c, pow_srt)
    t_com = mb / torch.clamp(rates, min=1e-9)
    w = n_samples * cand
    w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-12)

    # pair table ((c + 1) // 2 rows: no padding, since c >= 1)
    return EngineSchedule(
        selected=cand, pair_strong=torch.cat(strong_tab, dim=1),
        pair_weak=torch.cat(weak_tab, dim=1), rates=rates, powers=powers,
        t_cmp=t_cmp, t_com=t_com, t_round=t_round, agg_weights=w,
        evicted=torch.zeros((b, n), dtype=torch.bool, device=dev))


# ---------------------------------------------------------------------------
# joint (pairing-aware) selection
# ---------------------------------------------------------------------------


def _completion_table(g_sorted, t_cmp_sorted, model_bits, prm: EngineParams,
                      oma: bool):
    """fp32 ``pairscore.completion_table`` with the engine's params (the
    pairscore kernel scores the grid on a CUDA device)."""
    return pairscore.completion_table(
        g_sorted, t_cmp_sorted, model_bits, n0b=prm.noise_power_w,
        pmax=prm.max_power_w, bw=prm.bandwidth_hz, oma=oma)


def _solo_completion(gains, t_cmp, model_bits, prm: EngineParams):
    """T_cmp + S / R of a client alone on a subchannel at full power."""
    return t_cmp + model_bits / torch.clamp(
        pairscore.solo_rate_math(gains, n0b=prm.noise_power_w,
                                 pmax=prm.max_power_w, bw=prm.bandwidth_hz),
        min=1e-9)


def _sw_completion(mask, gains, t_cmp, model_bits, prm: EngineParams,
                   oma: bool, c: int):
    """Strong_weak completion of the ``c``-member sets in ``mask``:
    (t_round (B,), per-rank completions (B, c), member ids by rank
    (B, c))."""
    sg, sidx = torch.sort(torch.where(mask, gains, -torch.inf), dim=1,
                          descending=True, stable=True)
    sg, sidx = sg[:, :c], sidx[:, :c]
    tc = t_cmp.gather(1, sidx)
    odd = c % 2
    cp = c - odd
    m = cp // 2
    mb = model_bits[:, None]
    parts = []
    if m:
        _, _, r_i, r_j = pairscore.pairscore(
            sg[:, :m], sg[:, m:cp].flip(1), n0b=prm.noise_power_w,
            pmax=prm.max_power_w, bw=prm.bandwidth_hz, oma=oma)
        comp_s = tc[:, :m] + mb / torch.clamp(r_i, min=1e-9)
        comp_w = tc[:, m:cp].flip(1) + mb / torch.clamp(r_j, min=1e-9)
        parts = [comp_s, comp_w.flip(1)]
    if odd:
        parts.append(_solo_completion(sg[:, cp:], tc[:, cp:], mb, prm))
    comp = torch.cat(parts, dim=1)
    return comp.amax(dim=1), comp, sidx


def _joint_enum_mask(gains, t_cmp, model_bits, prm: EngineParams, oma: bool,
                     n: int, c: int):
    """Exhaustive joint admission (n <= JOINT_ENUM_MAX_N): every C(n, c)
    candidate set at its optimal matching, argmin-first in the
    ``enumerate_subsets`` x ``enumerate_matchings`` order. Solo: the
    weakest member when c is odd."""
    b = gains.shape[0]
    dev = gains.device
    subsets = torch.as_tensor(enumerate_subsets(n, c), device=dev)
    g_s = gains[:, subsets]                                     # (B, L, c)
    sg, sidx = torch.sort(g_s, dim=-1, descending=True, stable=True)
    st = t_cmp[:, subsets].gather(-1, sidx)
    odd = c % 2
    cp = c - odd
    m = cp // 2
    if m:
        table = _completion_table(sg[..., :cp], st[..., :cp],
                                  model_bits[:, None], prm, oma)
        mt = torch.as_tensor(enumerate_matchings(m), device=dev)
        vals = table[:, :, mt[:, :, 0], mt[:, :, 1]]            # (B,L,M,m)
        t_set = vals.amax(dim=-1).amin(dim=-1)                  # (B, L)
    else:
        t_set = torch.zeros(g_s.shape[:2], dtype=gains.dtype, device=dev)
    if odd:
        t_set = torch.maximum(t_set, _solo_completion(
            sg[..., c - 1], st[..., c - 1], model_bits[:, None], prm))
    members = subsets[t_set.argmin(dim=1)]                      # (B, c)
    return torch.zeros((b, n), dtype=torch.bool, device=dev).scatter_(
        1, members, True)


def _joint_swap_mask(cand, gains, t_cmp, model_bits, prm: EngineParams,
                     oma: bool, c: int):
    """Swap/prune local search from the greedy admission:
    JOINT_SWAP_ITERS iterations, each swapping the bottleneck member for
    the non-member with the best solo completion proxy, kept only on a
    strict strong_weak improvement (a rejected swap freezes the lane)."""
    rows = torch.arange(gains.shape[0], device=gains.device)
    proxy = _solo_completion(gains, t_cmp, model_bits[:, None], prm)
    mask = cand
    cur_t, comp, sidx = _sw_completion(mask, gains, t_cmp, model_bits, prm,
                                       oma, c)
    for _ in range(JOINT_SWAP_ITERS):
        bneck = sidx.gather(1, comp.argmax(dim=1, keepdim=True))[:, 0]
        incoming = torch.where(mask, torch.inf, proxy).argmin(dim=1)
        new_mask = mask.clone()
        new_mask[rows, bneck] = False
        new_mask[rows, incoming] = True
        new_t, new_comp, new_sidx = _sw_completion(
            new_mask, gains, t_cmp, model_bits, prm, oma, c)
        imp = new_t < cur_t
        mask = torch.where(imp[:, None], new_mask, mask)
        comp = torch.where(imp[:, None], new_comp, comp)
        sidx = torch.where(imp[:, None], new_sidx, sidx)
        cur_t = torch.where(imp, new_t, cur_t)
    return mask


def _joint_refine_mask(cand, gains, t_cmp, model_bits, prm: EngineParams,
                       oma: bool, c: int):
    """Joint admission for 0 < c < n, without the realized-time guard: the
    caller finishes both masks and keeps the strictly faster
    (``_pick_faster``)."""
    n = gains.shape[-1]
    if n <= JOINT_ENUM_MAX_N:
        return _joint_enum_mask(gains, t_cmp, model_bits, prm, oma, n, c)
    return _joint_swap_mask(cand, gains, t_cmp, model_bits, prm, oma, c)


def _where_rows(keep, old, new):
    """``old`` where ``keep`` (B,), else ``new``, over any trailing dims."""
    return torch.where(keep.reshape(keep.shape + (1,) * (old.dim() - 1)),
                       old, new)


def _pick_faster(a: EngineSchedule, b: EngineSchedule) -> EngineSchedule:
    """Per-batch-element never-worse guard: ``a`` where strictly faster,
    else ``b`` (ties keep ``b``, the greedy set)."""
    better = a.t_round < b.t_round
    return EngineSchedule(*(_where_rows(better, x, y) for x, y in zip(a, b)))


def _fast_schedule_batch(priority, gains, t_cmp, n_samples, model_bits,
                         prm: EngineParams, oma: bool, c: int,
                         pairing: str, selection: str) -> EngineSchedule:
    """Greedy admission -> finish; ``selection="joint"`` also refines the
    admitted set and keeps the refined schedule only where strictly
    faster under the active pairing policy."""
    b, n = gains.shape
    with trace.span("plan.admit", fenced=True, n=n, slots=c,
                    keys=2 * b * n if c < n else 0) as sp:
        cand = _admit(priority, gains, c)
        sp.fence(cand)
    with trace.span("plan.finalize", fenced=True, n=n) as sp:
        out = _fast_finish(cand, gains, t_cmp, n_samples, model_bits, prm,
                           oma, c, pairing)
        sp.fence(out.t_round)
    if selection == "joint" and 0 < c < n:
        with trace.span("plan.joint", fenced=True, n=n) as sp:
            refined = _joint_refine_mask(cand, gains, t_cmp, model_bits,
                                         prm, oma, c)
            sp.fence(refined)
        with trace.span("plan.finalize", fenced=True, n=n) as sp:
            out = _pick_faster(_fast_finish(refined, gains, t_cmp,
                                            n_samples, model_bits, prm, oma,
                                            c, pairing), out)
            sp.fence(out.t_round)
    return out


# ---------------------------------------------------------------------------
# round-time budget: the eviction/backfill loop (plan.plan_round)
# ---------------------------------------------------------------------------


def _drop_scatter(n: int, at, vals):
    """(B, n) zeros with ``vals`` written at ``at`` (B, k); index ``n`` is
    the drop target of rows that do not exist."""
    out = torch.zeros((at.shape[0], n + 1), dtype=vals.dtype,
                      device=vals.device)
    return out.scatter_(1, at, vals)[:, :n]


def _assemble(cand, gains, t_cmp, model_bits, prm: EngineParams, oma: bool,
              n_pairs: int, pairing: str):
    """Pair each row's candidate mask under ``pairing``, allocate power and
    scatter rates/powers to client space (``plan.match_candidates`` +
    ``plan.allocate_rates``). The candidate count c varies per row, so
    every rank index is a (B,) tensor; the matching policies run on static
    (P, P) tables masked for the row's pair count m. All B x P pair rows
    are scored in one pairscore call (the CUDA kernel on a CUDA device).
    Returns (strong (B, P), weak (B, P), rates (B, n), powers (B, n))."""
    b, n = gains.shape
    n0b, pmax, bw = prm.noise_power_w, prm.max_power_w, prm.bandwidth_hz
    dev = gains.device
    c = cand.sum(dim=1)
    sidx = torch.sort(torch.where(cand, gains, -torch.inf), dim=1,
                      descending=True, stable=True).indices
    odd = c % 2
    has_solo = odd.bool()
    c_pair = c - odd
    m = c_pair // 2
    solo_idx = sidx.gather(1, (c - 1).clamp(0, n - 1)[:, None])[:, 0]
    at_rank = lambda r: sidx.gather(1, r.clamp(0, n - 1))

    i = torch.arange(n_pairs, device=dev).expand(b, n_pairs)
    valid = i < m[:, None]
    if pairing == "strong_weak":
        strong_at, weak_at = i, c_pair[:, None] - 1 - i
    elif pairing == "adjacent":
        strong_at, weak_at = 2 * i, 2 * i + 1
    elif pairing == "greedy_matching":
        g_s = gains.gather(1, at_rank(i))                     # strong half
        g_w = gains.gather(1, at_rank(m[:, None] + i))        # weak half
        score = torch.where(
            valid[:, :, None] & valid[:, None, :],
            pairscore.effective_power_table(g_s, g_w, n0b=n0b, pmax=pmax),
            -1.0)
        strong_at = i
        weak_at = m[:, None] + matching.greedy_assignment(score)
    else:                                                     # hungarian
        strong_at, weak_at = _budget_hungarian(
            sidx, gains, t_cmp, model_bits, prm, oma, n_pairs, m, c_pair,
            valid)
    strong = torch.where(valid, at_rank(strong_at), -1)
    weak = torch.where(valid, at_rank(weak_at), -1)
    p_i, p_j, r_i, r_j = pairscore.pairscore(
        gains.gather(1, strong.clamp(0, n - 1)),
        gains.gather(1, weak.clamp(0, n - 1)), n0b=n0b, pmax=pmax, bw=bw,
        oma=oma)

    at = torch.cat([torch.where(valid, strong, n), torch.where(valid, weak, n),
                    torch.where(has_solo, solo_idx, n)[:, None]], dim=1)
    solo_r = pairscore.solo_rate_math(gains.gather(1, solo_idx[:, None]),
                                      n0b=n0b, pmax=pmax, bw=bw)
    rates = _drop_scatter(n, at, torch.cat([r_i, r_j, solo_r], dim=1))
    powers = _drop_scatter(n, at, torch.cat(
        [p_i, p_j, torch.full_like(solo_r, pmax)], dim=1))

    # the solo subchannel occupies pair row m as (solo, -1)
    m_at = m.clamp(0, n_pairs - 1)[:, None]
    strong = strong.scatter(1, m_at, torch.where(
        has_solo[:, None], solo_idx[:, None], strong.gather(1, m_at)))
    return strong, weak, rates, powers


def _budget_hungarian(sidx, gains, t_cmp, model_bits, prm: EngineParams,
                      oma: bool, n_pairs: int, m, c_pair, valid):
    """Rank positions (strong, weak) (B, P) of the hungarian policy for a
    per-row pair count m over the fp32 completion table of the top
    s2 = min(2P, n) ranks: exact enumeration for m <= ENUM_MAX_PAIRS, the
    Hungarian assignment on the ``pad_cost_table``-masked cost and a
    three-start bottleneck 2-opt above, and the never-slower guard against
    strong_weak."""
    b, n = gains.shape
    dev = gains.device
    s2 = min(2 * n_pairs, n)
    top = sidx[:, :s2]
    table = _completion_table(gains.gather(1, top), t_cmp.gather(1, top),
                              model_bits, prm, oma)           # (B, s2, s2)
    i = torch.arange(n_pairs, device=dev).expand(b, n_pairs)
    rev = torch.where(valid, c_pair[:, None] - 1 - i, i)
    a_p, b_p = i, rev
    mm_of = m[:, None]
    for mm in range(1, min(ENUM_MAX_PAIRS, n_pairs) + 1):
        if 2 * mm > s2:
            continue
        mt = torch.as_tensor(enumerate_matchings(mm), device=dev)
        vals = table[:, mt[:, :, 0], mt[:, :, 1]]             # (B, L, mm)
        best = vals.amax(dim=2).argmin(dim=1)
        am = torch.cat([mt[best, :, 0], i[:, mm:]], dim=1)
        bm = torch.cat([mt[best, :, 1], i[:, mm:]], dim=1)
        a_p = torch.where(mm_of == mm, am, a_p)
        b_p = torch.where(mm_of == mm, bm, b_p)
    if n_pairs > ENUM_MAX_PAIRS:
        cols = (mm_of + i).clamp(0, s2 - 1)                   # (B, P)
        cost = table[:, :n_pairs].gather(
            2, cols[:, None, :].expand(b, n_pairs, n_pairs))
        sigma = matching.hungarian_assignment(
            matching.pad_cost_table(cost, m))
        adj = 2 * i
        ah, bh = matching.best_bottleneck_matching(
            table, ((i, mm_of + sigma), (i, rev), (adj, adj + 1)),
            m_valid=m)
        big = mm_of > ENUM_MAX_PAIRS
        a_p = torch.where(big, ah, a_p)
        b_p = torch.where(big, bh, b_p)
    use = (matching.pair_bottleneck(table, a_p, b_p, m_valid=m)
           < matching.pair_bottleneck(table, i, rev, m_valid=m))[:, None]
    return torch.where(use, a_p, i), torch.where(use, b_p, rev)


class _LoopState(NamedTuple):
    cand: torch.Tensor       # (B, n) bool
    evicted: torch.Tensor    # (B, n) bool
    qptr: torch.Tensor       # (B,) backfill cursor into the order
    done: torch.Tensor       # (B,) bool
    strong: torch.Tensor     # (B, P)
    weak: torch.Tensor       # (B, P)
    rates: torch.Tensor      # (B, n)
    powers: torch.Tensor     # (B, n)
    t_com: torch.Tensor      # (B, n)
    tot: torch.Tensor        # (B, n) completion times of the candidates
    t_round: torch.Tensor    # (B,)


def _budget_schedule(priority, gains, t_cmp, n_samples, model_bits,
                     t_budget, prm: EngineParams, oma: bool, c: int,
                     pairing: str, selection: str) -> EngineSchedule:
    """Top-``c`` admission by (priority, gain, index) (plus the joint
    refinement, kept where its realized round time is strictly lower),
    then the budget eviction/backfill loop: while a row's round time
    exceeds ``t_budget`` (B,) and it has more than one candidate, evict
    its latency-critical client (``argmax`` of the completion times: the
    first maximal index, as ``jnp.argmax`` takes) and backfill the first
    never-admitted, never-evicted client at or after the row's cursor in
    the admission order. The cursor starts at ``prm.slots``."""
    b, n = gains.shape
    dev = gains.device
    n_pairs = max((c + 1) // 2, 1)
    rows = torch.arange(b, device=dev)
    pos = torch.arange(n, device=dev)
    with trace.span("plan.admit", fenced=True, n=n, slots=c,
                    keys=2 * b * n) as sp:
        order = _admission_order(priority, gains)
        cand0 = torch.zeros((b, n), dtype=torch.bool, device=dev).scatter_(
            1, order[:, :c], True)
        sp.fence(cand0)

    def sched_of(cand):
        with trace.span("plan.finalize", fenced=True, n=n) as sp:
            strong, weak, rates, powers = _assemble(
                cand, gains, t_cmp, model_bits, prm, oma, n_pairs, pairing)
            t_com = model_bits[:, None] / torch.clamp(rates, min=1e-9)
            tot = torch.where(cand, t_cmp + t_com, 0.0)
            sp.fence(tot)
        return strong, weak, rates, powers, t_com, tot, tot.amax(dim=1)

    s0 = sched_of(cand0)
    if selection == "joint" and 0 < c < n:
        with trace.span("plan.joint", fenced=True, n=n) as sp:
            refined = _joint_refine_mask(cand0, gains, t_cmp, model_bits,
                                         prm, oma, c)
            sp.fence(refined)
        s_joint = sched_of(refined)
        use = s_joint[6] < s0[6]            # never-worse guard (realized)
        cand0 = torch.where(use[:, None], refined, cand0)
        s0 = tuple(_where_rows(use, x, y) for x, y in zip(s_joint, s0))
    done = (t_budget <= 0.0) | (s0[6] <= t_budget) | (cand0.sum(dim=1) <= 1)
    st = _LoopState(cand0, torch.zeros_like(cand0),
                    torch.full((b,), prm.slots, dtype=torch.int64,
                               device=dev), done, *s0)
    iters = 0
    while not bool(st.done.all()):
        # each iteration evicts one client of every live row, so no row
        # outlives n iterations
        if iters == n:
            raise RuntimeError("budget loop ran past its n-iteration bound")
        iters += 1
        with trace.span("plan.evict", fenced=True, n=n) as sp:
            worst = st.tot.argmax(dim=1)
            cand = st.cand.clone()
            cand[rows, worst] = False
            evicted = st.evicted.clone()
            evicted[rows, worst] = True
            elig = (~cand.gather(1, order) & ~evicted.gather(1, order)
                    & (pos >= st.qptr[:, None]))
            fill = elig.any(dim=1)
            at = elig.to(torch.uint8).argmax(dim=1)
            nxt = torch.where(fill, order.gather(1, at[:, None])[:, 0], n)
            cand = cand | _drop_scatter(n, nxt[:, None],
                                        torch.ones_like(cand[:, :1]))
            qptr = torch.where(fill, at + 1, st.qptr)
            sp.fence(cand)
        s = sched_of(cand)
        done = (s[6] <= t_budget) | (cand.sum(dim=1) <= 1)
        new = _LoopState(cand, evicted, qptr, done, *s)
        st = _LoopState(*(_where_rows(st.done, old, upd)
                          for old, upd in zip(st, new)))

    w = n_samples * st.cand
    w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-12)
    return EngineSchedule(
        selected=st.cand, pair_strong=st.strong, pair_weak=st.weak,
        rates=st.rates, powers=st.powers, t_cmp=t_cmp, t_com=st.t_com,
        t_round=st.t_round, agg_weights=w, evicted=st.evicted)


# ---------------------------------------------------------------------------
# multi-cell: partition clients by cell, plan each cell, merge
# (plan.plan_multicell)
# ---------------------------------------------------------------------------


def _cell_member_table(cell, n_cells: int, cap: int):
    """(B, C, cap) client ids per cell: the first ``cap`` members in
    client-index order (plan.py's truncation rule), padded with ``n``. One
    sort of the keys ``cell * n + idx`` groups each cell's members in
    index order; ``searchsorted`` finds each member's cell start, giving
    its position within the cell."""
    b, n = cell.shape
    dev = cell.device
    key = cell.to(torch.int64) * n + torch.arange(n, device=dev)
    skey = torch.sort(key, dim=1).values
    scell = skey // n
    first = torch.searchsorted(scell, scell)
    posc = torch.arange(n, device=dev) - first
    keep = (posc < cap) & (scell >= 0) & (scell < n_cells)
    dest = torch.where(keep, scell * cap + posc, n_cells * cap)
    tbl = torch.full((b, n_cells * cap + 1), n, dtype=torch.int64,
                     device=dev).scatter_(1, dest, skey % n)
    return tbl[:, :-1].reshape(b, n_cells, cap)


def _multicell_schedule(priority, gains, t_cmp, n_samples, model_bits,
                        t_budget, cell, *, prm: EngineParams, oma: bool,
                        pairing: str, selection: str, n_cells: int,
                        cap: int) -> EngineSchedule:
    """Gather each cell's (<= cap) members into a (B * C, cap) sub-batch,
    run the fast path (``t_budget`` None) or the budget loop on it, merge
    back. Padding lanes
    carry (priority -inf, gain 0): admission ranks them last, the pair
    math gives them rate 0, and the merge drops them. A cell with fewer
    real members than slots admits padding on the fast path, as the
    reference engine does (DESIGN.md section 10)."""
    with trace.span("plan.multicell", fenced=True, n=gains.shape[1],
                    n_cells=n_cells) as sp:
        b, n = gains.shape
        tbl = _cell_member_table(cell, n_cells, cap)
        valid = tbl < n
        flat = tbl.clamp(max=n - 1).reshape(b, n_cells * cap)

        def gather(x, fill):
            g = x.gather(1, flat).reshape(b, n_cells, cap)
            return torch.where(valid, g, fill).reshape(b * n_cells, cap)

        c_prio = gather(priority, -torch.inf)
        c_g = gather(gains, 0.0)
        c_tc = gather(t_cmp, 0.0)
        c_ns = gather(n_samples, 0.0)
        c_mb = model_bits.repeat_interleave(n_cells)
        c = min(prm.slots, cap)
        if t_budget is not None:
            sub = _budget_schedule(c_prio, c_g, c_tc, c_ns, c_mb,
                                   t_budget.repeat_interleave(n_cells), prm,
                                   oma, c, pairing, selection)
        else:
            sub = _fast_schedule_batch(c_prio, c_g, c_tc, c_ns, c_mb, prm,
                                       oma, c, pairing, selection)
        out = _merge_cells(sub, tbl, valid, t_cmp, n_samples, model_bits)
        sp.fence(out.t_round)
        return out


def _merge_cells(sub: EngineSchedule, tbl, valid, t_cmp, n_samples,
                 model_bits) -> EngineSchedule:
    """Scatter per-cell schedules back to client space: round time = max
    over cells (cells transmit in parallel), aggregation weights pooled
    over all selected clients, pair tables remapped to global ids."""
    b, n_cells, cap = tbl.shape
    n = t_cmp.shape[1]
    re = lambda x: x.reshape(b, n_cells, cap)
    sel_pc = re(sub.selected) & valid
    tot_pc = torch.where(sel_pc, re(sub.t_cmp) + re(sub.t_com), 0.0)
    t_round = tot_pc.amax(dim=(1, 2))
    cols = torch.where(valid, tbl, n).reshape(b, n_cells * cap)
    scat = lambda v: _drop_scatter(n, cols, v.reshape(b, n_cells * cap))
    selected = scat(sub.selected)
    rates = scat(sub.rates)
    t_com = model_bits[:, None] / torch.clamp(rates, min=1e-9)

    def remap(p):
        pc = p.reshape(b, n_cells, -1)
        g = tbl.gather(2, pc.clamp(0, cap - 1))
        return torch.where((pc >= 0) & (g < n), g, -1).reshape(b, -1)

    w = n_samples * selected
    w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-12)
    return EngineSchedule(
        selected=selected, pair_strong=remap(sub.pair_strong),
        pair_weak=remap(sub.pair_weak), rates=rates, powers=scat(sub.powers),
        t_cmp=t_cmp, t_com=t_com, t_round=t_round, agg_weights=w,
        evicted=scat(sub.evicted))


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
                       admission: Optional[str] = None, cell=None,
                       n_cells: Optional[int] = None) -> EngineSchedule:
        """Joint round over a batch of environments.

        gains/n_samples/cpu_freq/ages: (B, N) arrays or tensors;
        model_bits: scalar or (B,). ``priority=None`` uses the paper's age
        priority. ``admission`` (auto | full_sort | segmented) names the
        reference's implementation choice; all three give one mask here.

        ``t_budget`` a Python scalar <= 0 runs the fast path (no budget);
        a positive scalar, or any array or tensor (B,), runs the budget
        eviction loop. ``cell`` ((B, N) int serving-cell ids) with
        ``n_cells > 1`` (default ``FLConfig.n_cells``) runs the
        cell-partitioned planner; ``n_cells == 1`` ignores ``cell``.
        """
        b, n = np.shape(gains)
        no_budget = (isinstance(t_budget, (int, float))
                     and float(t_budget) <= 0.0)
        sig = ("schedule_batch", b, n, no_budget, oma,
               pairing or self.pairing, selection or self.selection,
               cell is not None, priority is None, str(self.device))
        with trace.span("engine.schedule_batch", fenced=True, b=b, n=n,
                        cold=trace.cold(sig)) as sp:
            out = self._schedule_batch_impl(
                gains, n_samples, cpu_freq, ages, model_bits,
                t_budget=t_budget, oma=oma, priority=priority,
                pairing=pairing, selection=selection, admission=admission,
                cell=cell, n_cells=n_cells)
            sp.fence(out.t_round)
            return out

    def _schedule_batch_impl(self, gains, n_samples, cpu_freq, ages,
                             model_bits, *, t_budget, oma: bool, priority,
                             pairing: Optional[str],
                             selection: Optional[str],
                             admission: Optional[str], cell,
                             n_cells: Optional[int]) -> EngineSchedule:
        pairing = _check_pairing(pairing or self.pairing)
        selection = _check_selection(selection or self.selection)
        _check_admission(admission or self.admission)
        no_budget = (isinstance(t_budget, (int, float))
                     and float(t_budget) <= 0.0)
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
        tb = None if no_budget else \
            self._tensor(t_budget).expand(b).contiguous()
        n_cells = self.flcfg.n_cells if n_cells is None else n_cells
        if cell is not None and n_cells > 1:
            return _multicell_schedule(
                priority, gains, t_cmp, n_samples, model_bits, tb,
                torch.as_tensor(np.asarray(cell) if not torch.is_tensor(cell)
                                else cell, device=self.device),
                prm=self.prm, oma=oma, pairing=pairing, selection=selection,
                n_cells=n_cells, cap=cell_capacity(n, n_cells,
                                                   self.prm.slots))
        if no_budget:
            return _fast_schedule_batch(priority, gains, t_cmp, n_samples,
                                        model_bits, self.prm, oma, c,
                                        pairing, selection)
        return _budget_schedule(priority, gains, t_cmp, n_samples,
                                model_bits, tb, self.prm, oma, c, pairing,
                                selection)

    def schedule(self, env: RoundEnv, *, t_budget: Optional[float] = None,
                 oma: bool = False, priority=None,
                 policy: str = "age_noma",
                 pairing: Optional[str] = None,
                 selection: Optional[str] = None, cell=None) -> Schedule:
        """Single-env wrapper returning the numpy ``Schedule`` (used by
        ``FLServer``); ``cell`` (N,) is the serving-cell map."""
        if t_budget is None:
            t_budget = self.flcfg.t_budget_s
        batchify = lambda a: a[None] if torch.is_tensor(a) \
            else np.asarray(a)[None]
        out = self.schedule_batch(
            batchify(env.gains), batchify(env.n_samples),
            batchify(env.cpu_freq), batchify(env.ages), env.model_bits,
            t_budget=t_budget, oma=oma, pairing=pairing,
            selection=selection,
            priority=None if priority is None else batchify(priority),
            cell=None if cell is None else batchify(cell))
        return engine_schedule_to_numpy(out, 0, info={
            "policy": policy, "engine": "torch",
            "evicted": np.flatnonzero(
                out.evicted[0].cpu().numpy()).tolist()})

    # -- Monte-Carlo rollout ----------------------------------------------

    def montecarlo_rounds(self, gains_seq, n_samples, cpu_freq, model_bits,
                          *, policy: str = "age_noma", t_budget: float = 0.0,
                          seed: int = 0, shard: bool = False,
                          pairing: Optional[str] = None,
                          selection: Optional[str] = None,
                          admission: Optional[str] = None,
                          cell_seq=None) -> dict:
        """Roll the AoU state machine over R rounds for S seeds, one batched
        step per round: gains_seq (R, S, N); n_samples/cpu_freq either
        (S, N) static or (R, S, N) per round (pre-sampled). A positive
        ``t_budget`` runs the budget eviction loop every round
        (``policy="age_noma_budget"`` is the age priority under it).
        ``cell_seq`` ((R, S, N) int) runs the cell-partitioned planner when
        ``FLConfig.n_cells > 1``. ``shard=True`` splits the seeds over the
        visible CUDA devices (module docstring).

        Returns the reference's keys, as tensors on the engine's device:
        t_round, n_selected, max_age, t_comp_bottleneck, t_up_bottleneck,
        n_evicted (R, S), aou_hist (R, S, 7), participation and
        final_ages (S, N), and under multi-cell the per-round
        ``handovers`` (R, S): clients whose serving cell changed (0 in
        round 0). ``policy="random"`` draws its priorities from a
        ``torch.Generator`` seeded with ``seed``, one (S, N) draw per round
        (it cannot reproduce the reference's ``jax.random`` stream).
        """
        gains_seq = self._tensor(gains_seq)
        n_samples = self._tensor(n_samples)
        cpu_freq = self._tensor(cpu_freq)
        if cell_seq is not None:
            if not torch.is_tensor(cell_seq):
                cell_seq = np.asarray(cell_seq)
            cell_seq = torch.as_tensor(cell_seq, device=self.device)
        r, s = gains_seq.shape[:2]

        def run(dev, block):
            rows = (lambda x: x) if block is None else \
                (lambda x: x[..., block[0]:block[1], :].to(dev))
            g, ns, cf = rows(gains_seq), rows(n_samples), rows(cpu_freq)
            cs = None if cell_seq is None else rows(cell_seq)
            per_round = lambda x, i: x if x.dim() == 2 else x[i]

            def env_fn(i):
                return (g[i], per_round(ns, i), per_round(cf, i),
                        None if cs is None else cs[i])

            return self._mc_loop(env_fn, r, model_bits, policy=policy,
                                 t_budget=t_budget, seed=seed,
                                 pairing=pairing, selection=selection,
                                 admission=admission, device=dev,
                                 block=block)

        return split_seeds(run, s, shard_devices(self.device) if shard
                           else [self.device], home=self.device)

    def montecarlo_scenario(self, scenario, *, rounds: int, n_seeds: int,
                            n_clients: int, model_bits,
                            policy: str = "age_noma", t_budget: float = 0.0,
                            seed: int = 0, key: Optional[int] = None,
                            shard: bool = False,
                            pairing: Optional[str] = None,
                            selection: Optional[str] = None,
                            admission: Optional[str] = None) -> dict:
        """The fused Monte-Carlo rollout: the scenario's ``step(state,
        seed) -> (state, env)`` advances the environment on the engine's
        device between scheduled rounds, so no (R, S, N) array exists.

        ``scenario`` is duck-typed (``repro_torch.sim.Scenario``): the
        engine calls ``init_and_keys(key, rounds, (S, N), device=...,
        block=...)`` and ``step(state, seed, block=...)``. ``key`` (an
        integer) defaults to ``seed``; ``fl.rounds.run_montecarlo`` passes
        the same key to ``Scenario.rollout``, so its ``presampled=`` path
        gives bitwise the same result. Returns ``montecarlo_rounds``'s
        dict.
        """
        key = seed if key is None else key

        def run(dev, block):
            state, seeds = scenario.init_and_keys(
                key, rounds, (n_seeds, n_clients), device=dev, block=block)
            box = [state]

            def env_fn(i):
                box[0], env = scenario.step(box[0], seeds[i], block=block)
                return env.gains, env.n_samples, env.cpu_freq, env.cell

            return self._mc_loop(env_fn, rounds, model_bits, policy=policy,
                                 t_budget=t_budget, seed=seed,
                                 pairing=pairing, selection=selection,
                                 admission=admission, device=dev,
                                 block=block)

        return split_seeds(run, n_seeds, shard_devices(self.device) if shard
                           else [self.device], home=self.device)

    def _mc_loop(self, env_fn, rounds: int, model_bits, *, policy: str,
                 t_budget: float, seed: int, pairing: Optional[str] = None,
                 selection: Optional[str] = None,
                 admission: Optional[str] = None, device: torch.device,
                 block) -> dict:
        """R-round rollout on ``device``, a Python loop of per-round steps;
        ``env_fn(i)`` yields round i's (gains, n_samples, cpu_freq,
        cell-or-None). ``block=(start, stop, total)`` marks the rows as a
        block of a ``total``-seed batch (the random policy keeps its rows
        of the whole batch's draw); None, the whole batch."""
        if policy not in MC_POLICIES + ("age_noma_budget",):
            raise ValueError(f"unknown montecarlo policy {policy!r} (expected "
                             f"one of {MC_POLICIES + ('age_noma_budget',)})")
        pairing = _check_pairing(pairing or self.pairing)
        selection = _check_selection(selection or self.selection)
        _check_admission(admission or self.admission)
        gen = torch.Generator(device=device).manual_seed(seed)
        mb = self._tensor(model_bits).to(device)
        n_cells = self.flcfg.n_cells
        ages = part = prev_cell = None
        multicell = False
        keys = ("t_round", "n_selected", "max_age", "t_comp_bottleneck",
                "t_up_bottleneck", "n_evicted", "aou_hist")
        out = {k: [] for k in keys}
        handovers = []
        with trace.span("engine.mc_loop", fenced=True, rounds=rounds,
                        policy=policy) as sp:
            for i in range(rounds):
                with trace.span("mc.round", fenced=True, i=i) as rs:
                    gains, n_samples, cpu_freq, cell = env_fn(i)
                    s, n = gains.shape
                    rs.note(s=s, n=n)
                    if ages is None:
                        ages = torch.ones(gains.shape, dtype=torch.float32,
                                          device=device)
                        part = torch.zeros(gains.shape,
                                           dtype=torch.float32,
                                           device=device)
                        multicell = n_cells > 1 and cell is not None
                        sp.note(s=s, n=n, cold=trace.cold(
                            ("mc", s, n, policy, pairing, selection,
                             float(t_budget), multicell, str(device))))
                    ages, part, diag = _montecarlo_step(
                        ages, part, gains, n_samples, cpu_freq, mb, i, gen,
                        cell if multicell else None, prm=self.prm,
                        gamma=self.flcfg.age_exponent, policy=policy,
                        t_budget=float(t_budget), pairing=pairing,
                        selection=selection, n_cells=n_cells, block=block)
                    for k in keys:
                        out[k].append(diag[k])
                    if multicell:
                        handovers.append(
                            torch.zeros(gains.shape[0], dtype=torch.int64,
                                        device=device) if prev_cell is None
                            else (cell != prev_cell).sum(dim=1))
                        prev_cell = cell
                    rs.fence(ages)
            sp.fence(ages)
        out = {k: torch.stack(v) for k, v in out.items()}
        out["participation"] = part
        out["final_ages"] = ages
        if multicell:
            out["handovers"] = torch.stack(handovers)
        return out


# the (S, N) leaves of a Monte-Carlo result; every other leaf is (R, S, ...)
PER_SEED_KEYS = ("participation", "final_ages")


def shard_devices(device: torch.device) -> list:
    """The devices ``shard=True`` splits seeds over: every visible CUDA
    device for an engine on a CUDA device, else the engine's device."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def split_seeds(run, s: int, devices, *, home=None) -> dict:
    """Run ``run(device, block)`` over contiguous blocks of the S seeds,
    block k = rows ``k S/D : (k+1) S/D`` on ``devices[k]`` (D of them),
    each in its own worker thread, and join the blocks' results along the
    seed axis on ``home`` (default ``devices[0]``). With one device, or S
    not divisible by D, one ``run(home, None)``: the reference's rule."""
    home = devices[0] if home is None else home
    d = len(devices)
    if d < 2 or s % d:
        return run(home, None)
    m = s // d

    def work(k):
        dev = devices[k]
        ctx = torch.cuda.device(dev) if dev.type == "cuda" \
            else contextlib.nullcontext()
        with ctx:
            return run(dev, (k * m, (k + 1) * m, s))

    with ThreadPoolExecutor(max_workers=d) as pool:
        outs = list(pool.map(work, range(d)))
    return {k: torch.cat([o[k].to(home) for o in outs],
                         dim=0 if k in PER_SEED_KEYS else 1)
            for k in outs[0]}


def _montecarlo_step(ages, part, gains, n_samples, cpu_freq, model_bits,
                     round_idx: int, gen, cell=None, *, prm: EngineParams,
                     gamma: float, policy: str, t_budget: float,
                     pairing: str, selection: str, n_cells: int = 1,
                     block=None):
    """One Monte-Carlo round over all seeds: the policy's priority, the
    schedule (the fast path, the budget loop for ``t_budget > 0``, or the
    cell-partitioned planner for a non-None ``cell``), the age update.
    Under ``block`` the random policy draws the whole batch's (total, N)
    priorities and keeps its rows. Returns (ages, participation, the
    round's diag leaves plus max_age)."""
    s, n = gains.shape
    cap = n if cell is None else cell_capacity(n, n_cells, prm.slots)
    c = min(prm.slots, cap)
    oma = policy == "oma_age"
    mb = model_bits.expand(s)
    with trace.span("plan.priority", fenced=True) as sp:
        t_cmp = _compute_times(prm, n_samples, cpu_freq)
        if policy in ("age_noma", "age_noma_budget", "oma_age"):
            prio = _age_priority(ages, n_samples, gamma)
        elif policy == "channel":
            prio = gains
        elif policy == "random":
            total = s if block is None else block[2]
            prio = torch.rand((total, n), generator=gen, device=gains.device)
            if block is not None:
                prio = prio[block[0]:block[1]]
        else:                                       # round_robin
            prio = round_robin_priority(round_idx, n, c,
                                        gains.device).expand(s, n)
        sp.fence(t_cmp, prio)
    tb = None if t_budget <= 0.0 else torch.full(
        (s,), t_budget, dtype=torch.float32, device=gains.device)
    if cell is not None:
        sched = _multicell_schedule(
            prio, gains, t_cmp, n_samples, mb, tb, cell, prm=prm, oma=oma,
            pairing=pairing, selection=selection, n_cells=n_cells, cap=cap)
    elif tb is None:
        sched = _fast_schedule_batch(prio, gains, t_cmp, n_samples, mb, prm,
                                     oma, c, pairing, selection)
    else:
        sched = _budget_schedule(prio, gains, t_cmp, n_samples, mb, tb, prm,
                                 oma, c, pairing, selection)
    with trace.span("plan.diag", fenced=True) as sp:
        sel = sched.selected
        ages = torch.where(sel, 1.0, ages + 1.0)
        diag = schedule_diag(sched, ages)
        diag["max_age"] = ages.amax(dim=1)
        part = part + sel
        sp.fence(ages, part, diag)
    return ages, part, diag


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
