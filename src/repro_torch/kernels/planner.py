"""Fused round-planner tables over gain-sorted candidates.

Counterpart of ``src/repro/kernels/planner.py`` (``planner_tables``,
``planner_tables_pallas``). For each batch row, rank p strong and rank q
weak:

    table[p, q] = bf16(max(t_p + S/R_i(p,q), t_q + S/R_j(p,q)))
    row_min[p]  = min_{q != p} of the fp32 completion
    t_sw        = max_{p < m} of the fp32 completion at (p, c_pair-1-p)

``planner_tables`` is the wrapper of the hand-written CUDA kernel
``csrc/planner.cu``, which replaces the TPU kernel ``_planner_kernel``
(src/repro/kernels/planner.py:47). Bound on the H100: it moves
B (8c + 4) + 2 B c^2 + 4 B c + 4 B bytes against B c^2 pair evaluations of
about 30 fp32 operations each; by those counts the bytes bound it, but
under NOMA each pair runs seven IEEE divides and two log1p, so the
instruction issue does. One launch a call: t_sw is reduced in the kernel
(for c > 32 by each batch row's first CTA, from the anti-diagonal it
computes again); what depends on one index is computed once a row or a
column; OMA's table is max(v_p, v_q) (see the source's note). The
wrapper allocates each output once, in its final shape, converts the
constants once for each (n0b, pmax, bw), and takes rows with unit column
stride without a copy.

``planner_tables_plain`` is the plain PyTorch version: ``pair_math`` on
broadcast (c, c) grids, the reductions from fp32, and the bf16 cast last
(round to nearest even, as ``astype(bfloat16)``). The wrapper takes it
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.pairscore import LN2, pair_math

EPS = 1e-9          # rate floor shared with pairscore.completion_table


def _prepare(g_sorted, t_cmp_sorted, model_bits):
    if g_sorted.shape != t_cmp_sorted.shape:
        raise ValueError(f"shape mismatch {tuple(g_sorted.shape)} vs "
                         f"{tuple(t_cmp_sorted.shape)}")
    lead = g_sorted.shape[:-1]
    mb = torch.as_tensor(model_bits, dtype=torch.float32,
                         device=g_sorted.device).expand(lead)
    return lead, g_sorted.shape[-1], mb


def planner_tables_plain(g_sorted, t_cmp_sorted, model_bits, *, n0b: float,
                         pmax: float, bw: float, oma: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """(table (..., c, c) bf16, row_min (..., c) fp32, t_sw (...,) fp32)
    over (..., c) gain-sorted candidates; ``model_bits`` broadcasts over
    the leading dims."""
    g = g_sorted.float()
    t = t_cmp_sorted.float()
    lead, c, mb = _prepare(g, t, model_bits)
    gi = g[..., :, None].expand(*lead, c, c)
    gj = g[..., None, :].expand(*lead, c, c)
    _, _, r_i, r_j = pair_math(gi, gj, n0b=n0b, pmax=pmax, bw=bw, oma=oma)
    mb = mb[..., None, None]
    comp = torch.maximum(t[..., :, None] + mb / torch.clamp(r_i, min=EPS),
                         t[..., None, :] + mb / torch.clamp(r_j, min=EPS))
    eye = torch.eye(c, dtype=torch.bool, device=g.device)
    row_min = torch.where(eye, torch.inf, comp).amin(dim=-1)
    c_pair = c - c % 2
    m = c_pair // 2
    if m == 0:
        t_sw = torch.zeros(lead, dtype=torch.float32, device=g.device)
    else:
        ranks = torch.arange(m, device=g.device)
        t_sw = comp[..., ranks, c_pair - 1 - ranks].amax(dim=-1)
    return comp.to(torch.bfloat16), row_min, t_sw


class PlannerConsts(ctypes.Structure):
    """The fp32 constants of a call, as ``struct PlannerConsts`` of
    ``csrc/planner.cu`` lays them out."""
    _fields_ = [(name, ctypes.c_float) for name in (
        "two_pmax", "four_pmax", "pmax", "n0b", "n0b_sq", "bw", "half_bw",
        "ln2", "tiny", "eps")]


@functools.lru_cache(maxsize=64)
def _consts(n0b: float, pmax: float, bw: float):
    """The fp32 constants of (n0b, pmax, bw), each rounded to fp32 as JAX
    rounds them, and their address (the cache keeps them alive)."""
    consts = PlannerConsts(2.0 * pmax, 4.0 * pmax, pmax, n0b, n0b * n0b, bw,
                           0.5 * bw, LN2, 1e-30, EPS)
    return consts, ctypes.addressof(consts)


def _rows(x, batch: int, c: int):
    """``x`` as (batch, c) rows with unit column stride, and its row stride:
    no copy where ``x`` has them, as the engine's column slices do."""
    if x.dim() != 2:
        x = x.reshape(batch, c)
    if x.stride(1) != 1:
        x = x.contiguous()
    return x, x.stride(0)


def planner_tables(g_sorted, t_cmp_sorted, model_bits, *, n0b: float,
                   pmax: float, bw: float, oma: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused (table, row_min, t_sw): the CUDA kernel (one launch) for CUDA
    tensors, ``planner_tables_plain`` for CPU tensors. ``g_sorted`` and
    ``t_cmp_sorted`` are (..., c) fp32 on one device."""
    dev = g_sorted.device
    if dev.type == "cpu" and t_cmp_sorted.device.type == "cpu":
        return planner_tables_plain(g_sorted, t_cmp_sorted, model_bits,
                                    n0b=n0b, pmax=pmax, bw=bw, oma=oma)
    if t_cmp_sorted.device != dev or dev.type != "cuda":
        raise ValueError("planner_tables takes tensors on one CUDA device "
                         "(or CPU tensors)")
    if g_sorted.dtype != torch.float32 \
            or t_cmp_sorted.dtype != torch.float32:
        raise ValueError("planner_tables takes fp32 gains and times")
    lead, c, mb = _prepare(g_sorted, t_cmp_sorted, model_bits)
    table = torch.empty((*lead, c, c), dtype=torch.bfloat16, device=dev)
    row_min = torch.empty((*lead, c), dtype=torch.float32, device=dev)
    t_sw = torch.empty(lead, dtype=torch.float32, device=dev)
    batch = t_sw.numel()
    if batch == 0 or c == 0:
        return table, row_min, t_sw.zero_()
    g, ldg = _rows(g_sorted, batch, c)
    t, ldt = _rows(t_cmp_sorted, batch, c)
    mb = mb.reshape(batch)  # a scalar S stays a stride-0 view
    code = build.load().repro_planner(
        g.data_ptr(), ldg, t.data_ptr(), ldt, mb.data_ptr(), mb.stride(0),
        table.data_ptr(), row_min.data_ptr(), t_sw.data_ptr(), batch, c,
        _consts(n0b, pmax, bw)[1], int(oma), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    build.count_launch(planner_tables)
    build.check(code, "planner")
    return table, row_min, t_sw


planner_tables.launches = 0
