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
about 30 fp32 operations each; by those counts the bytes bound it, but the
pair math is SFU-heavy (log1p, IEEE divides), so the kernel hoists the
strong user's root out of the column loop and gives each row one warp (see
the source's note).

``planner_tables_plain`` is the plain PyTorch version: ``pair_math`` on
broadcast (c, c) grids, the reductions from fp32, and the bf16 cast last
(round to nearest even, as ``astype(bfloat16)``). The wrapper takes it
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

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


def planner_tables(g_sorted, t_cmp_sorted, model_bits, *, n0b: float,
                   pmax: float, bw: float, oma: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused (table, row_min, t_sw): the CUDA kernel for CUDA tensors,
    ``planner_tables_plain`` for CPU tensors. ``g_sorted`` and
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
    batch = int(np.prod(lead, dtype=np.int64))
    g = g_sorted.reshape(batch, c).contiguous()
    t = t_cmp_sorted.reshape(batch, c).contiguous()
    mb = mb.reshape(batch).contiguous()
    table = torch.empty((batch, c, c), dtype=torch.bfloat16, device=dev)
    row_min = torch.empty((batch, c), dtype=torch.float32, device=dev)
    t_sw = torch.empty((batch,), dtype=torch.float32, device=dev)
    if batch == 0 or c == 0:
        return (table.reshape(*lead, c, c), row_min.reshape(*lead, c),
                torch.zeros(lead, dtype=torch.float32, device=dev))
    anti = torch.empty((batch, max(c // 2, 1)), dtype=torch.float32,
                       device=dev)
    f32 = lambda v: float(np.float32(v))   # the fp32 constant JAX uses
    lib = build.load()
    code = lib.repro_planner(
        g.data_ptr(), t.data_ptr(), mb.data_ptr(), table.data_ptr(),
        row_min.data_ptr(), t_sw.data_ptr(), anti.data_ptr(), batch, c,
        f32(2.0 * pmax), f32(4.0 * pmax), f32(pmax), f32(n0b),
        f32(n0b * n0b), f32(bw), f32(0.5 * bw), f32(LN2), f32(1e-30),
        f32(EPS), int(oma), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    build.count_launch(planner_tables)
    build.check(code, "planner")
    return (table.reshape(*lead, c, c), row_min.reshape(*lead, c),
            t_sw.reshape(lead))


planner_tables.launches = 0
