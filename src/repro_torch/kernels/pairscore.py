"""Closed-form NOMA pair power allocation + SIC rate scoring.

Counterpart of ``src/repro/kernels/pairscore.py`` (``_pair_math``,
``solo_rate_math``, ``pairscore_pallas``, ``pair_rate_tables``,
``completion_table``, ``effective_power_table``).

``pairscore`` is the wrapper of the hand-written CUDA kernel
``csrc/pairscore.cu``, which replaces the TPU kernel ``_pairscore_kernel``
(src/repro/kernels/pairscore.py:75). Bound on the H100: 24 bytes moved per
element against ~25 fp32 operations, so the memory rate bounds it; the
kernel is one flat pass, one element per thread, masked tail, no padding.

``pair_math`` is the plain PyTorch version: the reference's expression in
the reference's order (conjugate root, ``max(g_j, 1e-30)``,
``log1p(..) / LN2``), so fp32 rounding tracks the JAX twin. The wrapper
takes it only for CPU tensors; for CUDA tensors it launches the kernel or
raises. ``pair_rate_tables`` and ``completion_table`` (the fp32 table of
the joint enumeration) score their broadcast grids through the
``pairscore`` wrapper; ``effective_power_table`` is plain tensor ops, as
the reference computes it in XLA.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import build

LN2 = 0.6931471805599453


def pair_math(g_i, g_j, *, n0b: float, pmax: float, bw: float,
              oma: bool = False):
    """(p_i, p_j, r_i, r_j) for strong/weak gain tensors, elementwise."""
    if oma:
        p_i = torch.full_like(g_i, pmax)
        p_j = torch.full_like(g_j, pmax)
        r_i = 0.5 * bw * torch.log1p(pmax * g_i / n0b) / LN2
        r_j = 0.5 * bw * torch.log1p(pmax * g_j / n0b) / LN2
        return p_i, p_j, r_i, r_j
    y = 2.0 * pmax * g_i * n0b / (
        n0b + torch.sqrt(n0b * n0b + 4.0 * pmax * g_i * n0b))
    p_j = torch.clamp(y / torch.clamp(g_j, min=1e-30), max=pmax)
    p_i = torch.full_like(g_i, pmax)
    r_i = bw * torch.log1p(p_i * g_i / (p_j * g_j + n0b)) / LN2
    r_j = bw * torch.log1p(p_j * g_j / n0b) / LN2
    return p_i, p_j, r_i, r_j


def solo_rate_math(g, *, n0b: float, pmax: float, bw: float):
    """Full-subchannel single-user rate (``core.noma.solo_rate``)."""
    return bw * torch.log1p(pmax * g / n0b) / LN2


def pairscore(g_i: torch.Tensor, g_j: torch.Tensor, *, n0b: float,
              pmax: float, bw: float, oma: bool = False
              ) -> Tuple[torch.Tensor, ...]:
    """Fused (p_i, p_j, r_i, r_j) over same-shape fp32 gain tensors: the
    CUDA kernel for CUDA tensors, ``pair_math`` for CPU tensors."""
    if g_i.shape != g_j.shape:
        raise ValueError(f"shape mismatch {tuple(g_i.shape)} vs "
                         f"{tuple(g_j.shape)}")
    if g_i.device.type == "cpu" and g_j.device.type == "cpu":
        return pair_math(g_i.float(), g_j.float(), n0b=n0b, pmax=pmax,
                         bw=bw, oma=oma)
    if g_i.device != g_j.device or g_i.device.type != "cuda":
        raise ValueError("pairscore takes two tensors on one CUDA device "
                         "(or two CPU tensors)")
    if g_i.dtype != torch.float32 or g_j.dtype != torch.float32:
        raise ValueError("pairscore takes fp32 gains")
    gi = g_i.contiguous()
    gj = g_j.contiguous()
    outs = [torch.empty_like(gi) for _ in range(4)]
    n = gi.numel()
    if n == 0:
        return tuple(outs)
    f32 = lambda v: float(np.float32(v))   # the fp32 constant JAX uses
    lib = build.load()
    code = lib.repro_pairscore(
        gi.data_ptr(), gj.data_ptr(), *(o.data_ptr() for o in outs), n,
        f32(2.0 * pmax), f32(4.0 * pmax), f32(pmax), f32(n0b),
        f32(n0b * n0b), f32(bw), f32(0.5 * bw), f32(LN2), f32(1e-30),
        int(oma), gi.device.index,
        torch.cuda.current_stream(gi.device).cuda_stream)
    build.count_launch(pairscore)
    build.check(code, "pairscore")
    return tuple(outs)


pairscore.launches = 0


def pair_rate_tables(g_strong, g_weak, *, n0b: float, pmax: float,
                     bw: float, oma: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., K, N) per-user SIC rate tables (r_i, r_j): entry [k, n] is the
    pair (strong user k, weak user n); one ``pairscore`` call over the
    broadcast grid."""
    k, n = g_strong.shape[-1], g_weak.shape[-1]
    shape = g_strong.shape[:-1] + (k, n)
    gi = g_strong[..., :, None].expand(shape)
    gj = g_weak[..., None, :].expand(shape)
    _, _, r_i, r_j = pairscore(gi, gj, n0b=n0b, pmax=pmax, bw=bw, oma=oma)
    return r_i, r_j


def completion_table(g_sorted, t_cmp_sorted, model_bits, *, n0b: float,
                     pmax: float, bw: float, oma: bool = False
                     ) -> torch.Tensor:
    """(..., c, c) fp32 pair completion-time table over gain-sorted
    candidates: entry [p, q] = max over the two users of T_cmp + S/R with
    rank p strong and rank q weak. ``model_bits`` broadcasts over the
    leading dims."""
    r_i, r_j = pair_rate_tables(g_sorted, g_sorted, n0b=n0b, pmax=pmax,
                                bw=bw, oma=oma)
    mb = torch.as_tensor(model_bits, dtype=torch.float32,
                         device=g_sorted.device)[..., None, None]
    t = t_cmp_sorted
    return torch.maximum(t[..., :, None] + mb / torch.clamp(r_i, min=1e-9),
                         t[..., None, :] + mb / torch.clamp(r_j, min=1e-9))


def effective_power_table(g_strong, g_weak, *, n0b: float,
                          pmax: float) -> torch.Tensor:
    """(..., K, N) table of min(y*(g_i), P g_j): the strictly monotone
    min-rate surrogate whose structural ties are precision-exact (the
    greedy pairing policy's score surface)."""
    y = 2.0 * pmax * g_strong * n0b / (
        n0b + torch.sqrt(n0b * n0b + 4.0 * pmax * g_strong * n0b))
    return torch.minimum(y[..., :, None], pmax * g_weak[..., None, :])
