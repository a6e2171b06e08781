"""Capacity-based top-k Mixture-of-Experts (Switch/GShard-style dispatch).

Counterpart of ``src/repro/models/moe.py`` (``init_moe``, ``moe_capacity``,
``apply_moe``), with its parameter names and layouts: ``router`` (D, E)
fp32, ``wi`` and ``wg`` (E, D, F), ``wo`` (E, F, D), so convert.py carries
the reference's tree across with no new case.

The router is fp32: softmax over the experts, top-k, the k gates
renormalised to sum to 1. Each (token, choice) takes a place in its
expert's queue, every token's choice 0 before any token's choice 1; a
place at or past the capacity ``moe_capacity(tokens)`` drops the choice
(its gate is 0 and the residual carries the token). The reference counts
the places with a cumulative sum down the (k * T, E) one-hot; here a
stable sort of the choices by expert gives the same integers (on an H100
that column scan took 1.15 s of a 1.83 s moonshot prefill at T=16,384).
The capacity is set by the tokens of the call, so a prefill and a
one-token decode step route the same token differently once tokens drop.
The kept rows are scattered into an (E * cap + 1, D) buffer whose last
row takes every dropped one; each real slot receives at most one row, so
the scatter is exact in any order. The three expert products run batched
over (E, cap, .), and each token sums its k gathered rows weighted by
their gates in x's dtype.

``moe_shard_hints`` of the reference is a mesh hint with no meaning on
one card, and is not ported.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig


def moe_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Queue length of each expert for a call over ``n_tokens`` tokens."""
    cap = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                        * cfg.capacity_factor))
    return max(cap, cfg.top_k)


class MoE(nn.Module):
    """The expert MLPs of one layer and their router."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = nn.Parameter(torch.empty(d, e, dtype=torch.float32,
                                               device=device))
        self.wi = nn.Parameter(torch.empty(e, d, f, dtype=dtype,
                                           device=device))
        self.wg = nn.Parameter(torch.empty(e, d, f, dtype=dtype,
                                           device=device))
        self.wo = nn.Parameter(torch.empty(e, f, d, dtype=dtype,
                                           device=device))

    def forward(self, x):
        return apply_moe(self, x, self.cfg)


def _count(idx, n: int):
    """Occurrences of 0 .. n-1 in ``idx`` (``bincount`` reads its max back
    to the host on a CUDA tensor; this stays on the device)."""
    return torch.zeros(n, dtype=idx.dtype, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))


def queue_positions(gate_idx, n_experts: int):
    """gate_idx (T, k) -> (T, k): the place of each (token, choice) in its
    expert's queue, every token's choice 0 before any token's choice 1,
    i.e. its rank among its expert's choices in that order."""
    t, k = gate_idx.shape
    flat = gate_idx.T.reshape(k * t)
    order = torch.argsort(flat, stable=True)
    counts = _count(flat, n_experts)
    first = torch.cumsum(counts, dim=0) - counts
    pos = torch.empty_like(flat)
    pos[order] = torch.arange(k * t, device=flat.device) - first[flat[order]]
    return pos.reshape(k, t).T


def apply_moe(p: MoE, x, cfg: ModelConfig):
    """x (B, S, D) -> (out (B, S, D) in x's dtype, Switch load-balance aux
    loss, a 0-dim fp32 tensor)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    cap = moe_capacity(t, cfg)

    xt = x.reshape(t, d)
    probs = torch.softmax(xt.float() @ p.router, dim=-1)       # (T, E)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)         # (T, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    pos = queue_positions(gate_idx, e)                         # (T, k)
    keep = pos < cap

    # Switch load-balance loss (eq. 4): top-1 density times mean router prob
    density = _count(gate_idx[:, 0], e).float() / t
    aux = (density * probs.mean(dim=0)).sum() * e

    gate_vals = torch.where(keep, gate_vals, 0.0)
    slot = torch.where(keep, gate_idx * cap + pos, e * cap)    # (T, k)
    src = xt[:, None, :].expand(t, k, d).reshape(t * k, d)
    xin = torch.zeros((e * cap + 1, d), dtype=x.dtype,
                      device=x.device).index_add(0, slot.reshape(-1), src)
    xin = xin[:e * cap].reshape(e, cap, d)                     # (E, C, D)

    h = F.silu(torch.bmm(xin, p.wg)) * torch.bmm(xin, p.wi)
    xout = torch.bmm(h, p.wo)                                  # (E, C, D)

    gathered = xout[gate_idx, torch.clamp(pos, max=cap - 1)]   # (T, k, D)
    gathered = torch.where(keep[..., None], gathered, 0.0)
    out = (gathered * gate_vals[..., None].to(x.dtype)).sum(dim=1)
    return out.reshape(b, s, d), aux
