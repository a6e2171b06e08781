"""Mamba-style selective SSM branch (the Hymba hybrid heads).

Counterpart of ``src/repro/models/ssm.py`` (``init_ssm``, ``_ssm_coeffs``,
``ssm_scan``, ``ssm_step``). The time-varying linear recurrence
h_t = a_t * h_{t-1} + b_t is evaluated with the reference's ``combine``
(a2 * a1, a2 * b1 + b2) as a log-depth Hillis-Steele doubling scan over the
sequence axis (12 passes at S = 4096), not token by token: the reference
runs it as an XLA ``associative_scan``, not in a Pallas kernel, so it stays
plain PyTorch. The two trees sum in another order, which moves the result
by fp32 rounding only.

The scan has two forms of the same passes in the same order, so their
outputs are bitwise equal. Serving (no autograd) overwrites ``a`` and
``b`` in place: hymba's (2, 4096, 1600, 16) fp32 coefficients make a
copy a pass costly. Under autograd, with an input that needs a gradient,
each pass builds new tensors from the untouched head and the combined
tail (``torch.cat``), so autograd can go back through it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig


class SSM(nn.Module):
    """Selective-SSM branch on the full residual width: win (D,D), wbc
    (D,2N), wdt (D,D/16), wdt2 (D/16,D), a_log (D,N), d_skip (D,), wout
    (D,D), dt_bias (D,)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, n = cfg.d_model, cfg.ssm_state
        dt_rank = max(1, d // 16)

        def w(*shape, dt=dtype):
            return nn.Parameter(torch.empty(*shape, dtype=dt, device=device))

        self.win = w(d, d)
        self.wbc = w(d, 2 * n)
        self.wdt = w(d, dt_rank)
        self.wdt2 = w(dt_rank, d)
        self.a_log = nn.Parameter(torch.log(torch.arange(
            1, n + 1, dtype=torch.float32, device=device)).repeat(d, 1))
        self.d_skip = nn.Parameter(torch.ones(d, device=device))
        self.wout = w(d, d)
        self.dt_bias = nn.Parameter(torch.zeros(d, device=device))


def _ssm_coeffs(p: SSM, x):
    """x (B,S,D) -> a (B,S,D,N), bx (B,S,D,N), c (B,S,N), u (B,S,D)."""
    u = x @ p.win
    bc = (x @ p.wbc).float()
    n = bc.shape[-1] // 2
    b_in, c = bc[..., :n], bc[..., n:]
    dt = (x @ p.wdt) @ p.wdt2
    dt = F.softplus(dt.float() + p.dt_bias)                       # (B,S,D)
    a = -torch.exp(p.a_log)                                       # (D,N)
    da = torch.exp(dt[..., None] * a)                             # (B,S,D,N)
    # Euler-discretized input term
    bx = dt[..., None] * b_in[..., None, :] * u.float()[..., None]
    return da, bx, c, u


def _doubling_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t over axis 1 (h_{-1} = 0)
    by Hillis-Steele doubling: pass j combines each element with the one
    2^j steps back, (a2, b2) <- (a2 * a1, a2 * b1 + b2). Returns h. Under
    autograd (an input needs a gradient) the passes build new tensors;
    otherwise they overwrite ``a`` and ``b`` and h is ``b``."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _doubling_scan_autograd(a, b)
    s = a.shape[1]
    off = 1
    while off < s:
        last = 2 * off >= s
        # the right side is formed before either tensor is overwritten
        tmp = a[:, off:] * b[:, :-off]
        b[:, off:] += tmp
        del tmp
        if not last:
            tmp = a[:, off:] * a[:, :-off]
            a[:, off:] = tmp
            del tmp
        off *= 2
    return b


def _doubling_scan_autograd(a, b):
    """``_doubling_scan``'s passes out of place: the head ``[:, :off]``
    stays, the tail is combined into a new tensor."""
    s = a.shape[1]
    off = 1
    while off < s:
        b = torch.cat([b[:, :off], b[:, off:] + a[:, off:] * b[:, :-off]],
                      dim=1)
        if 2 * off < s:
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def ssm_scan(p: SSM, x):
    """Full-sequence selective scan. x (B,S,D) -> (y (B,S,D), h_T (B,D,N))."""
    da, bx, c, u = _ssm_coeffs(p, x)
    h = _doubling_scan(da, bx)
    del da
    y = torch.einsum("bsdn,bsn->bsd", h, c)
    h_last = h[:, -1].clone()
    del h, bx
    uf = u.float()
    y = y + uf * p.d_skip
    y = y * F.silu(uf)                                  # gated output
    return (y @ p.wout.float()).to(x.dtype), h_last


def ssm_step(p: SSM, x, h_prev):
    """Single decode step. x (B,1,D); h_prev (B,D,N) -> (y (B,1,D), h)."""
    da, bx, c, u = _ssm_coeffs(p, x)
    h = da[:, 0] * h_prev + bx[:, 0]                    # (B,D,N)
    y = torch.einsum("bdn,bn->bd", h, c[:, 0])
    uf = u[:, 0].float()
    y = y + uf * p.d_skip
    y = y * F.silu(uf)
    return (y @ p.wout.float()).to(x.dtype)[:, None], h

