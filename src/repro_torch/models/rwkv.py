"""RWKV-6 "Finch" blocks: time-mix with data-dependent decay + channel-mix.

Counterpart of ``src/repro/models/rwkv.py`` (``init_rwkv_time_mix``,
``init_rwkv_channel_mix``, ``wkv6_step``, ``_shift``, ``_mix``,
``_head_groupnorm``, ``time_mix``, ``time_mix_step``, ``channel_mix``,
``channel_mix_step``). The full-sequence WKV recurrence goes through
``ops.wkv6`` (the reference's ``wkv6_chunked``, chunk ``WKV_CHUNK``): the
CUDA kernel for CUDA tensors, the same chunked formulas in plain PyTorch
for CPU tensors. Decode steps use the plain one-token recurrence
``wkv6_step``.

As in the reference, the token-shift mixing coefficients for r/k/v/g are
static learned vectors and the data-dependent LoRA defines the per-token
decay w_t.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

WKV_CHUNK = 128


def _param(*shape, dtype, device):
    return nn.Parameter(torch.empty(*shape, dtype=dtype, device=device))


class TimeMix(nn.Module):
    """mu (5,D) fp32; wr, wk, wv, wg, wo (D,D); w0 (D,) fp32; wa (D,lora),
    wb (lora,D); u (H,hs) fp32; ln_w (D,) fp32."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, hs = cfg.d_model, cfg.rwkv_head_size
        lora = max(32, d // 64)
        self.mu = nn.Parameter(torch.full((5, d), 0.5, device=device))
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, _param(d, d, dtype=dtype, device=device))
        self.w0 = nn.Parameter(torch.full((d,), -1.0, device=device))
        self.wa = _param(d, lora, dtype=dtype, device=device)
        self.wb = _param(lora, d, dtype=dtype, device=device)
        self.u = _param(d // hs, hs, dtype=torch.float32, device=device)
        self.ln_w = nn.Parameter(torch.ones(d, device=device))


class ChannelMix(nn.Module):
    """mu (2,D) fp32; wk (D,F), wv (F,D), wr (D,D)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.mu = nn.Parameter(torch.full((2, d), 0.5, device=device))
        self.wk = _param(d, f, dtype=dtype, device=device)
        self.wv = _param(f, d, dtype=dtype, device=device)
        self.wr = _param(d, d, dtype=dtype, device=device)


def wkv6_step(r, k, v, w_log, u, s):
    """Single decode step: r,k,v,w_log (B,H,C); s (B,H,C,C) fp32."""
    rf, kf, vf = r.float(), k.float(), v.float()
    out = torch.einsum("bhc,bhcd->bhd", rf, s) \
        + torch.einsum("bhc,hc,bhc,bhd->bhd", rf, u.float(), kf, vf)
    s_new = torch.exp(w_log.float())[..., None] * s \
        + kf[..., None] * vf[..., None, :]
    return out, s_new


def _shift(x, prev):
    """Token shift: per-position previous token. x (B,S,D), prev (B,D) =
    last token of the previous segment."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


def _head_groupnorm(x, w, n_heads: int, eps: float = 64e-5):
    """x (B,S,D) normalised per head group, in fp32."""
    b, s, d = x.shape
    xh = x.reshape(b, s, n_heads, d // n_heads).float()
    mean = xh.mean(dim=-1, keepdim=True)
    var = xh.var(dim=-1, keepdim=True, unbiased=False)
    xh = (xh - mean) * torch.rsqrt(var + eps)
    return xh.reshape(b, s, d) * w.float()


def _decay(p: TimeMix, xw):
    """log w_t = -exp(clip(w0 + tanh(x W_a) W_b, -8, 4)), <= 0, fp32."""
    wt = p.w0 + (torch.tanh(xw @ p.wa) @ p.wb).float()
    return -torch.exp(torch.clamp(wt, -8.0, 4.0))


def time_mix(p: TimeMix, x, cfg: ModelConfig, shift_prev, wkv_state, *,
             chunk: int = WKV_CHUNK):
    """x (B,S,D). Returns (out, new_shift (B,D), new_wkv_state)."""
    b, s, d = x.shape
    hs = cfg.rwkv_head_size
    h = d // hs
    xs = _shift(x, shift_prev)
    xr, xk, xv, xw, xg = (_mix(x, xs, p.mu[i]) for i in range(5))

    def heads(z):
        return z.reshape(b, s, h, hs).transpose(1, 2)     # (B,H,S,C)

    r = heads(xr @ p.wr)
    k = heads(xk @ p.wk)
    v = heads(xv @ p.wv)
    g = xg @ p.wg
    w_log = heads(_decay(p, xw))
    out, s_new = ops.wkv6(r, k, v, w_log, p.u, wkv_state, chunk=chunk)
    out = out.transpose(1, 2).reshape(b, s, d)            # (B,S,D)
    out = _head_groupnorm(out, p.ln_w, h)
    out = (out * F.silu(g.float())).to(x.dtype)
    return out @ p.wo, x[:, -1, :], s_new


def time_mix_step(p: TimeMix, x, cfg: ModelConfig, shift_prev, wkv_state):
    """Decode: x (B,1,D)."""
    b, _, d = x.shape
    hs = cfg.rwkv_head_size
    h = d // hs
    xs = shift_prev[:, None, :]
    xr, xk, xv, xw, xg = (_mix(x, xs, p.mu[i])[:, 0] for i in range(5))
    r = (xr @ p.wr).reshape(b, h, hs)
    k = (xk @ p.wk).reshape(b, h, hs)
    v = (xv @ p.wv).reshape(b, h, hs)
    g = xg @ p.wg
    w_log = _decay(p, xw).reshape(b, h, hs)
    out, s_new = wkv6_step(r, k, v, w_log, p.u, wkv_state)
    out = _head_groupnorm(out.reshape(b, 1, d), p.ln_w, h)
    out = (out * F.silu(g.float())[:, None]).to(x.dtype)
    return out @ p.wo, x[:, 0, :], s_new


def channel_mix(p: ChannelMix, x, shift_prev):
    """x (B,S,D). Returns (out, new_shift (B,D))."""
    xs = _shift(x, shift_prev)
    xk = _mix(x, xs, p.mu[0])
    xr = _mix(x, xs, p.mu[1])
    k = torch.square(torch.relu(xk @ p.wk))
    return torch.sigmoid((xr @ p.wr).float()).to(x.dtype) * (k @ p.wv), \
        x[:, -1, :]


def channel_mix_step(p: ChannelMix, x, shift_prev):
    """Decode: x (B,1,D)."""
    xs = shift_prev[:, None, :]
    xk = _mix(x, xs, p.mu[0])
    xr = _mix(x, xs, p.mu[1])
    k = torch.square(torch.relu(xk @ p.wk))
    return torch.sigmoid((xr @ p.wr).float()).to(x.dtype) * (k @ p.wv), \
        x[:, 0, :]
