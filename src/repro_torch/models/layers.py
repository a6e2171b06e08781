"""Core transformer layers: RMSNorm, RoPE, sinusoid positions, GQA
attention (direct, sliding window, prefix-LM, KV-cache decode), gated MLP.

Counterpart of ``src/repro/models/layers.py`` (``rms_norm``,
``rope_angles``/``apply_rope``, ``sinusoid_pos_emb``,
``qkv_proj``/``out_proj``,
``_direct_attention``, ``flash_attention``, ``decode_attention``,
``init_kv_cache``, ``cache_write``, the GLU MLP). Weights keep the
reference's ``(in, out)`` layout and are applied as ``x @ W``, so
converting the reference's parameters is a plain copy (convert.py).

Attention without a window is the reference's direct path
(``_direct_attention``): q scaled in fp32, fp32 scores and softmax, output
cast back to q's dtype. The reference takes that path whenever
``sq * skv <= 65536`` and a chunked online softmax above; the port uses the
direct path at every length, the same function summed in another order.
With a window (the hybrid family's prefill, the windowed prefill of the
others), causal ``flash_attention`` calls ``ops.swa``, the prefix-LM band
included: the CUDA sliding-window kernel for CUDA tensors, the same direct
math with the band for CPU tensors. Non-causal attention (the encoder's,
and cross-attention over the encoder memory, whose lengths differ) is the
direct path.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.swa import attention_plain


def rms_norm(x, weight, eps: float = 1e-5):
    """RMSNorm computed in fp32 and cast back to x's dtype."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dt)


def rope_angles(positions, rot_dim: int, theta: float):
    """positions (...,) int -> cos, sin (..., rot_dim // 2) fp32."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, rot_dim, 2, dtype=torch.float32, device=positions.device)
        / rot_dim))
    ang = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin, rope_frac: float):
    """x (..., S, H, hd); cos/sin (..., S, rot//2). Rotates the first
    ``rope_frac * hd`` dims, half-split convention; cos and sin are cast
    to x's dtype before the multiply, as in the reference."""
    if rope_frac <= 0.0:
        return x
    hd = x.shape[-1]
    rot = int(hd * rope_frac)
    rot -= rot % 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot.chunk(2, dim=-1)
    c = cos[..., None, :].to(x.dtype)     # add head axis
    s = sin[..., None, :].to(x.dtype)
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return torch.cat([out, x_pass], dim=-1)


def sinusoid_pos_emb(positions, d_model: int):
    """Additive sinusoid embedding of the NoPE families (rope_frac 0 and
    encdec): positions (...,) -> (..., d_model) fp32, sines then
    cosines."""
    half = d_model // 2
    freq = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def add_positions(x, start: int = 0):
    """x (B, S, D) plus the sinusoid embedding of positions start ..
    start + S - 1, cast to x's dtype."""
    pos = torch.arange(start, start + x.shape[1], device=x.device)
    return x + sinusoid_pos_emb(pos, x.shape[-1])[None].to(x.dtype)


def direct_attention(q, k, v, cfg: ModelConfig, *, causal: bool = True,
                     window: int = 0, prefix_len: int = 0):
    """q (B,Sq,H,hd), k/v (B,Skv,KH,hd) -> (B,Sq,H,hd) in q's dtype."""
    return attention_plain(q, k, v, causal=causal, window=window,
                           softcap=cfg.logit_softcap, prefix_len=prefix_len)


def flash_attention(q, k, v, cfg: ModelConfig, *, causal: bool = True,
                    window: int = 0, prefix_len: int = 0):
    """Full-sequence attention; with ``causal``, keys j < ``prefix_len``
    are seen by every query (prefix-LM). ``window`` > 0 (causal) keeps keys
    j > i - window and goes through ``ops.swa``."""
    if window > 0 and causal:
        return ops.swa(q, k, v, window=window, softcap=cfg.logit_softcap,
                       prefix=prefix_len)
    return direct_attention(q, k, v, cfg, causal=causal, window=window,
                            prefix_len=prefix_len)


def decode_attention(q, k_cache, v_cache, valid_mask, cfg: ModelConfig):
    """Single-token attention against a (ring or linear) KV cache.
    q (B,1,H,hd); k_cache/v_cache (B,S,KH,hd); valid_mask (B,S) bool.
    Returns (B,1,H,hd) in q's dtype."""
    b, _, h, hd = q.shape
    kh = cfg.n_kv_heads
    g = h // kh
    scale = 1.0 / math.sqrt(hd)
    qf = q.reshape(b, 1, kh, g, hd).float() * scale
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k_cache.float())
    if cfg.logit_softcap > 0.0:
        s = cfg.logit_softcap * torch.tanh(s / cfg.logit_softcap)
    s = s.masked_fill(~valid_mask[:, None, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                  dtype, device):
    """Stacked-over-layers cache; positions start at -1 (invalid)."""
    kh, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((n_layers, batch, max_len, kh, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((n_layers, batch, max_len, kh, hd), dtype=dtype,
                         device=device),
        "pos": torch.full((n_layers, batch, max_len), -1, dtype=torch.int32,
                          device=device),
    }


def cache_write(cache_k, cache_v, cache_pos, k_new, v_new, pos: int,
                ring: bool):
    """Write one token (B,1,KH,hd) at absolute position ``pos``; ring=True
    wraps modulo the cache length, else the slot is clamped to the last.
    Writes in place (the reference returns new arrays) and returns the
    three tensors."""
    max_len = cache_k.shape[1]
    slot = pos % max_len if ring else min(pos, max_len - 1)
    cache_k[:, slot] = k_new[:, 0]
    cache_v[:, slot] = v_new[:, 0]
    cache_pos[:, slot] = pos
    return cache_k, cache_v, cache_pos


def _weight(*shape, dtype, device):
    return nn.Parameter(torch.empty(*shape, dtype=dtype, device=device))


class Attention(nn.Module):
    """GQA attention block: wq (d, H*hd), wk/wv (d, KH*hd), wo (H*hd, d)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.head_dim
        qd, kvd = cfg.n_heads * hd, cfg.n_kv_heads * hd
        self.wq = _weight(d, qd, dtype=dtype, device=device)
        self.wk = _weight(d, kvd, dtype=dtype, device=device)
        self.wv = _weight(d, kvd, dtype=dtype, device=device)
        self.wo = _weight(qd, d, dtype=dtype, device=device)
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.zeros(qd, dtype=dtype, device=device))
            self.bk = nn.Parameter(torch.zeros(kvd, dtype=dtype, device=device))
            self.bv = nn.Parameter(torch.zeros(kvd, dtype=dtype, device=device))

    def qkv_proj(self, x):
        """x (B,S,D) -> q (B,S,H,hd), k/v (B,S,KH,hd)."""
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = x @ self.wq, x @ self.wk, x @ self.wv
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        return (q.reshape(b, s, cfg.n_heads, cfg.head_dim),
                k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim),
                v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim))

    def out_proj(self, attn_out):
        b, s = attn_out.shape[:2]
        return attn_out.reshape(b, s, -1) @ self.wo

    def forward(self, x, cos, sin, *, window: int = 0, prefix_len: int = 0):
        """Full-sequence attention (``_attn_seq`` of the reference).
        Returns (out (B,S,D), (k, v) post-RoPE)."""
        cfg = self.cfg
        q, k, v = self.qkv_proj(x)
        q = apply_rope(q, cos, sin, cfg.rope_frac)
        k = apply_rope(k, cos, sin, cfg.rope_frac)
        out = flash_attention(q, k, v, cfg, causal=True, window=window,
                              prefix_len=prefix_len)
        return self.out_proj(out), (k, v)


class MLP(nn.Module):
    """Gated (SwiGLU) MLP, or a plain tanh-GELU MLP when ``glu`` is off."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.glu = cfg.glu
        d, f = cfg.d_model, cfg.d_ff
        self.wi = _weight(d, f, dtype=dtype, device=device)
        if cfg.glu:
            self.wg = _weight(d, f, dtype=dtype, device=device)
        self.wo = _weight(f, d, dtype=dtype, device=device)

    def forward(self, x):
        if self.glu:
            h = F.silu(x @ self.wg) * (x @ self.wi)
        else:
            h = F.gelu(x @ self.wi, approximate="tanh")
        return h @ self.wo
