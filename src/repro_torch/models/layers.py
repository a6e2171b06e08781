"""Core transformer layers: RMSNorm, RoPE, sinusoid positions, GQA
attention (direct, sliding window, prefix-LM, KV-cache decode), gated MLP.

Counterpart of ``src/repro/models/layers.py`` (``rms_norm``,
``rope_angles``/``apply_rope``, ``sinusoid_pos_emb``,
``qkv_proj``/``out_proj``,
``_pick_chunk``, ``_direct_attention``, ``flash_attention``,
``decode_attention``,
``init_kv_cache``, ``cache_write``, the GLU MLP). Weights keep the
reference's ``(in, out)`` layout and are applied as ``x @ W``, so
converting the reference's parameters is a plain copy (convert.py).

Attention without a window follows the reference's two paths. Up to
``sq * skv <= 65536`` it is the direct path (``direct_attention``, the
reference's ``_direct_attention``): q scaled in fp32, fp32 scores and
softmax, output cast back to q's dtype. Above, it is the chunked path
(``chunked_attention``, the reference's ``flash_attention`` body): Q
blocks of ``DEFAULT_QCHUNK`` rows run over KV blocks of
``DEFAULT_KVCHUNK`` keys (``_pick_chunk``) with a running max, sum and
accumulator in fp32, so no (B, H, Sq, Skv) score tensor is built. It
skips KV blocks that no query of the block sees (above the causal
diagonal and past the prefix, or behind the window), whose share is
exactly zero, and masks only the blocks that cross an edge, each with
one comparison against a relative-position tile built once a call. The
fully-masked-row guard (a row that has seen no key yet has a running max
of -inf) runs only where such a row can occur: with a window, or a
causal query before key 0 (Sq > Skv). Under
autograd each Q block is a ``torch.utils.checkpoint`` region, as the
reference's ``jax.checkpoint(q_block)``: the backward recomputes one Q
block's scores at a time. The running max is a constant to autograd
(the softmax's gradient does not depend on it). It is plain PyTorch, as
the reference computes it in ``jnp`` outside any Pallas kernel.

With a window (the hybrid family's prefill, the windowed prefill of the
others), causal ``flash_attention`` calls ``ops.swa``, the prefix-LM band
included: the CUDA sliding-window kernel for CUDA tensors, the same direct
math with the band for CPU tensors. Non-causal attention (the encoder's,
and cross-attention over the encoder memory, whose lengths differ) takes
the direct or the chunked path by its size.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.swa import attention_plain

DEFAULT_QCHUNK = 1024
DEFAULT_KVCHUNK = 1024
DIRECT_MAX_PAIRS = 256 * 256     # the reference's switch to the chunked path


def remat_call(fn, *args, remat: bool, **kwargs):
    """``fn(*args, **kwargs)``; with ``remat`` under autograd, as a
    ``torch.utils.checkpoint`` region whose activations the backward
    recomputes (the reference's ``jax.checkpoint`` of a layer body). A
    no-op under ``torch.no_grad()``."""
    if remat and torch.is_grad_enabled():
        # the layers draw no random numbers: no RNG state to keep
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kwargs)
    return fn(*args, **kwargs)


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


def _pick_chunk(s: int, target: int) -> int:
    """Largest divisor of ``s`` that is <= target (prefix-extended lengths
    such as 16,384 + 256 included)."""
    c = min(target, s)
    while s % c != 0:
        c -= 1
    return c


def _block_drop(q_lo: int, k0: int, rel, kcol, *, causal: bool,
                window: int, prefix_len: int):
    """The (Cq, Ck) mask of the pairs to drop between the queries at
    positions q_lo .. q_lo + Cq - 1 and the keys k0 .. k0 + Ck - 1, or None
    when it keeps every pair. ``rel`` (Cq, Ck) = i - j and ``kcol`` (1, Ck)
    = j are the row and column indices in a block, built once a call.
    Query q sees key k when (k <= q or k < prefix_len) and k > q - window;
    which edges the block crosses is decided from host ints (no device
    read)."""
    cq, ck = rel.shape
    d = k0 - q_lo
    cut_causal = causal and k0 + ck - 1 > q_lo and k0 + ck - 1 >= prefix_len
    cut_window = window > 0 and d <= cq - 1 - window
    drop = None
    if cut_causal:
        drop = rel < d                              # k > q
        if k0 < prefix_len:
            drop = drop & (kcol >= prefix_len - k0)
    if cut_window:
        behind = rel >= window + d                  # k <= q - window
        drop = behind if drop is None else drop | behind
    return drop


def _sees_block(q_lo: int, q_hi: int, k0: int, ck: int, *, causal: bool,
                window: int, prefix_len: int) -> bool:
    """False when no query in q_lo .. q_hi sees a key of k0 .. k0 + ck - 1
    (the block's share of every row is then exactly zero)."""
    if causal and k0 > q_hi and k0 >= prefix_len:
        return False
    return not (window > 0 and k0 + ck - 1 <= q_lo - window)


def _q_block(qb, kf, vf, rel, kcol, *, q0: int, offset: int, causal: bool,
             window: int, prefix_len: int, softcap: float):
    """One Q block over the KV blocks it sees, by the running softmax.
    qb (B, KH, G, Cq, hd) scaled fp32; kf, vf (B, KH, Skv, hd) fp32 ->
    (B, KH, G, Cq, hd) fp32.

    A row that has seen no key yet has a running max of -inf, which the
    fully-masked-row guard shifts by 0. Without a window every row sees a
    key of the first block it visits (key 0, a prefix key, or every key
    when not causal) unless a causal query lies before key 0 (Sq > Skv):
    otherwise the guard is left out, its result being the max itself."""
    b, kh, g, cq, hd = qb.shape
    ck = rel.shape[1]
    qm = qb.reshape(b, kh, g * cq, hd)
    q_lo = q0 + offset
    guard = window > 0 or (causal and q_lo < 0 and prefix_len == 0)
    acc = m = l = None
    for k0 in range(0, kf.shape[2], ck):
        if not _sees_block(q_lo, q_lo + cq - 1, k0, ck, causal=causal,
                           window=window, prefix_len=prefix_len):
            continue
        s = (qm @ kf[:, :, k0:k0 + ck].transpose(-1, -2)).view(
            b, kh, g, cq, ck)
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        drop = _block_drop(q_lo, k0, rel, kcol, causal=causal,
                           window=window, prefix_len=prefix_len)
        if drop is not None:
            s = s.masked_fill(drop, float("-inf"))
        m_blk = s.detach().amax(dim=-1)
        m_new = m_blk if m is None else torch.maximum(m, m_blk)
        # a row masked so far has max -inf: shift it by 0 (its p is 0)
        m_safe = (torch.where(torch.isfinite(m_new), m_new, 0.0) if guard
                  else m_new)
        p = torch.exp(s - m_safe[..., None])
        pv = (p.view(b, kh, g * cq, ck) @ vf[:, :, k0:k0 + ck]).view(
            b, kh, g, cq, hd)
        if m is None:
            acc, l = pv, p.sum(dim=-1)
        else:
            corr = torch.exp(m - m_safe)        # exp(-inf) = 0 for such rows
            acc = acc * corr[..., None] + pv
            l = l * corr + p.sum(dim=-1)
        m = m_new
    if acc is None:
        return torch.zeros_like(qb)
    return acc / torch.clamp(l, min=1e-30)[..., None]


def chunked_attention(q, k, v, cfg: ModelConfig, *, causal: bool = True,
                      window: int = 0, prefix_len: int = 0,
                      q_chunk: int = DEFAULT_QCHUNK,
                      kv_chunk: int = DEFAULT_KVCHUNK):
    """Running-softmax attention over Q and KV blocks (the reference's
    chunked ``flash_attention``), the masks of ``direct_attention``.
    q (B,Sq,H,hd), k/v (B,Skv,KH,hd) -> (B,Sq,H,hd) in q's dtype."""
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    cq, ck = _pick_chunk(sq, q_chunk), _pick_chunk(skv, kv_chunk)
    scale = 1.0 / math.sqrt(hd)
    qf = (q.reshape(b, sq, kh, g, hd).float() * scale).permute(
        0, 2, 3, 1, 4)                                  # (B,KH,G,Sq,hd)
    kf = k.float().transpose(1, 2).contiguous()         # (B,KH,Skv,hd)
    vf = v.float().transpose(1, 2).contiguous()
    kcol = torch.arange(ck, device=q.device)[None, :]
    rel = torch.arange(cq, device=q.device)[:, None] - kcol
    remat = any(t.requires_grad for t in (q, k, v))
    outs = [remat_call(_q_block, qf[:, :, :, q0:q0 + cq], kf, vf, rel, kcol,
                       remat=remat, q0=q0, offset=skv - sq, causal=causal,
                       window=window, prefix_len=prefix_len,
                       softcap=cfg.logit_softcap)
            for q0 in range(0, sq, cq)]
    out = torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4)  # (B,Sq,KH,G,hd)
    return out.reshape(b, sq, h, hd).to(q.dtype)


def flash_attention(q, k, v, cfg: ModelConfig, *, causal: bool = True,
                    window: int = 0, prefix_len: int = 0):
    """Full-sequence attention; with ``causal``, keys j < ``prefix_len``
    are seen by every query (prefix-LM). ``window`` > 0 (causal) keeps keys
    j > i - window and goes through ``ops.swa``; otherwise the direct path
    up to ``DIRECT_MAX_PAIRS`` (query, key) pairs and the chunked path
    above, as the reference switches."""
    if window > 0 and causal:
        return ops.swa(q, k, v, window=window, softcap=cfg.logit_softcap,
                       prefix=prefix_len)
    if q.shape[1] * k.shape[1] <= DIRECT_MAX_PAIRS:
        return direct_attention(q, k, v, cfg, causal=causal, window=window,
                                prefix_len=prefix_len)
    return chunked_attention(q, k, v, cfg, causal=causal, window=window,
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
