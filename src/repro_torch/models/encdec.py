"""Encoder-decoder assembly (the encdec family, seamless-m4t): a
bidirectional encoder over stubbed frontend frame embeddings and a causal
decoder with cross-attention.

Counterpart of ``src/repro/models/encdec.py`` (``init_encdec``,
``encode``, ``_cross_kv``, ``_cross_attend``, ``encdec_forward``,
``init_encdec_cache``, ``encdec_decode``), with its parameter names:
``frontend_proj`` (prefix_dim, D), ``enc_blocks`` (``ln1``, ``attn``,
``ln2``, ``mlp``), ``enc_norm``, ``embed``, ``dec_blocks`` (``ln1``,
``attn``, ``lnx``, ``xattn``, ``ln2``, ``mlp``), ``norm_f`` and
``lm_head``; convert.py unstacks the reference's ``enc_blocks`` and
``dec_blocks`` onto the two ``ModuleList``s.

No rotary positions anywhere: the encoder's input and the decoder's token
embeddings each take the additive sinusoid embedding of their own
positions. The encoder's self-attention and the cross-attention over its
output (the memory) are non-causal direct attention; the decoder's
self-attention is causal, and with a ``window`` > 0 goes through
``ops.swa`` as the decoder families' does. The prefill cache carries each
decoder layer's self k, v and pos and its cross ``xk``, ``xv`` (the
memory's projections, fixed for the whole decode). The speech frontend is
a stub, as in the reference: ``frames`` are (B, P, prefix_dim)
embeddings. ``forward(remat=True)`` runs each encoder and decoder layer
as a ``torch.utils.checkpoint`` region under autograd, the reference's
``jax.checkpoint(body)`` of both layer scans.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import unembed


def _norm(cfg: ModelConfig, device):
    return nn.Parameter(torch.ones(cfg.d_model, device=device))


class EncBlock(nn.Module):
    """Pre-norm bidirectional self-attention + MLP."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _norm(cfg, device)
        self.attn = L.Attention(cfg, dtype, device)
        self.ln2 = _norm(cfg, device)
        self.mlp = L.MLP(cfg, dtype, device)

    def forward(self, x):
        cfg = self.cfg
        q, k, v = self.attn.qkv_proj(L.rms_norm(x, self.ln1, cfg.norm_eps))
        x = x + self.attn.out_proj(L.flash_attention(q, k, v, cfg,
                                                     causal=False))
        return x + self.mlp(L.rms_norm(x, self.ln2, cfg.norm_eps))


class DecBlock(nn.Module):
    """Pre-norm causal self-attention, cross-attention over the memory,
    MLP."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _norm(cfg, device)
        self.attn = L.Attention(cfg, dtype, device)
        self.lnx = _norm(cfg, device)
        self.xattn = L.Attention(cfg, dtype, device)
        self.ln2 = _norm(cfg, device)
        self.mlp = L.MLP(cfg, dtype, device)

    def cross_kv(self, memory):
        """The memory (B, P, D) -> its cross k, v (B, P, KH, hd)
        (``_cross_kv``)."""
        cfg, p = self.cfg, self.xattn
        b, s, _ = memory.shape
        k = (memory @ p.wk).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        v = (memory @ p.wv).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        if cfg.qkv_bias:
            k = k + p.bk.reshape(cfg.n_kv_heads, cfg.head_dim)
            v = v + p.bv.reshape(cfg.n_kv_heads, cfg.head_dim)
        return k, v

    def cross_attend(self, x, mem_k, mem_v):
        """``_cross_attend``: non-causal attention of x over the memory."""
        cfg, p = self.cfg, self.xattn
        b, s, _ = x.shape
        q = (x @ p.wq).reshape(b, s, cfg.n_heads, cfg.head_dim)
        if cfg.qkv_bias:
            q = q + p.bq.reshape(cfg.n_heads, cfg.head_dim)
        return p.out_proj(L.flash_attention(q, mem_k, mem_v, cfg,
                                            causal=False))

    def forward(self, x, memory, *, window: int = 0):
        """Returns (x_out, self (k, v), cross (xk, xv))."""
        cfg = self.cfg
        q, k, v = self.attn.qkv_proj(L.rms_norm(x, self.ln1, cfg.norm_eps))
        x = x + self.attn.out_proj(L.flash_attention(q, k, v, cfg,
                                                     causal=True,
                                                     window=window))
        mk, mv = self.cross_kv(memory)
        x = x + self.cross_attend(L.rms_norm(x, self.lnx, cfg.norm_eps), mk,
                                  mv)
        return x + self.mlp(L.rms_norm(x, self.ln2, cfg.norm_eps)), (k, v), \
            (mk, mv)

    def decode(self, x, cache: dict, pos: int, *, ring: bool):
        """One layer, one new token, against this layer's slices of the
        self cache (written in place) and the fixed cross k, v. As in the
        reference, the one-token cross query takes no ``bq``."""
        cfg = self.cfg
        q, k, v = self.attn.qkv_proj(L.rms_norm(x, self.ln1, cfg.norm_eps))
        ck, cv, cp = L.cache_write(cache["k"], cache["v"], cache["pos"], k, v,
                                   pos, ring)
        valid = cp >= 0
        if ring and cfg.long_context_window:
            valid = valid & (cp > pos - cfg.long_context_window)
        x = x + self.attn.out_proj(L.decode_attention(q, ck, cv, valid, cfg))
        hx = L.rms_norm(x, self.lnx, cfg.norm_eps)
        b = x.shape[0]
        qx = (hx @ self.xattn.wq).reshape(b, 1, cfg.n_heads, cfg.head_dim)
        xvalid = torch.ones((b, cache["xk"].shape[1]), dtype=torch.bool,
                            device=x.device)
        x = x + self.xattn.out_proj(L.decode_attention(
            qx, cache["xk"], cache["xv"], xvalid, cfg))
        return x + self.mlp(L.rms_norm(x, self.ln2, cfg.norm_eps))


class EncDecLM(nn.Module):
    """frames -> encoder -> memory; tokens -> decoder (self + cross) ->
    RMSNorm -> lm_head."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"EncDecLM builds the encdec family, not "
                             f"{cfg.family!r}")
        dtype = getattr(torch, cfg.dtype)
        self.cfg = cfg
        d = cfg.d_model
        self.frontend_proj = nn.Parameter(torch.empty(
            cfg.prefix_dim, d, dtype=dtype, device=device))
        self.enc_blocks = nn.ModuleList(
            EncBlock(cfg, dtype, device) for _ in range(cfg.n_enc_layers))
        self.enc_norm = _norm(cfg, device)
        self.embed = nn.Parameter(torch.empty(
            cfg.padded_vocab, d, dtype=dtype, device=device))
        self.dec_blocks = nn.ModuleList(
            DecBlock(cfg, dtype, device) for _ in range(cfg.n_layers))
        self.norm_f = _norm(cfg, device)
        self.lm_head = nn.Parameter(torch.empty(
            d, cfg.padded_vocab, dtype=dtype, device=device))

    def encode(self, frames, *, remat: bool = True):
        """frames (B, P, prefix_dim) -> memory (B, P, D)."""
        cfg = self.cfg
        x = L.add_positions(frames.to(self.frontend_proj.dtype)
                            @ self.frontend_proj)
        for blk in self.enc_blocks:
            x = L.remat_call(blk, x, remat=remat)
        return L.rms_norm(x, self.enc_norm, cfg.norm_eps)

    def forward(self, frames, tokens, *, window: int = 0,
                collect_cache: bool = False, last_only: bool = False,
                with_aux: bool = False, remat: bool = True):
        """frames (B, P, prefix_dim), tokens (B, S) -> logits (B, S,
        padded_vocab) (``last_only``: (B, 1, V)) [, the stacked cache: k,
        v, pos (S) and xk, xv (P)] [, aux 0.0]. ``window`` > 0 is
        sliding-window self-attention in the decoder; ``remat`` recomputes
        each layer in the backward (a no-op under ``torch.no_grad()``)."""
        cfg = self.cfg
        memory = self.encode(frames, remat=remat)
        x = L.add_positions(self.embed[tokens])
        caches: dict = {}

        def put(name, i, val):
            if name not in caches:
                caches[name] = val.new_empty((cfg.n_layers, *val.shape))
            caches[name][i] = val

        for i, blk in enumerate(self.dec_blocks):
            x, (k, v), (mk, mv) = L.remat_call(blk, x, memory,
                                               window=window, remat=remat)
            if collect_cache:
                for name, val in (("k", k), ("v", v), ("xk", mk),
                                  ("xv", mv)):
                    put(name, i, val)
        if collect_cache:
            b, s = tokens.shape
            caches["pos"] = torch.arange(
                s, dtype=torch.int32, device=tokens.device).expand(
                cfg.n_layers, b, s).contiguous()
        if last_only:
            x = x[:, -1:]
        out = (unembed(self, x),)
        if collect_cache:
            out += (caches,)
        if with_aux:
            out += (0.0,)
        return out if len(out) > 1 else out[0]

    def decode(self, cache: dict, token, pos: int, *, ring: bool = False):
        """One decode step (``encdec_decode``) against the self cache and the
        fixed cross k, v. token (B,) int; ``pos`` the absolute position.
        Updates ``cache`` in place; returns (logits (B, V), cache)."""
        x = L.add_positions(self.embed[token][:, None, :], pos)
        for i, blk in enumerate(self.dec_blocks):
            x = blk.decode(x, {name: val[i] for name, val in cache.items()},
                           pos, ring=ring)
        return unembed(self, x[:, 0, :]), cache


def init_encdec_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      device):
    """Stacked decode cache: the self k, v, pos (max_len) and the cross
    xk, xv (``n_prefix_tokens``), zeros until a prefill places them."""
    nl, kh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    cache = L.init_kv_cache(cfg, batch, max_len, nl, dtype, device)
    for name in ("xk", "xv"):
        cache[name] = torch.zeros((nl, batch, cfg.n_prefix_tokens, kh, hd),
                                  dtype=dtype, device=device)
    return cache
