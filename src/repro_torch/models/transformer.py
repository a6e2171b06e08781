"""Decoder-LM assembly of the dense family.

Counterpart of ``src/repro/models/transformer.py``: block init
(``_init_block``/``init_decoder``), ``block_seq``, ``embed_inputs``, the
tied ``unembed`` with the padded-vocab mask, and ``decoder_forward``. The
reference stacks the layers on a leading axis and scans over them; here
each layer is its own module in a ``ModuleList`` (convert.py unstacks).
Norm weights are fp32, as in the reference, whatever the model dtype.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


class Block(nn.Module):
    """Pre-norm attention + MLP layer (``block_seq`` of the reference)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.eps = cfg.norm_eps
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, device=device))
        self.attn = L.Attention(cfg, dtype, device)
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, device=device))
        self.mlp = L.MLP(cfg, dtype, device)

    def forward(self, x, cos, sin):
        x = x + self.attn(L.rms_norm(x, self.ln1, self.eps), cos, sin)
        return x + self.mlp(L.rms_norm(x, self.ln2, self.eps))


class DecoderLM(nn.Module):
    """Dense decoder LM: embed -> blocks -> RMSNorm -> (tied) unembed."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        if cfg.family != "dense" or cfg.is_moe or cfg.n_prefix_tokens:
            raise NotImplementedError(
                f"model family {cfg.family!r} is ROADMAP queue 4; the port "
                f"builds the dense family")
        if cfg.rope_frac <= 0.0 or cfg.sliding_window:
            raise NotImplementedError(
                "NoPE and sliding-window dense variants are ROADMAP queue 4")
        dtype = getattr(torch, cfg.dtype)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(
            cfg.padded_vocab, cfg.d_model, dtype=dtype, device=device))
        self.blocks = nn.ModuleList(
            Block(cfg, dtype, device) for _ in range(cfg.n_layers))
        self.norm_f = nn.Parameter(torch.ones(cfg.d_model, device=device))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(
                cfg.d_model, cfg.padded_vocab, dtype=dtype, device=device))

    def unembed(self, x):
        cfg = self.cfg
        x = L.rms_norm(x, self.norm_f, cfg.norm_eps)
        logits = x @ (self.embed.T if cfg.tie_embeddings else self.lm_head)
        if cfg.padded_vocab != cfg.vocab_size:
            mask = torch.where(
                torch.arange(cfg.padded_vocab, device=x.device)
                < cfg.vocab_size, 0.0, -1e9).to(logits.dtype)
            logits = logits + mask
        return logits

    def forward(self, tokens):
        """tokens (B, S) int -> logits (B, S, padded_vocab)."""
        cfg = self.cfg
        x = self.embed[tokens]
        rot = int(cfg.head_dim * cfg.rope_frac)
        rot -= rot % 2
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        cos, sin = L.rope_angles(positions, rot, cfg.rope_theta)
        for blk in self.blocks:
            x = blk(x, cos, sin)
        return self.unembed(x)
