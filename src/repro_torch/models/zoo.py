"""Model dispatch: ``init_model``, ``forward`` and ``token_loss``.

Counterpart of ``src/repro/models/zoo.py`` (dense family). ``init_model``
draws every weight from a seeded ``torch.Generator`` on the target device
with the reference's law — truncated normal on [-2, 2] scaled by the
fan-in (``layers.dense_init``), ``d_model ** -0.5`` for the embedding,
ones for the norms — so its numbers differ from the reference's
``jax.random`` draws by design; the tests load the reference's parameters
through convert.py instead.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models.transformer import DecoderLM


def _fan_in_scale(shape) -> float:
    return 1.0 / math.sqrt(shape[0])


@torch.no_grad()
def init_model(cfg: ModelConfig, *, seed: int = 0,
               device="cuda") -> DecoderLM:
    """Build the dense decoder on ``device`` with seeded random weights."""
    dev = resolve_device(device)
    model = DecoderLM(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(p, scale):
        w = torch.empty(p.shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        p.copy_((w * scale).to(p.dtype))

    draw(model.embed, cfg.d_model ** -0.5)
    for blk in model.blocks:
        a, f = blk.attn, blk.mlp
        for w in (a.wq, a.wk, a.wv):
            draw(w, _fan_in_scale(w.shape))
        draw(a.wo, 1.0 / math.sqrt(a.wo.shape[0]))
        draw(f.wi, _fan_in_scale(f.wi.shape))
        if cfg.glu:
            draw(f.wg, _fan_in_scale(f.wg.shape))
        draw(f.wo, 1.0 / math.sqrt(f.wo.shape[0]))
    if not cfg.tie_embeddings:
        draw(model.lm_head, _fan_in_scale(model.lm_head.shape))
    return model


def forward(cfg: ModelConfig, model: DecoderLM, tokens):
    """Returns (logits, aux); aux is 0 for the dense family."""
    del cfg  # the model carries its config
    return model(tokens), 0.0


def token_loss(cfg: ModelConfig, logits, labels, weights=None,
               aux=0.0, aux_coeff: float = 0.01):
    """Per-token next-token CE; ``labels`` (B, S) with -1 = ignore;
    ``weights`` (B,) per-example weights."""
    del cfg
    logits = logits.float()
    mask = labels >= 0
    lab = torch.clamp(labels, min=0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lab[..., None])[..., 0]
    nll = (logz - gold) * mask
    per_ex = nll.sum(dim=-1) / torch.clamp(mask.sum(dim=-1), min=1)
    if weights is None:
        loss = per_ex.mean()
    else:
        w = weights.float()
        loss = (per_ex * w).sum() / torch.clamp(w.sum(), min=1e-9)
    return loss + aux_coeff * aux
