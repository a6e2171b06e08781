"""Model dispatch: ``init_model``, ``forward``, ``token_loss`` and the
serving step builders ``make_prefill_step``, ``make_serve_step`` and
``init_cache``.

Counterpart of ``src/repro/models/zoo.py`` (every family: the decoder
families through ``transformer.DecoderLM``, encdec through
``encdec.EncDecLM``). ``init_model`` draws every weight from a seeded
``torch.Generator`` on the target device with the reference's law —
truncated normal on [-2, 2] scaled by the fan-in (``layers.dense_init``;
``prefix_proj`` and ``frontend_proj`` by their fan-in ``prefix_dim``),
``d_model ** -0.5`` for the embedding, 1/sqrt(fan-in) for output
projections, 1/sqrt(E) for the experts' (E, D, F) ``wi`` and ``wg`` (the
reference's ``dense_init`` takes ``shape[0]``, here the expert count, as
the fan-in), 1/sqrt(D) for the router and 1/sqrt(F) for the experts'
``wo``, 0.01 for the RWKV decay LoRA's second factor, 0.5 for the
RWKV bonus ``u``, ones for the norms, and the constants the reference sets
(RWKV mu = 0.5, w0 = -1; SSM a_log = log(1..N), d_skip = 1, dt_bias = 0) —
so its numbers differ from the reference's ``jax.random`` draws by design;
the tests load the reference's parameters through convert.py instead.

The step builders are forward-only and run under ``torch.no_grad()``; the
serving caches are written in place.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models.encdec import EncDecLM, init_encdec_cache
from repro_torch.models.transformer import DecoderLM, init_decode_cache


def _fan_in_scale(shape) -> float:
    return 1.0 / math.sqrt(shape[0])


def build_model(cfg: ModelConfig, device):
    """The (uninitialised) module of ``cfg.family``: ``EncDecLM`` for
    encdec, else ``DecoderLM``."""
    return (EncDecLM if cfg.family == "encdec" else DecoderLM)(cfg, device)


def _draw_attention(draw, a):
    """q, k, v by fan-in, wo by 1/sqrt(H hd); the biases keep their 0."""
    for w in (a.wq, a.wk, a.wv):
        draw(w, _fan_in_scale(w.shape))
    draw(a.wo, 1.0 / math.sqrt(a.wo.shape[0]))


def _draw_mlp(draw, f, cfg: ModelConfig):
    """wi, wg by fan-in, wo by 1/sqrt(F)."""
    draw(f.wi, _fan_in_scale(f.wi.shape))
    if cfg.glu:
        draw(f.wg, _fan_in_scale(f.wg.shape))
    draw(f.wo, 1.0 / math.sqrt(f.wo.shape[0]))


@torch.no_grad()
def init_model(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """Build the model of ``cfg.family`` on ``device`` with seeded random
    weights: a ``DecoderLM`` (dense, moe, hybrid, ssm, vlm) or an
    ``EncDecLM`` (encdec)."""
    dev = resolve_device(device)
    model = build_model(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(p, scale):
        w = torch.empty(p.shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        p.copy_((w * scale).to(p.dtype))

    draw(model.embed, cfg.d_model ** -0.5)
    if cfg.family == "encdec":
        draw(model.frontend_proj, _fan_in_scale(model.frontend_proj.shape))
        for blk in [*model.enc_blocks, *model.dec_blocks]:
            _draw_attention(draw, blk.attn)
            if hasattr(blk, "xattn"):
                _draw_attention(draw, blk.xattn)
            _draw_mlp(draw, blk.mlp, cfg)
        draw(model.lm_head, _fan_in_scale(model.lm_head.shape))
        return model
    if cfg.n_prefix_tokens:
        draw(model.prefix_proj, _fan_in_scale(model.prefix_proj.shape))
    for blk in model.blocks:
        if cfg.family == "ssm":
            tm, cm = blk.tm, blk.cm
            for w in (tm.wr, tm.wk, tm.wv, tm.wg, tm.wa, cm.wk, cm.wr):
                draw(w, _fan_in_scale(w.shape))
            draw(tm.wo, 1.0 / math.sqrt(cfg.d_model))
            draw(tm.wb, 0.01)
            draw(tm.u, 0.5)
            draw(cm.wv, 1.0 / math.sqrt(cfg.d_ff))
            continue
        _draw_attention(draw, blk.attn)
        if cfg.family == "hybrid":
            m = blk.ssm
            for w in (m.win, m.wbc, m.wdt, m.wdt2):
                draw(w, _fan_in_scale(w.shape))
            draw(m.wout, 1.0 / math.sqrt(cfg.d_model))
        if cfg.is_moe:
            m = blk.moe
            for w in (m.router, m.wi, m.wg):
                draw(w, _fan_in_scale(w.shape))
            draw(m.wo, 1.0 / math.sqrt(cfg.d_ff))
        else:
            _draw_mlp(draw, blk.mlp, cfg)
    if not cfg.tie_embeddings:
        draw(model.lm_head, _fan_in_scale(model.lm_head.shape))
    return model


def _run(cfg: ModelConfig, model, batch: dict, **kw):
    """The model on the reference's batch dict: ``tokens``, with
    ``frames`` (encdec) or ``prefix`` (vlm)."""
    if cfg.family == "encdec":
        return model(batch["frames"], batch["tokens"], **kw)
    return model(batch["tokens"], batch.get("prefix"), **kw)


def forward(cfg: ModelConfig, model, batch):
    """Returns (logits, aux): aux is the layers' summed MoE load-balance
    loss, 0.0 for a model without experts. ``batch`` is the tokens (B, S)
    or the reference's batch dict (``tokens`` and ``prefix`` or
    ``frames``); a vlm's logits cover the prefix and the text."""
    if not isinstance(batch, dict):
        batch = {"tokens": batch}
    return _run(cfg, model, batch, with_aux=True)


def make_prefill_step(cfg: ModelConfig, *, window: int = 0):
    """Returns prefill(model, batch) -> (last_logits (B, V), cache); the
    batch carries ``prefix`` (vlm) or ``frames`` (encdec) beside
    ``tokens``. ``window`` > 0 prefills with sliding-window attention (the
    hybrid family takes ``cfg.long_context_window`` for 0)."""

    @torch.no_grad()
    def prefill(model, batch: dict):
        logits, cache = _run(cfg, model, batch, window=window,
                             collect_cache=True, last_only=True)
        return logits[:, -1, :], cache

    return prefill


def make_serve_step(cfg: ModelConfig, *, ring: bool = False):
    """Returns serve(model, cache, token, pos) -> (next_token, logits,
    cache). Greedy decode; ``cache`` is updated in place."""
    del cfg

    @torch.no_grad()
    def serve(model, cache: dict, token, pos: int):
        logits, cache = model.decode(cache, token, int(pos), ring=ring)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, logits, cache

    return serve


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    """Empty stacked decode cache on ``device`` (the card by default);
    encdec's also holds the cross ``xk``, ``xv``."""
    init = init_encdec_cache if cfg.family == "encdec" else init_decode_cache
    return init(cfg, batch, max_len, getattr(torch, cfg.dtype),
                resolve_device(device))


def token_loss(cfg: ModelConfig, logits, labels, weights=None,
               aux=0.0, aux_coeff: float = 0.01):
    """Per-token next-token CE; ``labels`` (B, S) with -1 = ignore;
    ``weights`` (B,) per-example weights. A vlm's logits cover [prefix +
    text]: the text slice is taken, so logits[:, P + i] predicts
    labels[:, i]."""
    if cfg.n_prefix_tokens and cfg.family == "vlm":
        logits = logits[:, cfg.n_prefix_tokens:, :]
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
