"""Model dispatch: ``init_model``, ``forward``, ``token_loss``, the train
step builder ``make_train_step`` (with ``effective_microbatches``) and the
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

``make_train_step`` returns a step that takes the gradient of the token
loss over ``microbatches`` contiguous slices of the batch, sums them in
``accum_dtype``, updates the module's parameters in place by an fp32 SGD
step cast back to each parameter's dtype, and returns the loss and the
gradient norm as 0-dim tensors (no host read). Nothing in it falls back:
on the card a gradient through swa or wkv6 (the hybrid and ssm families,
or a dense, moe or vlm model with a window) goes through their backward
kernels (``kernels.swa.swa_bwd``, ``kernels.wkv6.wkv6_bwd``). The
reference's sharding arguments (``param_pspecs``, ``batch_dim_spec``,
``act_model_shard``) are not taken. The serving step builders run under
``torch.no_grad()``; the serving caches are written in place.
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


def forward(cfg: ModelConfig, model, batch, *, remat: bool = True,
            window: int = 0):
    """Returns (logits, aux): aux is the layers' summed MoE load-balance
    loss, 0.0 for a model without experts. ``batch`` is the tokens (B, S)
    or the reference's batch dict (``tokens`` and ``prefix`` or
    ``frames``); a vlm's logits cover the prefix and the text. ``remat``
    recomputes each layer in the backward (a no-op under
    ``torch.no_grad()``); ``window`` > 0 is sliding-window attention (the
    hybrid family takes ``cfg.long_context_window`` for 0)."""
    if not isinstance(batch, dict):
        batch = {"tokens": batch}
    return _run(cfg, model, batch, with_aux=True, remat=remat, window=window)


def effective_microbatches(global_batch: int, micro: int,
                           batch_shards: int) -> int:
    """Largest microbatch count <= ``micro`` such that each microbatch's
    leading dim still divides evenly over ``batch_shards``."""
    micro = max(1, min(micro, global_batch // max(batch_shards, 1)))
    while micro > 1 and (global_batch % micro != 0
                         or (global_batch // micro) % batch_shards != 0):
        micro -= 1
    return micro


def make_train_step(cfg: ModelConfig, *, lr: float = 1e-3,
                    microbatches: int = 1, window: int = 0,
                    remat: bool = True, accum_dtype=torch.float32):
    """Returns step(model, batch) -> {"loss", "grad_norm"} (0-dim fp32
    tensors). ``batch`` holds ``tokens`` and ``labels`` (B, S) (-1 =
    ignore), ``weight`` (B,) per-example weights, and ``prefix`` (vlm) or
    ``frames`` (encdec). With ``microbatches`` > 1 the leading dim (which
    it must divide) is cut into contiguous slices: their gradients are
    summed in ``accum_dtype`` and divided by ``microbatches``, the loss is
    their mean. The step writes p <- (p.float() - lr * g.float()) in p's
    dtype into every parameter of ``model``."""

    def loss_fn(model, mb):
        logits, aux = forward(cfg, model, mb, remat=remat, window=window)
        return token_loss(cfg, logits, mb["labels"], mb.get("weight"), aux)

    def step(model, batch: dict):
        params = list(model.parameters())
        with torch.enable_grad():
            if microbatches == 1:
                loss = loss_fn(model, batch)
                grads = torch.autograd.grad(loss, params)
                loss = loss.detach()
            else:
                b = batch["tokens"].shape[0]
                if b % microbatches:
                    raise ValueError(f"a batch of {b} does not split into "
                                     f"{microbatches} microbatches")
                n = b // microbatches
                grads = [torch.zeros(p.shape, dtype=accum_dtype,
                                     device=p.device) for p in params]
                loss = torch.zeros((), dtype=torch.float32,
                                   device=params[0].device)
                for i in range(microbatches):
                    mb = {name: val[i * n:(i + 1) * n]
                          for name, val in batch.items()}
                    lm = loss_fn(model, mb)
                    for acc, g in zip(grads, torch.autograd.grad(lm, params)):
                        acc.add_(g.to(accum_dtype))
                    loss = loss + lm.detach()
                loss = loss / microbatches
                grads = [g / microbatches for g in grads]
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.copy_((p.float() - lr * g.float()).to(p.dtype))
            gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        return {"loss": loss, "grad_norm": gnorm}

    return step


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
