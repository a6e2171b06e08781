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

The sharding half (``ShardingPolicy``, ``POLICIES``, ``policy_for``,
``MeshInfo``, ``resolve_specs``, ``specs_with_dims``, ``batch_shapes``,
``batch_specs``, ``cache_specs``) is the reference's logical-axis
resolution (``src/repro/models/zoo.py:35-180``, ``:379-429``), used by the
dry run (launch/dryrun.py). A ``PartitionSpec`` becomes a tuple with one
entry a dim: None, a mesh-axis name, or a tuple of names (the batch axes
of a multi-pod mesh); ``placements`` turns one into DTensor ``Placement``s
of a ``DeviceMesh``. A ``ShapeDtypeStruct`` becomes a ``ShapeDtype``.
``param_specs`` gives each parameter's logical axes under the names
convert.py uses: the reference's spec tree, which ``init_model`` returns
beside the parameters, without its stacked leading ``"layers"`` axis (the
port keeps one module a layer). The caches keep the stacked layout, so
``cache_specs`` keeps it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models.encdec import EncDecLM, init_encdec_cache
from repro_torch.models.layers import Ring
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
                for g in grads:          # the accumulators: no second copy
                    g.div_(microbatches)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.copy_((p.float() - lr * g.float()).to(p.dtype))
            gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        return {"loss": loss, "grad_norm": gnorm}

    return step


def make_prefill_step(cfg: ModelConfig, *, window: int = 0, ring=None):
    """Returns prefill(model, batch) -> (last_logits (B, V), cache); the
    batch carries ``prefix`` (vlm) or ``frames`` (encdec) beside
    ``tokens``. ``window`` > 0 prefills with sliding-window attention (the
    hybrid family takes ``cfg.long_context_window`` for 0).

    ``ring``: (mesh, batch_axis, seq_axis) of a ``DeviceMesh`` over the
    default process group, for context-parallel ring attention (the
    reference's ``make_prefill_step(ring=)``). Every rank passes the whole
    batch and takes its batch shard. The dense and moe families without
    a window or a prefix also take their sequence chunk and run the ring
    (``layers.ring_flash_attention``); the others run their batch shard
    over the whole sequence, as the reference's GSPMD program computes
    the same values with or without the ring. The last logits (from the
    last sequence rank) and the cache come back as DTensors on the
    mesh."""

    @torch.no_grad()
    def prefill(model, batch: dict):
        if ring is not None:
            return _ring_prefill(cfg, model, batch, window, Ring(*ring))
        logits, cache = _run(cfg, model, batch, window=window,
                             collect_cache=True, last_only=True)
        return logits[:, -1, :], cache

    return prefill


def _ring_prefill(cfg: ModelConfig, model, batch: dict, window: int,
                  ring: Ring):
    """``make_prefill_step(ring=)``'s step on this rank."""
    from torch.distributed._functional_collectives import all_gather_tensor
    bi, nb = ring.coord(ring.batch_axis)
    si, ns = ring.coord(ring.seq_axis)
    b, s = batch["tokens"].shape
    if b % nb:
        raise ValueError(f"ring prefill: a batch of {b} does not split over "
                         f"{nb} batch ranks")
    rows = slice(bi * (b // nb), (bi + 1) * (b // nb))
    local = {k: v[rows] for k, v in batch.items()}
    seq_ring = (cfg.family in ("dense", "moe") and not window
                and "prefix" not in batch)
    if not seq_ring:
        logits, cache = _run(cfg, model, local, window=window,
                             collect_cache=True, last_only=True)
        return (ring.shard(logits[:, -1, :], ("batch", None)),
                {k: ring.shard(v, (None, "batch") + (None,) * (v.dim() - 2))
                 for k, v in cache.items()})
    if s % ns:
        raise ValueError(f"ring prefill: S={s} does not split over {ns} "
                         f"sequence ranks")
    chunk = local["tokens"][:, si * (s // ns):(si + 1) * (s // ns)]
    logits, cache = model(chunk, collect_cache=True, last_only=True,
                          ring=ring)
    # every sequence rank's last position; the sequence's last is the
    # last sequence rank's
    seq_dim = ring.mesh.mesh_dim_names.index(ring.seq_axis)
    last = all_gather_tensor(logits[:, -1, :][None], 0,
                             (ring.mesh, seq_dim))[ns - 1]
    return (ring.shard(last, ("batch", None)),
            {k: ring.shard(v, (None, "batch", "seq") + (None,) * (v.dim() - 3))
             for k, v in cache.items()})


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


# ---------------------------------------------------------------------------
# sharding: per-arch policy and logical-axis resolution
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    fsdp: bool = False
    # gradient-accumulation microbatches per input shape
    microbatches: Any = dataclasses.field(default_factory=dict)

    def micro_for(self, shape_name: str) -> int:
        return self.microbatches.get(shape_name, 1)


POLICIES: dict[str, ShardingPolicy] = {
    "smollm_135m": ShardingPolicy(microbatches={"train_4k": 2}),
    "stablelm_1_6b": ShardingPolicy(microbatches={"train_4k": 4}),
    "chatglm3_6b": ShardingPolicy(microbatches={"train_4k": 8}),
    "paligemma_3b": ShardingPolicy(microbatches={"train_4k": 2}),
    "hymba_1_5b": ShardingPolicy(microbatches={"train_4k": 4}),
    "seamless_m4t_medium": ShardingPolicy(microbatches={"train_4k": 2}),
    "rwkv6_7b": ShardingPolicy(microbatches={"train_4k": 8}),
    "moonshot_v1_16b_a3b": ShardingPolicy(fsdp=True,
                                          microbatches={"train_4k": 8}),
    "llama4_maverick_400b_a17b": ShardingPolicy(
        fsdp=True, microbatches={"train_4k": 16}),
    "grok_1_314b": ShardingPolicy(fsdp=True, microbatches={"train_4k": 16}),
}


def policy_for(cfg: ModelConfig) -> ShardingPolicy:
    return POLICIES.get(cfg.name, ShardingPolicy())


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    axis_names: tuple        # e.g. ("pod","data","model") or ("data","model")
    axis_sizes: dict         # name -> size

    @property
    def batch_axes(self):
        return tuple(a for a in self.axis_names if a != "model")

    @property
    def model_size(self) -> int:
        return self.axis_sizes.get("model", 1)

    @property
    def batch_size_total(self) -> int:
        out = 1
        for a in self.batch_axes:
            out *= self.axis_sizes[a]
        return out

    def batch_axis(self):
        """The batch dims' entry of a spec: the one batch axis, or the
        tuple of them."""
        bx = self.batch_axes
        return bx if len(bx) > 1 else bx[0]

    def shards(self, spec) -> int:
        """How many pieces a tensor of resolved ``spec`` is cut into."""
        return math.prod(self.axis_sizes[a] for entry in spec
                         for a in spec_axes(entry))


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """A tensor's shape and dtype, with no data (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


def spec_axes(entry) -> tuple:
    """The mesh axes of one entry of a resolved spec: none, one name or a
    tuple of names."""
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def _divisible(dim: Optional[int], n: int) -> bool:
    return dim is not None and n > 0 and dim % n == 0


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def resolve_specs(spec_tree, cfg: ModelConfig, mesh: MeshInfo,
                  policy: ShardingPolicy, dims_tree=None):
    """Map logical-axis-name tuples (a leaf, or a dict of them) to resolved
    specs: a tuple of None, a mesh-axis name or a tuple of names a dim.

    ``dims_tree``: the matching shapes (for divisibility checks); if None,
    divisibility is checked from static cfg fields."""
    msize = mesh.model_size
    bsize = mesh.batch_size_total

    expert_on_model = _divisible(cfg.n_experts, msize)
    kvheads_on_model = _divisible(cfg.n_kv_heads, msize)
    vocab_on_model = _divisible(cfg.padded_vocab, msize)

    def name_to_axis(name, dim=None):
        if name is None or name == "layers":
            return None
        if name == "batch":
            return mesh.batch_axis() if _divisible(dim, bsize) else None
        if name in ("qdim", "kvdim", "mlp", "mlp_d", "heads_d", "expert_mlp",
                    "embed2"):
            if name == "expert_mlp" and expert_on_model:
                return None  # experts already consume the model axis
            return "model" if _divisible(dim, msize) else None
        if name == "expert":
            return "model" if expert_on_model else None
        if name == "vocab":
            return "model" if vocab_on_model else None
        if name == "kvheads":
            return "model" if kvheads_on_model else None
        if name == "kvseq":
            if kvheads_on_model:
                return None  # KV heads already consume the model axis
            return "model" if _divisible(dim, msize) else None
        if name == "rwkv_heads":
            return "model" if _divisible(
                cfg.d_model // max(cfg.rwkv_head_size, 1), msize) else None
        if name == "embed":
            if policy.fsdp and _divisible(dim, bsize):
                return mesh.batch_axis()
            return None
        if name == "embed_act":
            return None
        raise ValueError(f"unknown logical axis {name!r}")

    def resolve_one(names, dims=None):
        return tuple(name_to_axis(nm, None if dims is None else dims[i])
                     for i, nm in enumerate(names))

    if _is_spec(spec_tree):
        return resolve_one(spec_tree, dims_tree)
    return {k: resolve_specs(v, cfg, mesh, policy,
                             None if dims_tree is None else dims_tree[k])
            for k, v in spec_tree.items()}


def specs_with_dims(shapes: dict, spec_tree: dict, cfg: ModelConfig,
                    mesh: MeshInfo, policy: ShardingPolicy) -> dict:
    """Resolve specs using the tensors' shapes (``ShapeDtype``, tensors or
    shape tuples, keyed as ``spec_tree``) for divisibility checks, so that
    e.g. a 9-head q-proj falls back to replicated."""
    if set(shapes) != set(spec_tree):
        raise ValueError(f"shapes and specs name different tensors: "
                         f"{sorted(set(shapes) ^ set(spec_tree))}")
    out = {}
    for name, spec in spec_tree.items():
        dims = tuple(getattr(shapes[name], "shape", shapes[name]))
        if len(dims) != len(spec):
            raise ValueError(f"{name}: spec {spec} for shape {dims}")
        out[name] = resolve_specs(spec, cfg, mesh, policy, dims_tree=dims)
    return out


def placements(spec, mesh) -> tuple:
    """DTensor placements on ``mesh`` (a ``DeviceMesh`` with named dims)
    of a resolved spec: ``Shard(i)`` on each mesh dim that dim i of the
    tensor is split over (a tuple entry splits over several, in order),
    ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    where = {a: i for i, entry in enumerate(spec) for a in spec_axes(entry)}
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh.mesh_dim_names)


# logical axes of each parameter (the reference's init specs,
# ``layers.py:117-138, 440-457``, ``moe.py:21-36``, ``ssm.py:20-46``,
# ``rwkv.py:30-71``), by the module that holds it
_ATTN = {"wq": ("embed", "qdim"), "wk": ("embed", "kvdim"),
         "wv": ("embed", "kvdim"), "wo": ("qdim", "embed"),
         "bq": ("qdim",), "bk": ("kvdim",), "bv": ("kvdim",)}
_MODULE_SPECS = {
    "attn": _ATTN,
    "xattn": _ATTN,
    "mlp": {"wi": ("embed", "mlp"), "wg": ("embed", "mlp"),
            "wo": ("mlp", "embed")},
    "moe": {"router": ("embed", None),
            "wi": ("expert", "embed", "expert_mlp"),
            "wg": ("expert", "embed", "expert_mlp"),
            "wo": ("expert", "expert_mlp", "embed")},
    "ssm": {"win": ("embed", "mlp_d"), "wbc": ("embed", None),
            "wdt": ("embed", None), "wdt2": (None, "mlp_d"),
            "a_log": ("mlp_d", None), "d_skip": ("mlp_d",),
            "wout": ("mlp_d", "embed"), "dt_bias": ("mlp_d",)},
    "tm": {"mu": (None, "embed"), "wr": ("embed", "heads_d"),
           "wk": ("embed", "heads_d"), "wv": ("embed", "heads_d"),
           "wg": ("embed", "heads_d"), "wo": ("heads_d", "embed"),
           "w0": ("heads_d",), "wa": ("embed", None),
           "wb": (None, "heads_d"), "u": ("rwkv_heads", None),
           "ln_w": ("heads_d",)},
    "cm": {"mu": (None, "embed"), "wk": ("embed", "mlp"),
           "wv": ("mlp", "embed"), "wr": ("embed", "embed2")},
}
# the block norms and the top-level tensors (transformer.py:31-89,
# encdec.py:50-79)
_BLOCK_NORMS = ("ln1", "ln2", "lnx", "ln_attn_o", "ln_ssm_o")
_TOP_SPECS = {"embed": ("vocab", "embed"), "lm_head": ("embed", "vocab"),
              "norm_f": ("embed",), "enc_norm": ("embed",),
              "prefix_proj": (None, "embed"),
              "frontend_proj": (None, "embed")}


def _param_spec(name: str) -> tuple:
    parts = name.split(".")
    if len(parts) == 1 and name in _TOP_SPECS:
        return _TOP_SPECS[name]
    if parts[0] in ("blocks", "enc_blocks", "dec_blocks"):
        rest = parts[2:]
        if len(rest) == 1 and rest[0] in _BLOCK_NORMS:
            return ("embed",)
        if len(rest) == 2 and rest[1] in _MODULE_SPECS.get(rest[0], ()):
            return _MODULE_SPECS[rest[0]][rest[1]]
    raise ValueError(f"no logical axes for parameter {name!r}")


def param_specs(cfg: ModelConfig, model=None) -> dict:
    """{parameter name: logical axes} of the model of ``cfg`` (``model``,
    or one built on the meta device), in ``named_parameters`` order."""
    if model is None:
        model = build_model(cfg, torch.device("meta"))
    return {name: _param_spec(name) for name, _ in model.named_parameters()}


def param_shapes(model) -> dict:
    """{parameter name: ``ShapeDtype``} of ``model``."""
    return {name: ShapeDtype(tuple(p.shape), p.dtype)
            for name, p in model.named_parameters()}


def cache_specs(cfg: ModelConfig) -> dict:
    """Logical axes of the decode cache's tensors (the stacked layout,
    leading ``"layers"`` axis; ``transformer.py:389``,
    ``encdec.py:205``)."""
    kv = {"k": ("layers", "batch", "kvseq", "kvheads", None),
          "v": ("layers", "batch", "kvseq", "kvheads", None),
          "pos": ("layers", "batch", "kvseq")}
    if cfg.family == "encdec":
        return kv | {"xk": ("layers", "batch", None, "kvheads", None),
                     "xv": ("layers", "batch", None, "kvheads", None)}
    if cfg.family == "ssm":
        return {"tm_shift": ("layers", "batch", "embed_act"),
                "cm_shift": ("layers", "batch", "embed_act"),
                "wkv": ("layers", "batch", "rwkv_heads", None, None)}
    if cfg.family == "hybrid":
        return kv | {"ssm_h": ("layers", "batch", "embed_act", None)}
    return kv


def batch_shapes(cfg: ModelConfig, shape) -> dict:
    """Input shapes of a (arch, input shape) pair (``shape`` a
    ``configs.ShapeConfig``). train/prefill: {tokens, labels, weight [,
    prefix | frames]} (prefill without labels and weight); decode: {token}
    (the cache is built separately)."""
    b, s = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    if shape.kind in ("train", "prefill"):
        out = {"tokens": ShapeDtype((b, s), torch.int32),
               "labels": ShapeDtype((b, s), torch.int32),
               "weight": ShapeDtype((b,), torch.float32)}
        if cfg.family in ("vlm", "encdec"):
            out["prefix" if cfg.family == "vlm" else "frames"] = ShapeDtype(
                (b, cfg.n_prefix_tokens, cfg.prefix_dim), dt)
        if shape.kind == "prefill":
            del out["labels"], out["weight"]
        return out
    return {"token": ShapeDtype((b,), torch.int32)}


def batch_specs(cfg: ModelConfig, shape, mesh: MeshInfo) -> dict:
    """Resolved specs matching ``batch_shapes``: the batch dim over the
    batch axes when divisible, else replicated."""
    baxis = (mesh.batch_axis() if shape.global_batch
             % mesh.batch_size_total == 0 else None)
    return {k: (baxis,) + (None,) * (len(v.shape) - 1)
            for k, v in batch_shapes(cfg, shape).items()}
