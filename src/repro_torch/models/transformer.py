"""Decoder-LM assembly of the dense, moe, hybrid, ssm (RWKV6) and vlm
families.

Counterpart of ``src/repro/models/transformer.py``: block init
(``_init_block``/``init_decoder``), ``block_seq``, ``block_decode``,
``embed_inputs``, ``unembed`` with the padded-vocab mask,
``_init_seq_states``, ``decoder_forward`` (with ``collect_cache`` and
``last_only``), ``decoder_decode`` and ``init_decode_cache``. The reference
stacks the layers on a leading axis and scans over them; here each layer is
its own module in a ``ModuleList`` (convert.py unstacks). Caches keep the
reference's stacked layout (a leading layer axis); decode writes them in
place and returns the same dict. Norm weights are fp32, as in the
reference, whatever the model dtype.

The moe family is the dense block with ``moe`` (models/moe.py) in the
place of ``mlp``; ``forward`` sums the layers' load-balance losses.

``forward(ring=)`` is the context-parallel prefill of the dense and moe
families (the ring branch of the reference's ``_attn_seq``): this rank's
sequence chunk at its global positions, attention by
``layers.ring_flash_attention``, the MoE's queue places as over the whole
batch (``moe.apply_moe(ring=)``).

The vlm family (paligemma) is the dense decoder with a ``prefix_proj``
(prefix_dim, D): ``forward(tokens, prefix=)`` projects the prefix (the
stubbed image patches) and puts it before the text, runs positions
0..P+S-1, and every attention sees the first P positions bidirectionally
(the prefix-LM band; ``layers.flash_attention(prefix_len=)``). A config
without rotary positions (rope_frac 0, NoPE) adds the sinusoid embedding
to the inputs instead, at every position in ``forward`` and at ``pos`` in
``decode``. The encdec family is ``models/encdec.py``.

Full-sequence attention takes the ``window`` of ``forward`` (the
reference's ``decoder_forward(window=)``): 0 is causal attention over the
whole prefix, a window > 0 goes through the sliding-window kernel. The
hybrid family takes ``cfg.long_context_window`` when the window is 0. The
decode applies the window only with a ring cache (``ring=True``), as the
reference does: on a linear cache every cached position is attended.

``forward(remat=True)`` runs each layer as a ``torch.utils.checkpoint``
region under autograd (``layers.remat_call``), the reference's
``jax.checkpoint(body)`` of the layer scan: the backward keeps only each
layer's input and recomputes the rest.

``cfg.sliding_window`` is read by no model code of the reference, so the
port builds a config that sets it and ignores it too.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as RWKV
from repro_torch.models import ssm as SSM

FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm")


def _rope_dim(cfg: ModelConfig) -> int:
    rot = int(cfg.head_dim * cfg.rope_frac)
    return rot - rot % 2


class Block(nn.Module):
    """Pre-norm attention + MLP layer (``block_seq`` of the reference); the
    hybrid family adds a parallel SSM branch and mean-fuses the normed
    outputs of the two; the moe family's MLP is the expert layer."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.eps = cfg.norm_eps
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, device=device))
        self.attn = L.Attention(cfg, dtype, device)
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, device=device))
        if cfg.family == "hybrid":
            self.ssm = SSM.SSM(cfg, dtype, device)
            self.ln_attn_o = nn.Parameter(torch.ones(cfg.d_model,
                                                     device=device))
            self.ln_ssm_o = nn.Parameter(torch.ones(cfg.d_model,
                                                    device=device))
        if cfg.is_moe:
            self.moe = MOE.MoE(cfg, dtype, device)
        else:
            self.mlp = L.MLP(cfg, dtype, device)

    def _ffn(self, x, ring=None):
        """The residual's MLP (or expert) update and its aux loss."""
        h = L.rms_norm(x, self.ln2, self.eps)
        if self.cfg.is_moe:
            return self.moe(h, ring=ring)
        return self.mlp(h), None

    def _fuse(self, x, attn_out, ssm_out):
        fused = 0.5 * (L.rms_norm(attn_out, self.ln_attn_o, self.eps)
                       + L.rms_norm(ssm_out, self.ln_ssm_o, self.eps))
        return x + fused

    def forward(self, x, cos, sin, *, window: int = 0, prefix_len: int = 0,
                ring=None):
        """Returns (x_out, aux or None, (k, v), new_states or None)."""
        h = L.rms_norm(x, self.ln1, self.eps)
        attn_out, kv = self.attn(h, cos, sin, window=window,
                                 prefix_len=prefix_len, ring=ring)
        states = None
        if self.cfg.family == "hybrid":
            ssm_out, h_last = SSM.ssm_scan(self.ssm, h)
            x = self._fuse(x, attn_out, ssm_out)
            states = {"ssm_h": h_last}
        else:
            x = x + attn_out
        ffn, aux = self._ffn(x, ring)
        return x + ffn, aux, kv, states

    def decode(self, x, cache: dict, pos: int, *, ring: bool):
        """One layer, one new token (``block_decode``). x (B,1,D); ``cache``
        holds this layer's slices, written in place."""
        cfg = self.cfg
        h = L.rms_norm(x, self.ln1, self.eps)
        q, k, v = self.attn.qkv_proj(h)
        rot = _rope_dim(cfg)
        posv = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                          device=x.device)
        cos, sin = L.rope_angles(posv, rot, cfg.rope_theta)
        q = L.apply_rope(q, cos, sin, cfg.rope_frac)
        k = L.apply_rope(k, cos, sin, cfg.rope_frac)
        ck, cv, cp = L.cache_write(cache["k"], cache["v"], cache["pos"], k, v,
                                   pos, ring)
        window = cfg.long_context_window if ring else 0
        valid = cp >= 0
        if window:
            valid = valid & (cp > pos - window)
        attn_out = self.attn.out_proj(L.decode_attention(q, ck, cv, valid,
                                                         cfg))
        if cfg.family == "hybrid":
            ssm_out, h_new = SSM.ssm_step(self.ssm, h, cache["ssm_h"])
            x = self._fuse(x, attn_out, ssm_out)
            cache["ssm_h"].copy_(h_new)
        else:
            x = x + attn_out
        return x + self._ffn(x)[0]


class RWKVBlock(nn.Module):
    """RWKV6 layer (the ``ssm`` family): time-mix + channel-mix, each
    pre-normed, carrying token-shift and WKV states."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.eps = cfg.norm_eps
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, device=device))
        self.tm = RWKV.TimeMix(cfg, dtype, device)
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, device=device))
        self.cm = RWKV.ChannelMix(cfg, dtype, device)

    def forward(self, x, states: dict):
        """Returns (x_out, new_states)."""
        tm_out, tm_shift, wkv = RWKV.time_mix(
            self.tm, L.rms_norm(x, self.ln1, self.eps), self.cfg,
            states["tm_shift"], states["wkv"])
        x = x + tm_out
        cm_out, cm_shift = RWKV.channel_mix(
            self.cm, L.rms_norm(x, self.ln2, self.eps), states["cm_shift"])
        return x + cm_out, {"tm_shift": tm_shift, "cm_shift": cm_shift,
                            "wkv": wkv}

    def decode(self, x, cache: dict):
        tm_out, tm_shift, wkv = RWKV.time_mix_step(
            self.tm, L.rms_norm(x, self.ln1, self.eps), self.cfg,
            cache["tm_shift"], cache["wkv"])
        x = x + tm_out
        cm_out, cm_shift = RWKV.channel_mix_step(
            self.cm, L.rms_norm(x, self.ln2, self.eps), cache["cm_shift"])
        for name, val in (("tm_shift", tm_shift), ("cm_shift", cm_shift),
                          ("wkv", wkv)):
            cache[name].copy_(val)
        return x + cm_out


def unembed(model, x):
    """RMSNorm and the (tied) unembedding of ``model`` (a ``DecoderLM`` or
    an ``encdec.EncDecLM``), the padded vocabulary masked to -1e9."""
    cfg = model.cfg
    x = L.rms_norm(x, model.norm_f, cfg.norm_eps)
    logits = x @ (model.embed.T if cfg.tie_embeddings else model.lm_head)
    if cfg.padded_vocab != cfg.vocab_size:
        mask = torch.where(
            torch.arange(cfg.padded_vocab, device=x.device)
            < cfg.vocab_size, 0.0, -1e9).to(logits.dtype)
        logits = logits + mask
    return logits


def _init_seq_states(cfg: ModelConfig, batch: int, dtype, device):
    """Zero recurrent states of one RWKV6 layer."""
    d, hs = cfg.d_model, cfg.rwkv_head_size
    return {"tm_shift": torch.zeros((batch, d), dtype=dtype, device=device),
            "cm_shift": torch.zeros((batch, d), dtype=dtype, device=device),
            "wkv": torch.zeros((batch, d // hs, hs, hs), dtype=torch.float32,
                               device=device)}


class DecoderLM(nn.Module):
    """Decoder LM: embed [+ projected prefix] -> blocks -> RMSNorm ->
    (tied) unembed."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(
                f"DecoderLM builds the families {FAMILIES}, not "
                f"{cfg.family!r}; the encdec family is models/encdec.py "
                f"(zoo.init_model builds either)")
        dtype = getattr(torch, cfg.dtype)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(
            cfg.padded_vocab, cfg.d_model, dtype=dtype, device=device))
        block = RWKVBlock if cfg.family == "ssm" else Block
        self.blocks = nn.ModuleList(
            block(cfg, dtype, device) for _ in range(cfg.n_layers))
        self.norm_f = nn.Parameter(torch.ones(cfg.d_model, device=device))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(
                cfg.d_model, cfg.padded_vocab, dtype=dtype, device=device))
        if cfg.n_prefix_tokens:
            self.prefix_proj = nn.Parameter(torch.empty(
                cfg.prefix_dim, cfg.d_model, dtype=dtype, device=device))

    def embed_inputs(self, tokens, prefix=None, start: int = 0):
        """tokens (B, S) [+ prefix (B, P, prefix_dim)] -> (x (B, P + S, D),
        P) (``embed_inputs`` of the reference); NoPE configs add the
        sinusoid embedding at positions start..start+P+S-1."""
        cfg = self.cfg
        x = self.embed[tokens]
        prefix_len = 0
        if cfg.n_prefix_tokens and prefix is not None:
            x = torch.cat([prefix.to(x.dtype) @ self.prefix_proj, x], dim=1)
            prefix_len = prefix.shape[1]
        if cfg.rope_frac == 0.0 and cfg.n_heads:
            x = L.add_positions(x, start)
        return x, prefix_len

    def forward(self, tokens, prefix=None, *, window: int = 0,
                collect_cache: bool = False, last_only: bool = False,
                with_aux: bool = False, remat: bool = True, ring=None):
        """tokens (B, S) int [+ prefix (B, P, prefix_dim) of a vlm config]
        -> logits (B, P + S, padded_vocab) (``last_only``: (B, 1, V)); with
        ``collect_cache`` also the stacked per-layer cache (k, v post-RoPE
        and pos over the P + S positions; ssm_h; or the RWKV states), with
        ``with_aux`` the layers' summed MoE aux loss (0.0 without experts):
        logits[, cache][, aux]. ``window`` > 0 is sliding-window attention;
        the hybrid family takes ``cfg.long_context_window`` for 0.
        ``remat`` recomputes each layer in the backward (a no-op under
        ``torch.no_grad()``). With ``ring`` (a ``layers.Ring``; the dense
        and moe families, no window, no prefix) ``tokens`` is this rank's
        (batch shard, sequence chunk): positions are global, attention is
        the ring's and the MoE routes as over the whole batch."""
        cfg = self.cfg
        start = 0
        if ring is not None:
            if cfg.family not in ("dense", "moe") or window or prefix \
                    is not None:
                raise ValueError("the ring runs the dense and moe families "
                                 "without a window or a prefix")
            start = ring.coord(ring.seq_axis)[0] * tokens.shape[1]
        x, prefix_len = self.embed_inputs(tokens, prefix, start)
        b, s = x.shape[:2]
        caches: dict = {}
        aux = 0.0

        def put(name, i, val):
            # each layer straight into the stacked cache: no list to stack
            if name not in caches:
                caches[name] = val.new_empty((cfg.n_layers, *val.shape))
            caches[name][i] = val

        if cfg.family == "ssm":
            for i, blk in enumerate(self.blocks):
                x, st = L.remat_call(
                    blk, x, _init_seq_states(cfg, b, x.dtype, x.device),
                    remat=remat)
                if collect_cache:
                    for name, val in st.items():
                        put(name, i, val)
        else:
            if cfg.family == "hybrid" and window == 0:
                window = cfg.long_context_window
            positions = torch.arange(start, start + s, device=tokens.device)
            cos, sin = L.rope_angles(positions, _rope_dim(cfg),
                                     cfg.rope_theta)
            for i, blk in enumerate(self.blocks):
                x, layer_aux, (k, v), st = L.remat_call(
                    blk, x, cos, sin, window=window, prefix_len=prefix_len,
                    remat=remat, ring=ring)
                if layer_aux is not None:
                    aux = aux + layer_aux
                if collect_cache:
                    put("k", i, k)
                    put("v", i, v)
                    if st is not None:
                        put("ssm_h", i, st["ssm_h"])
            if collect_cache:
                caches["pos"] = positions.to(torch.int32).expand(
                    cfg.n_layers, b, s).contiguous()
        if last_only:
            x = x[:, -1:]
        out = (unembed(self, x),)
        if collect_cache:
            out += (caches,)
        if with_aux:
            out += (aux,)
        return out if len(out) > 1 else out[0]

    def decode(self, cache: dict, token, pos: int, *, ring: bool = False):
        """One decode step (``decoder_decode``). token (B,) int; ``pos`` the
        absolute position. Updates ``cache`` in place; returns (logits
        (B, V), cache)."""
        cfg = self.cfg
        x = self.embed[token][:, None, :]
        if cfg.rope_frac == 0.0 and cfg.n_heads:
            x = L.add_positions(x, pos)
        for i, blk in enumerate(self.blocks):
            layer = {name: val[i] for name, val in cache.items()}
            if cfg.family == "ssm":
                x = blk.decode(x, layer)
            else:
                x = blk.decode(x, layer, pos, ring=ring)
        return unembed(self, x[:, 0, :]), cache


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      device):
    """Stacked decode cache of the decoder families."""
    nl = cfg.n_layers
    if cfg.family == "ssm":
        st = _init_seq_states(cfg, batch, dtype, device)
        return {name: val[None].repeat(nl, *([1] * val.dim()))
                for name, val in st.items()}
    cache = L.init_kv_cache(cfg, batch, max_len, nl, dtype, device)
    if cfg.family == "hybrid":
        cache["ssm_h"] = torch.zeros((nl, batch, cfg.d_model, cfg.ssm_state),
                                     dtype=torch.float32, device=device)
    return cache
