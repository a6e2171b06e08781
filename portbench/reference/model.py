"""Plain PyTorch reference of a Llama-style dense decoder's training step
(SmolLM-135M's architecture: pre-norm RMSNorm, rotary positions on the
whole head in the half-split convention, grouped-query causal attention,
a SiLU-gated MLP, a final RMSNorm and the tied embedding as the output
head), its mean next-token cross-entropy, SGD and FedAvg.

Written from the published description (hf:HuggingFaceTB/SmolLM-135M's
``LlamaForCausalLM`` config); it imports nothing of the program. Weights
use the program's layout, ``(in, out)`` matrices applied as ``x @ W``, and
the names below, so the benchmark hands both sides one set of tensors.

Precision: every value the reference computes is float32, with TF32 off
(``fp32_matmuls``). ``control=True`` is the benchmark's control: the same
mathematics with every matmul's operands rounded to float8 e4m3 (per
tensor scaled to its largest magnitude) on the way forward and their
gradients to float8 e5m2 on the way back, the precision below the
configuration's bfloat16.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def fp32_matmuls():
    """float32 matmuls in full float32 precision for the block (TF32 off),
    restoring the caller's settings after it."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def _round_fp8(x, dtype, top):
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8(torch.autograd.Function):
    """Round to e4m3 forward, the incoming gradient to e5m2 backward."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, E5M2_MAX)


def leaf_shapes(cfg: dict) -> dict:
    """{name: shape} of the decoder's leaves, in the order the benchmark
    draws them; names and ``(in, out)`` layout as the program's."""
    d = cfg["hidden_size"]
    hd = d // cfg["num_attention_heads"]
    q = cfg["num_attention_heads"] * hd
    kv = cfg["num_key_value_heads"] * hd
    ff = cfg["intermediate_size"]
    shapes = {"embed": (cfg["vocab_size"], d), "norm_f": (d,)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"blocks.{i}."
        shapes.update({p + "ln1": (d,), p + "ln2": (d,),
                       p + "attn.wq": (d, q), p + "attn.wk": (d, kv),
                       p + "attn.wv": (d, kv), p + "attn.wo": (q, d),
                       p + "mlp.wi": (d, ff), p + "mlp.wg": (d, ff),
                       p + "mlp.wo": (ff, d)})
    return shapes


def is_norm(name: str) -> bool:
    return name == "norm_f" or name.endswith(("ln1", "ln2"))


def init_scale(name: str, shape) -> float:
    """Standard deviation of a drawn matrix: 1/sqrt(fan-in) (the
    embedding 1/sqrt(d_model), so the tied head's logits have unit
    scale)."""
    return 1.0 / math.sqrt(shape[1] if name == "embed" else shape[0])


@torch.no_grad()
def make_weights(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """Seeded weights on ``device``: one normal draw for all matrices from
    a ``torch.Generator`` on the device, each slice scaled by
    ``init_scale`` and cast to ``dtype``; norm weights 1 in float32."""
    shapes = leaf_shapes(cfg)
    mats = {k: s for k, s in shapes.items() if not is_norm(k)}
    total = sum(math.prod(s) for s in mats.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, off = {}, 0
    for name, shape in shapes.items():
        if is_norm(name):
            out[name] = torch.ones(shape, dtype=torch.float32, device=device)
            continue
        n = math.prod(shape)
        out[name] = (flat[off:off + n].view(shape)
                     * init_scale(name, shape)).to(dtype)
        off += n
    return out


def _rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w


def _rope(x, positions, theta):
    """Rotate all of the head (x (B, S, H, hd)), half-split convention."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = positions.to(torch.float32)[:, None] * inv          # (S, hd/2)
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def loss_sum(cfg: dict, w: dict, tokens, *, control: bool = False):
    """Sum over the rows of ``tokens`` (B, S) int of each row's mean
    next-token cross-entropy (inputs tokens[:, :-1], labels tokens[:, 1:]);
    float32 throughout."""
    q8 = _Fp8.apply if control else (lambda t: t)
    mm = lambda a, b: q8(a) @ q8(b)
    eps = cfg["rms_norm_eps"]
    h_n = cfg["num_attention_heads"]
    kv_n = cfg["num_key_value_heads"]
    d = cfg["hidden_size"]
    hd = d // h_n
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    b, s = inputs.shape
    pos = torch.arange(s, device=tokens.device)
    causal = torch.ones(s, s, dtype=torch.bool,
                        device=tokens.device).tril()
    x = w["embed"][inputs]
    for i in range(cfg["num_hidden_layers"]):
        p = f"blocks.{i}."
        h = _rms_norm(x, w[p + "ln1"], eps)
        q = mm(h, w[p + "attn.wq"]).view(b, s, h_n, hd)
        k = mm(h, w[p + "attn.wk"]).view(b, s, kv_n, hd)
        v = mm(h, w[p + "attn.wv"]).view(b, s, kv_n, hd)
        q, k = _rope(q, pos, cfg["rope_theta"]), _rope(k, pos, cfg["rope_theta"])
        group = h_n // kv_n
        k = k.repeat_interleave(group, dim=2)       # query head j -> kv j // group
        v = v.repeat_interleave(group, dim=2)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # (B, H, S, hd)
        scores = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
        attn = mm(probs, v).transpose(1, 2).reshape(b, s, h_n * hd)
        x = x + mm(attn, w[p + "attn.wo"])
        h = _rms_norm(x, w[p + "ln2"], eps)
        x = x + mm(F.silu(mm(h, w[p + "mlp.wg"])) * mm(h, w[p + "mlp.wi"]),
                   w[p + "mlp.wo"])
    x = _rms_norm(x, w["norm_f"], eps)
    logits = mm(x, w["embed"].T)
    nll = torch.logsumexp(logits, -1) - logits.gather(
        -1, labels[..., None])[..., 0]
    return nll.mean(dim=-1).sum()


def loss_and_grads(cfg: dict, w: dict, tokens, *, block_rows: int,
                   control: bool = False):
    """Mean loss over the B rows of ``tokens`` and its gradient for every
    leaf of ``w`` (float32 values), computed ``block_rows`` rows at a
    time so the activations fit; returns (loss float, {name: grad})."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in w.items()}
    b = tokens.shape[0]
    total = 0.0
    grads = {k: torch.zeros_like(v) for k, v in w.items()}
    for r0 in range(0, b, block_rows):
        part = loss_sum(cfg, leaves, tokens[r0:r0 + block_rows],
                        control=control) / b
        gs = torch.autograd.grad(part, list(leaves.values()))
        for k, g in zip(leaves, gs):
            grads[k] += g
        total += float(part.detach())
    return total, grads


def stored(x, name: str, param_dtype):
    """``x`` rounded to the dtype the configuration stores the leaf in
    (norm weights float32, matrices ``param_dtype``), as float32."""
    return x if is_norm(name) else x.to(param_dtype).to(torch.float32)


def sgd_step(w: dict, grads: dict, lr: float, param_dtype) -> dict:
    """p <- stored(p - lr * g): the update in float32, the result in the
    leaf's stored precision."""
    return {k: stored(w[k] - lr * grads[k], k, param_dtype) for k in w}


def fedavg(w: dict, deltas: list, sizes, param_dtype) -> dict:
    """FedAvg: the deltas' mean weighted by data size (weights normalised
    in float32), summed in order in float32 and added to ``w`` in its
    stored precision."""
    sz = torch.tensor([float(s) for s in sizes], dtype=torch.float32)
    wt = sz / sz.sum()
    out = {}
    for k in w:
        acc = torch.zeros_like(w[k])
        for c, d in enumerate(deltas):
            acc = acc + float(wt[c]) * d[k]
        out[k] = stored(w[k] + acc, k, param_dtype)
    return out
