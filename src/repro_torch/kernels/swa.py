"""Causal sliding-window attention with GQA, an optional prefix-LM band and
an optional tanh softcap.

Counterpart of ``src/repro/kernels/swa.py`` (``swa_pallas``) and of the
windowed ``layers.flash_attention`` of the reference: query i attends keys
j with i - window < j and (j <= i or j < prefix), the reference's mask
(``layers.py:199-206``): the first ``prefix`` positions (a vlm's image
tokens) are seen by every query within the window. q (B,S,H,hd), k/v
(B,S,KH,hd) -> (B,S,H,hd) in q's dtype; scores, softmax and the weighted
sum in fp32.

``swa`` is the wrapper of the hand-written CUDA kernels of ``csrc/swa.cu``,
which replace the TPU kernel ``_swa_kernel`` (src/repro/kernels/swa.py:27).
Bound on the H100: 4 * hd operations per (query, key) pair of the band
against one read of q, k, v and one write of the output, so at hymba's
prefill shape the operations bound it. Which kernel runs is set by the
dtype alone:

- bf16 (the serving path): ``swa_wgmma``, on the tensor cores. K/V tiles
  by TMA, S = Q K^T and O += P V by ``wgmma`` with fp32 accumulators, the
  online softmax in fp32, P rounded to bf16 for the second product. Its
  tensor maps need 16-byte aligned q, k, v; the wrapper copies a tensor
  that is not. At head_dim 128 each tile is two swizzled 64-column slabs
  and one CTA fits an SM; at 256 (paligemma) four slabs, a two-stage ring
  and the output staged over the Q tile.
- fp32 (the model-level checks): ``swa_fp32``, fp32 on the CUDA cores.

``attention_plain`` is the plain PyTorch version: dense masked attention
in fp32 (the reference's ``_direct_attention``), which ``swa_plain`` runs
with a window and ``layers.direct_attention`` runs for every other
attention of the port up to 256 x 256 (query, key) pairs (above, the
chunked ``layers.chunked_attention``). The wrapper takes the plain version only for CPU
tensors; for CUDA tensors it launches a kernel or raises.

The backward. Where autograd needs a gradient of a CUDA input, ``swa``
applies ``_SwaGrad``, whose backward is ``swa_bwd``, the hand-written CUDA
kernels of ``csrc/swa_bwd.cu`` (no atomics: two calls give the same
bits). They replace no TPU kernel: the reference takes this gradient by
JAX's autodiff of ``layers.flash_attention``
(src/repro/models/layers.py:214). Bound on the H100: 10 hd operations a
pair of the band (five products of hd) against one read of q, k, v,
dout, the forward's output and lse and one write of dq, dk, dv; the
operations bound it, at 989 TFLOP/s for bf16 inputs. The dtype sets the
route, as for the forward:

- bf16 (the training path): the forward kernel also writes each row's
  lse, and ``_SwaGrad`` saves q, k, v, the output and lse. Three launches
  on the tensor cores: ``swa_bwd_dq_wgmma`` forms D = rowsum(dO * O) from
  the forward's output and accumulates dq (S = Q K^T, dP = dO V^T, dq +=
  dS K: 3 products a pair); ``swa_bwd_dkv_wgmma``, one CTA per (b, query
  head, key tile), accumulates dk and dv (S^T, dP^T, dv += P^T dO, dk +=
  dS^T Q: 4); under GQA ``swa_bwd_group_sum`` adds each KV head's query
  heads in a fixed order. P and dS are rounded to bf16 for the products.
- fp32 (the model-level checks): ``_SwaGrad`` saves q, k, v, and two
  launches on the CUDA cores recompute lse, O and D = dO . O in one walk
  per query tile and accumulate dq, dk and dv over the group's query heads
  in the next walks (9 products a pair).

``swa_bwd_plain`` is the plain version, the same algorithm in fp32, with
lse and D from ``out`` and ``lse`` where given; ``swa_lse_plain`` the
forward's lse. Under ``torch.no_grad()``, or when no input needs a
gradient, the forward launches with a null lse pointer and saves nothing.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the reduced and the full hymba (16, 64; stablelm and seamless 64), the
# head_dim-128 decoders (chatglm3, moonshot, grok, llama4) and paligemma
HEAD_DIMS = (16, 64, 128, 256)
MAX_GRID_Y = 65_535          # fp32: B * H rides on the grid's y dimension


def attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, prefix_len: int = 0):
    """q (B,Sq,H,hd), k/v (B,Skv,KH,hd) -> (B,Sq,H,hd) in q's dtype.
    Query positions are right-aligned to the keys (decode-style when
    Sq < Skv); ``window`` > 0 keeps keys j > i - window; with ``causal``,
    keys j < ``prefix_len`` are seen by every query (the prefix-LM band).
    """
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(hd)
    qf = q.reshape(b, sq, kh, g, hd).float() * scale
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float())
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & ((kp <= qp) | (kp < prefix_len))
    if window > 0:
        mask = mask & (kp > qp - window)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def swa_plain(q, k, v, *, window: int, softcap: float = 0.0,
              prefix: int = 0):
    """Plain version of ``swa``: causal attention over the band, with the
    first ``prefix`` keys seen by every query within the window."""
    return attention_plain(q, k, v, causal=True, window=window,
                           softcap=softcap, prefix_len=prefix)


def _check(q, k, v, window, prefix):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or q.shape[0] != k.shape[0] or q.shape[1] != k.shape[1] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"swa takes q (B,S,H,hd) and k, v (B,S,KH,hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape[2] < 1 or q.shape[2] % k.shape[2]:
        raise ValueError(f"swa: {q.shape[2]} query heads do not split over "
                         f"{k.shape[2]} KV heads")
    if window < 1:
        raise ValueError(f"swa takes window >= 1, got {window}")
    if prefix < 0:
        raise ValueError(f"swa takes prefix >= 0, got {prefix}")


def _check_cuda(q, k, v):
    """The kernels' own limits, for tensors not all on the CPU."""
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("swa takes q, k, v on one CUDA device (or all on "
                         "the CPU)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"swa takes fp32 or bf16 q, k, v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, _, h, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"swa kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if q.dtype == torch.float32 and b * h > MAX_GRID_Y:
        raise ValueError(f"swa kernel takes B * H <= {MAX_GRID_Y}, got "
                         f"{b * h}")


def swa(q, k, v, *, window: int, softcap: float = 0.0, prefix: int = 0):
    """Sliding-window attention: the CUDA kernel for CUDA tensors,
    ``swa_plain`` for CPU tensors. Where autograd needs a gradient of a
    CUDA input, the call goes through ``_SwaGrad``, whose backward is
    ``swa_bwd``'s kernels; otherwise nothing is saved."""
    _check(q, k, v, window, prefix)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return swa_plain(q, k, v, window=window, softcap=softcap,
                         prefix=prefix)
    _check_cuda(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _SwaGrad.apply(q, k, v, window, softcap, prefix)
    return _forward(q, k, v, window, softcap, prefix)


def _forward(q, k, v, window, softcap, prefix, *, with_lse=False):
    """The forward kernel on checked CUDA tensors, through the custom op
    ``repro_torch::swa_fwd``. ``with_lse`` (bf16 only) also returns each
    row's log-sum-exp, (B, H, S) fp32, for the backward: ``(out, lse)``."""
    if with_lse and q.dtype != torch.bfloat16:
        raise ValueError("swa writes lse for bf16 inputs only")
    out, lse = torch.ops.repro_torch.swa_fwd(q, k, v, int(window),
                                             float(softcap), int(prefix),
                                             with_lse)
    return (out, lse) if with_lse else out


def band_pairs(s: int, window: int, prefix: int = 0) -> int:
    """(query, key) pairs of a causal band of width ``window`` over ``s``
    positions, with the prefix-LM band's extra pairs (keys j < prefix above
    the diagonal, within the window since j > i)."""
    w = min(window, s)
    p = min(prefix, s)
    return w * (w + 1) // 2 + (s - w) * w + p * (p - 1) // 2


@torch.library.custom_op("repro_torch::swa_fwd", mutates_args=(),
                         device_types="cuda")
def _swa_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                window: int, softcap: float, prefix: int,
                with_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The launch of ``csrc/swa.cu``; lse is (B, H, S) with ``with_lse``,
    else empty (the kernel gets a null pointer)."""
    dev = q.device
    b, s, h, hd = q.shape
    kh = k.shape[2]
    q, k, v = (build.aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s) if with_lse else (0,), dtype=torch.float32,
                      device=dev)
    if q.numel() == 0:
        return out, lse
    lib = build.load()
    code = lib.repro_swa(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(),
                         lse.data_ptr() if with_lse else None,
                         _DTYPES[q.dtype], b, s, h, kh, hd, int(window),
                         int(prefix), float(1.0 / math.sqrt(hd)),
                         float(softcap), dev.index,
                         torch.cuda.current_stream(dev).cuda_stream)
    build.count_launch(swa)
    build.check(code, "swa")
    return out, lse


@_swa_fwd_op.register_fake
def _(q, k, v, window, softcap, prefix, with_lse):
    b, s, h, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((b, h, s) if with_lse else (0,),
                        dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.swa_fwd)
def swa_flops(q_shape, k_shape, v_shape, window, softcap, prefix, with_lse,
              *args, **kwargs) -> int:
    """The operations that the forward's bound prices: 4 hd a (query,
    key) pair of the band, each query head."""
    b, s, h, hd = q_shape
    return 4 * hd * b * h * band_pairs(s, window, prefix)


swa.launches = 0


class _SwaGrad(torch.autograd.Function):
    """``swa`` under autograd on the card: the forward kernel, then
    ``swa_bwd``'s kernels. bf16 saves q, k, v, the output and the
    forward's lse, which the backward's kernels read in place of
    recomputing the forward; fp32 saves q, k, v and recomputes."""

    @staticmethod
    def forward(ctx, q, k, v, window, softcap, prefix):
        ctx.band = (window, softcap, prefix)
        if q.dtype == torch.bfloat16:
            out, lse = _forward(q, k, v, window, softcap, prefix,
                                with_lse=True)
            ctx.save_for_backward(q, k, v, out, lse)
            return out
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, window, softcap, prefix)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, *fwd = ctx.saved_tensors
        out, lse = fwd if fwd else (None, None)
        window, softcap, prefix = ctx.band
        dq, dk, dv = swa_bwd(q, k, v, dout, window=window, softcap=softcap,
                             prefix=prefix, out=out, lse=lse)
        return dq, dk, dv, None, None, None


def _band_scores(q, k, window, softcap, prefix):
    """q * scale as (B,S,KH,G,hd) fp32, the capped scores (B,KH,G,S,S) and
    the same with -inf off the band."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    qf = q.reshape(b, sq, kh, h // kh, hd).float() * (1.0 / math.sqrt(hd))
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float())
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sq, device=q.device)[None, :]
    band = ((kp <= qp) | (kp < prefix)) & (kp > qp - window)
    return qf, s, s.masked_fill(~band, float("-inf"))


def swa_lse_plain(q, k, v, *, window: int, softcap: float = 0.0,
                  prefix: int = 0):
    """Plain version of the lse that the bf16 forward writes under
    autograd: each row's log-sum-exp of its scores over the band, in
    natural-log units, (B, H, S) fp32 (v is not read)."""
    b, sq, h, _ = q.shape
    masked = _band_scores(q, k, window, softcap, prefix)[2]
    return torch.logsumexp(masked, dim=-1).reshape(b, h, sq)


def swa_bwd_plain(q, k, v, dout, *, window: int, softcap: float = 0.0,
                  prefix: int = 0, out=None, lse=None):
    """Plain version of ``swa_bwd``, by the kernels' algorithm in fp32:
    lse, P = exp(s - lse), O and D = rowsum(dO * O), dP = dO V^T and
    dS = P (dP - D) times the softcap's derivative 1 - (s / cap)^2; dq =
    scale dS K, dk = scale dS^T Q and dv = P^T dO, summed over each KV
    head's query heads. With the forward's ``out`` (B,S,H,hd) and ``lse``
    (B,H,S), as the bf16 kernels take them, P comes from ``lse`` and D
    from ``out``; without them both are recomputed. Returns (dq, dk, dv) in
    q's dtype."""
    if (out is None) != (lse is None):
        raise ValueError("swa_bwd takes out and lse together")
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(hd)
    qf, s, masked = _band_scores(q, k, window, softcap, prefix)
    kf, vf = k.float(), v.float()
    do = dout.reshape(b, sq, kh, g, hd).float()
    if lse is None:
        lse = torch.logsumexp(masked, dim=-1, keepdim=True)
        p = torch.exp(masked - lse)
        o = torch.einsum("bkgqs,bskh->bqkgh", p, vf)
    else:
        p = torch.exp(masked - lse.float().reshape(b, kh, g, sq, 1))
        o = out.reshape(b, sq, kh, g, hd).float()
    dd = (do * o).sum(-1)                                  # (B,S,KH,G)
    dp = torch.einsum("bqkgh,bskh->bkgqs", do, vf)
    ds = p * (dp - dd.permute(0, 2, 3, 1)[..., None])
    if softcap > 0.0:
        ds = ds * (1.0 - (s / softcap) ** 2)
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qf)
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, do)
    return (dq.reshape(b, sq, h, hd).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))


def swa_bwd(q, k, v, dout, *, window: int, softcap: float = 0.0,
            prefix: int = 0, out=None, lse=None):
    """(dq, dk, dv) of ``swa`` for the output's cotangent ``dout``: the
    CUDA kernels of ``csrc/swa_bwd.cu`` for CUDA tensors (one count a
    call, whatever its launches), ``swa_bwd_plain`` for CPU tensors. In q's
    dtype. bf16 CUDA tensors need the forward's ``out`` and ``lse``
    (``_forward(..., with_lse=True)``); fp32 ones recompute them and take
    None."""
    _check(q, k, v, window, prefix)
    if dout.shape != q.shape:
        raise ValueError(f"swa_bwd takes dout of q's shape {tuple(q.shape)}, "
                         f"got {tuple(dout.shape)}")
    b, s, h, hd = q.shape
    kh = k.shape[2]
    if (out is None) != (lse is None):
        raise ValueError("swa_bwd takes out and lse together")
    if out is not None and (out.shape != q.shape
                            or tuple(lse.shape) != (b, h, s)):
        raise ValueError(f"swa_bwd takes out of q's shape and lse "
                         f"{(b, h, s)}, got {tuple(out.shape)}, "
                         f"{tuple(lse.shape)}")
    if all(t.device.type == "cpu" for t in (q, k, v, dout)):
        return swa_bwd_plain(q, k, v, dout, window=window, softcap=softcap,
                             prefix=prefix, out=out, lse=lse)
    _check_cuda(q, k, v)
    dev = q.device
    if dout.device != dev or (out is not None and (
            out.device != dev or lse.device != dev)):
        raise ValueError("swa_bwd takes dout, out and lse on q's device")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and out is None:
        raise ValueError("swa_bwd on bf16 CUDA tensors takes the forward's "
                         "out and lse (swa's _forward(..., with_lse=True))")
    if not bf16 and out is not None:
        raise ValueError("swa_bwd on fp32 CUDA tensors recomputes lse: pass "
                         "out=None, lse=None")
    return torch.ops.repro_torch.swa_bwd(q, k, v, dout, out, lse,
                                         int(window), float(softcap),
                                         int(prefix))


@torch.library.custom_op("repro_torch::swa_bwd", mutates_args=(),
                         device_types="cuda")
def _swa_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                dout: torch.Tensor, out: Optional[torch.Tensor],
                lse: Optional[torch.Tensor], window: int, softcap: float,
                prefix: int) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """The launches of ``csrc/swa_bwd.cu`` (one count) with their
    scratch."""
    dev = q.device
    b, s, h, hd = q.shape
    kh = k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    q, k, v = (build.aligned(t) for t in (q, k, v))
    dout = build.aligned(dout.to(q.dtype))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    f32 = dict(dtype=torch.float32, device=dev)
    rows = s
    dk_part = dv_part = None
    if bf16:
        out = build.aligned(out.to(q.dtype))
        lse = lse.float().contiguous()
        rows = -(-s // 64) * 64          # the scratch's rows, padded to 64
        if h > kh:                       # each query head's dk, dv
            dk_part, dv_part = (torch.empty((b, s, h, hd), **f32)
                                for _ in range(2))
    ws_lse, ws_dd = (torch.empty((b, h, rows), **f32) for _ in range(2))

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = build.load()
    code = lib.repro_swa_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), ptr(out),
        ptr(lse), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        ws_lse.data_ptr(), ws_dd.data_ptr(), ptr(dk_part), ptr(dv_part),
        _DTYPES[q.dtype], b, s, h, kh, hd, int(window), int(prefix),
        float(1.0 / math.sqrt(hd)), float(softcap), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    build.count_launch(swa_bwd)
    build.check(code, "swa_bwd")
    return dq, dk, dv


@_swa_bwd_op.register_fake
def _(q, k, v, dout, out, lse, window, softcap, prefix):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


@register_flop_formula(torch.ops.repro_torch.swa_bwd)
def swa_bwd_flops(q_shape, k_shape, v_shape, dout_shape, out_shape_, lse_shape,
                  window, softcap, prefix, *args, **kwargs) -> int:
    """The operations that the backward's bound prices: 10 hd a (query,
    key) pair of the band (five products of hd), each query head."""
    b, s, h, hd = q_shape
    return 10 * hd * b * h * band_pairs(s, window, prefix)


swa_bwd.launches = 0
