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
"""
from __future__ import annotations

import math

import torch

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


def swa(q, k, v, *, window: int, softcap: float = 0.0, prefix: int = 0):
    """Sliding-window attention: the CUDA kernel for CUDA tensors,
    ``swa_plain`` for CPU tensors."""
    _check(q, k, v, window, prefix)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return swa_plain(q, k, v, window=window, softcap=softcap,
                         prefix=prefix)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("swa takes q, k, v on one CUDA device (or all on "
                         "the CPU)")
    build.refuse_grad("swa", q, k, v)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"swa takes fp32 or bf16 q, k, v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, s, h, hd = q.shape
    kh = k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"swa kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if q.dtype == torch.float32 and b * h > MAX_GRID_Y:
        raise ValueError(f"swa kernel takes B * H <= {MAX_GRID_Y}, got "
                         f"{b * h}")
    q, k, v = (build.aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = build.load()
    code = lib.repro_swa(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), _DTYPES[q.dtype], b, s, h, kh, hd,
                         int(window), int(prefix),
                         float(1.0 / math.sqrt(hd)), float(softcap),
                         dev.index,
                         torch.cuda.current_stream(dev).cuda_stream)
    build.count_launch(swa)
    build.check(code, "swa")
    return out


swa.launches = 0
