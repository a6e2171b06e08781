"""Age/size-weighted aggregation of stacked client updates, the FedAvg
server hot spot:

    out[n] = sum_c w[c] * u[c, n]      (fp32 accumulation)

Counterpart of ``src/repro/kernels/fedagg.py`` and ``ref.weighted_sum_ref``.

``fedagg`` is the wrapper of the hand-written CUDA kernel
``csrc/fedagg.cu``, which replaces the TPU kernel ``_fedagg_kernel``
(src/repro/kernels/fedagg.py:24). Bound on the H100: it moves
``(C + 1) * N * 4`` bytes (fp32 updates) for ``2 * C * N`` operations, so
the memory rate bounds it; the kernel streams each row once in 16-byte
loads with the weights in shared memory and writes each output once, with
no padding to a block size (the reference padded N to ``block_n``).

``fedagg_plain`` is the plain PyTorch version, summing over c in the
kernel's order. The wrapper takes it only for CPU tensors; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CLIENTS = 12_288     # weights live in 48 KiB of shared memory


def fedagg_plain(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u (C, N) fp32/bf16, w (C,) -> (N,) fp32, accumulated over c in
    order."""
    w = w.float()
    out = w[0] * u[0].float()
    for c in range(1, u.shape[0]):
        out = out + w[c] * u[c].float()
    return out


def fedagg(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(N,) fp32 weighted sum of the rows of ``u`` (C, N): the CUDA kernel
    for CUDA tensors, ``fedagg_plain`` for CPU tensors. ``u`` may be a row
    slice of a larger buffer (unit column stride, any row stride)."""
    if u.dim() != 2 or w.dim() != 1 or w.shape[0] != u.shape[0]:
        raise ValueError(f"fedagg takes u (C, N) and w (C,), got "
                         f"{tuple(u.shape)} and {tuple(w.shape)}")
    c, n = u.shape
    if c < 1 or c > MAX_CLIENTS:
        raise ValueError(f"fedagg takes 1..{MAX_CLIENTS} rows, got {c}")
    if u.device.type == "cpu" and w.device.type == "cpu":
        return fedagg_plain(u, w)
    if u.device != w.device or u.device.type != "cuda":
        raise ValueError("fedagg takes u and w on one CUDA device (or both "
                         "on the CPU)")
    if u.dtype not in _DTYPES:
        raise ValueError(f"fedagg takes fp32 or bf16 updates, got {u.dtype}")
    if n > 1 and u.stride(1) != 1:
        u = u.contiguous()
    w = w.to(torch.float32).contiguous()
    out = torch.empty(n, dtype=torch.float32, device=u.device)
    if n == 0:
        return out
    elt = u.element_size()
    ld = u.stride(0) if c > 1 else n
    aligned = u.data_ptr() % 16 == 0 and (ld * elt) % 16 == 0
    vec = 16 // elt if aligned else 1
    lib = build.load()
    code = lib.repro_fedagg(u.data_ptr(), _DTYPES[u.dtype], vec, ld,
                            w.data_ptr(), out.data_ptr(), c, n,
                            u.device.index,
                            torch.cuda.current_stream(u.device).cuda_stream)
    build.count_launch(fedagg)
    build.check(code, "fedagg")
    return out


fedagg.launches = 0
