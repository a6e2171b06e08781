"""Op-level entry points of the port's kernels (counterpart of
``src/repro/kernels/ops.py``). Each calls its kernel's wrapper, which
launches the CUDA kernel for CUDA tensors and takes the plain PyTorch
version for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fedagg as _fedagg
from repro_torch.kernels import swa as _swa
from repro_torch.kernels import wkv6 as _wkv6


def weighted_sum(stacked: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """stacked (C, *shape); weights (C,) -> (*shape,) fp32 weighted sum."""
    c = stacked.shape[0]
    out = _fedagg.fedagg(stacked.reshape(c, -1), weights)
    return out.reshape(stacked.shape[1:])


def wkv6(r, k, v, w_log, u, s0=None, *, chunk: int = _wkv6.CHUNK):
    """Chunked RWKV6. Returns (out (B,H,T,C) fp32, s_T (B,H,C,C) fp32);
    unlike the reference's Pallas path, ``s0`` is honoured and ``s_T`` is
    returned on every device."""
    return _wkv6.wkv6(r, k, v, w_log, u, s0, chunk=chunk)


def swa(q, k, v, *, window: int, softcap: float = 0.0, prefix: int = 0):
    """Sliding-window attention with the first ``prefix`` keys seen by
    every query within the window (softcap honoured on every device)."""
    return _swa.swa(q, k, v, window=window, softcap=softcap, prefix=prefix)
