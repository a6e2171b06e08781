"""Op-level entry points of the port's kernels (counterpart of
``src/repro/kernels/ops.py``). Each calls its kernel's wrapper, which
launches the CUDA kernel for CUDA tensors and takes the plain PyTorch
version for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fedagg as _fedagg


def weighted_sum(stacked: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """stacked (C, *shape); weights (C,) -> (*shape,) fp32 weighted sum."""
    c = stacked.shape[0]
    out = _fedagg.fedagg(stacked.reshape(c, -1), weights)
    return out.reshape(stacked.shape[1:])
