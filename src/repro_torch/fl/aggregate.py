"""Server-side aggregation of client deltas.

Counterpart of ``aggregate_deltas``, ``blend_deltas`` and
``apply_aggregate`` in ``src/repro/fl/aggregate.py``. Client deltas
arrive as the rows of one (C, P) fp32 buffer (fl/client.py writes them
there, the update predictor its predictions after them), so the FedAvg
weighted sum is ONE ``ops.weighted_sum`` call per round — the fedagg
kernel on a CUDA device (kernels/fedagg.py) — not one per parameter.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops as kops


def aggregate_deltas(rows: torch.Tensor,
                     weights: np.ndarray) -> torch.Tensor:
    """rows (C, P) fp32 client deltas; weights (C,) data sizes, normalised
    in fp32 as the reference does. Returns the (P,) weighted sum."""
    w = torch.as_tensor(np.asarray(weights, dtype=np.float32),
                        device=rows.device)
    w = w / torch.clamp(w.sum(), min=1e-9)
    return kops.weighted_sum(rows, w)


def blend_deltas(rows: torch.Tensor, real_weights: np.ndarray,
                 pred_weights: np.ndarray) -> torch.Tensor:
    """Aggregate received and server-predicted deltas in one weighted sum.

    ``rows`` (k + M, P) holds the k arrivals first, then the M predicted
    deltas (fl/predictor.py writes them there). ``real_weights`` are the
    arrivals' FedAvg data weights; ``pred_weights`` already carry the
    age-discounted trust ``n_c * beta * rho^(A_c - 1)``. The weights are
    concatenated in fp64 and normalised together, so predictions dilute,
    never displace, real updates. With no predictions this is exactly
    ``aggregate_deltas``."""
    weights = np.concatenate([np.asarray(real_weights, np.float64),
                              np.asarray(pred_weights, np.float64)])
    return aggregate_deltas(rows, weights)


@torch.no_grad()
def apply_aggregate(model: torch.nn.Module, agg: torch.Tensor,
                    server_lr: float = 1.0) -> None:
    """p <- (p.float() + server_lr * delta).to(p.dtype), in place, with
    the (P,) delta laid out in ``model.parameters()`` order."""
    off = 0
    for p in model.parameters():
        n = p.numel()
        d = agg[off:off + n].view(p.shape)
        p.copy_((p.float() + server_lr * d).to(p.dtype))
        off += n
