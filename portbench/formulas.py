"""Frozen arithmetic of the benchmark: the card's published peaks, the
model-FLOP count of a dense decoder's training step, and the bytes the
fedagg and pairscore kernels must move.

Everything here is computed from widths and shapes, never from what an
implementation happens to launch, so a later change of the program's
attention path or kernels leaves these counts where they are.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def dense_matmul_params(cfg: dict) -> int:
    """Parameters that enter a matmul in a Llama-style decoder: q, k, v, o,
    the three GLU projections of every layer, and the output head (the
    tied embedding counted once, as the head). Norm weights and the input
    embedding's lookup do no matmul."""
    d = cfg["hidden_size"]
    hd = d // cfg["num_attention_heads"]
    q = cfg["num_attention_heads"] * hd
    kv = cfg["num_key_value_heads"] * hd
    ff = cfg["intermediate_size"]
    per_layer = d * q + 2 * d * kv + q * d + 3 * d * ff
    return cfg["num_hidden_layers"] * per_layer + cfg["vocab_size"] * d


def train_flops_per_token(cfg: dict, seq: int) -> float:
    """PaLM's model FLOPs of one trained token (arXiv:2204.02311, app. B):
    6 per matmul parameter for the forward and backward, plus
    12 x layers x (heads x head size) x sequence for the attention scores
    and their weighted sum. Recomputation is not counted."""
    d = cfg["hidden_size"]
    hd = d // cfg["num_attention_heads"]
    attn = 12 * cfg["num_hidden_layers"] * cfg["num_attention_heads"] * hd \
        * seq
    return 6.0 * dense_matmul_params(cfg) + attn


def fedagg_bytes(rows: int, n_params: int) -> int:
    """Least bytes of one FedAvg weighted sum of ``rows`` fp32 deltas of
    ``n_params``: each row read once, the fp32 result written once (the
    row weights are negligible)."""
    return (rows + 1) * n_params * 4


def pairscore_bytes(elements: int) -> int:
    """Least bytes of one pairscore call over ``elements`` pairs: two fp32
    gains read, two powers and two rates written."""
    return 24 * elements


def roofline_pct(least_seconds: float, device_seconds: float):
    """The share of its roofline a kernel reached, in percent: the least
    time the card could take over the device time it took. None where no
    device time was recorded."""
    if device_seconds <= 0.0:
        return None
    return 100.0 * least_seconds / device_seconds
