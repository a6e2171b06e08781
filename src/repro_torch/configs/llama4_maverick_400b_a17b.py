"""llama4-maverick-400b-a17b — Llama-4 Maverick-class MoE decoder.

Copy of ``src/repro/configs/llama4_maverick_400b_a17b.py``.
[hf:meta-llama/Llama-4-Scout-17B-16E family] 48L d_model=5120 40H
(GQA kv=8) d_ff=8192 (per expert) vocab=202048, MoE 128 experts top-1.
Early-fusion multimodality is out of scope of the assigned backbone spec
(text backbone only; see DESIGN.md section 5).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4_maverick_400b_a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    n_experts=128,
    top_k=1,
    glu=True,
    rope_theta=500_000.0,
)
