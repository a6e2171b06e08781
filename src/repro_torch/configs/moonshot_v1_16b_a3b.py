"""moonshot-v1-16b-a3b — Moonlight-style 16B-A3B MoE decoder.

Copy of ``src/repro/configs/moonshot_v1_16b_a3b.py``.
[hf:moonshotai/Moonlight-16B-A3B] 48L d_model=2048 16H (GQA kv=16)
d_ff=1408 (per expert) vocab=163840, MoE 64 experts top-6.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot_v1_16b_a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163_840,
    n_experts=64,
    top_k=6,
    glu=True,
    rope_theta=50_000.0,
)
