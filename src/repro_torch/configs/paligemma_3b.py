"""paligemma-3b — PaliGemma language backbone (Gemma-2B-style) consuming
stubbed SigLIP patch embeddings.

Copy of ``src/repro/configs/paligemma_3b.py``.
[arXiv:2407.07726] 18L d_model=2048 8H (MQA kv=1) head_dim=256 d_ff=16384
vocab=257216, tied embeddings: 2,508,587,008 parameters. The SigLIP
vision tower is a stub: the model takes 256 precomputed patch embeddings
(prefix tokens, width 1152) projected into d_model.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma_3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16_384,
    vocab_size=257_216,
    n_prefix_tokens=256,       # 224px / 14 patch -> 256 tokens
    prefix_dim=1152,           # SigLIP-So400m output width
    glu=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
)
