"""stablelm-1.6b — StableLM-2 1.6B dense decoder.

Copy of ``src/repro/configs/stablelm_1_6b.py``.
[hf:stabilityai/stablelm-2-1_6b] 24L d_model=2048 32H (MHA kv=32)
d_ff=5632 vocab=100352. Partial rotary (25% of head dim), qkv bias.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm_1_6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100_352,
    rope_frac=0.25,
    qkv_bias=True,
    glu=True,
)
