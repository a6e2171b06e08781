"""chatglm3-6b — GLM dense decoder with 2D-RoPE-style partial rotary + GQA.

Copy of ``src/repro/configs/chatglm3_6b.py``.
[arXiv:2406.12793] 28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
GLM applies rotary to half the head dim ("RoPE 2d"); modeled via
rope_frac=0.5.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3_6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13_696,
    vocab_size=65_024,
    rope_frac=0.5,
    qkv_bias=True,
    glu=True,
)
