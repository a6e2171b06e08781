"""hymba-1.5b — hybrid-head decoder: parallel attention + Mamba heads.

Copy of ``src/repro/configs/hymba_1_5b.py``.
[arXiv:2411.13676] 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16. Attention and SSM branches run in PARALLEL within each layer
and their (normalized) outputs are mean-fused, per the Hymba paper.
Sub-quadratic: SSM branch is O(S); attention branch uses sliding window for
long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba_1_5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32_001,
    ssm_state=16,
    sliding_window=0,
    long_context_window=2048,   # hymba uses SWA on most attn layers
    glu=True,
)
