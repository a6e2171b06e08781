"""rwkv6-7b — RWKV-6 "Finch": attention-free RNN with data-dependent decay.

Copy of ``src/repro/configs/rwkv6_7b.py``.
[arXiv:2404.05892] 32L d_model=4096 (attn-free) d_ff=14336 vocab=65536.
Head size 64 (=> 64 WKV heads). Decode carries per-head (hd x hd) WKV state
plus token-shift states — O(1) in sequence length, so long_500k is native.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6_7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=14_336,
    vocab_size=65_536,
    rwkv_head_size=64,
    glu=False,   # rwkv channel-mix has its own gating
)
