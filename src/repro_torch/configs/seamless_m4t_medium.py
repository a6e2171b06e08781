"""seamless-m4t-medium — encoder-decoder multimodal translation backbone.

Copy of ``src/repro/configs/seamless_m4t_medium.py``.
[arXiv:2308.11596] 12 encoder + 12 decoder layers, d_model=1024 16H
(kv=16, head_dim 64) d_ff=4096 vocab=256206, plain GELU MLP, NoPE with
sinusoid positions: 877,031,424 parameters. The speech frontend is a
stub: the encoder takes 512 precomputed frame embeddings of width 1024.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless_m4t_medium",
    family="encdec",
    n_layers=12,            # decoder layers
    n_enc_layers=12,        # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256_206,
    n_prefix_tokens=512,    # encoder frames per utterance
    prefix_dim=1024,        # frontend output width
    glu=False,              # vanilla transformer FFN
    rope_frac=0.0,          # NoPE + sinusoid positions
)
