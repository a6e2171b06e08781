"""grok-1-314b — xAI Grok-1 MoE decoder.

Copy of ``src/repro/configs/grok_1_314b.py``.
[hf:xai-org/grok-1] 64L d_model=6144 48H (GQA kv=8) d_ff=32768 (per expert)
vocab=131072, MoE 8 experts top-2. Grok uses attention-logit soft-capping
(30.0) and output soft-capping; the attention cap is modeled.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok_1_314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32_768,
    vocab_size=131_072,
    n_experts=8,
    top_k=2,
    glu=True,
    logit_softcap=30.0,
    rope_theta=10_000.0,
)
