"""smollm-135m — llama-architecture small dense decoder.

Copy of ``src/repro/configs/smollm_135m.py``.
[hf:HuggingFaceTB/SmolLM-135M] 30L d_model=576 9H (GQA kv=3) d_ff=1536
vocab=49152, tied embeddings: 134,515,008 parameters.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm_135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49_152,
    tie_embeddings=True,
    glu=True,
)
