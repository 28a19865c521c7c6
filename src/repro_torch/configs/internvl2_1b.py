"""InternVL2-1B — InternViT vision frontend (STUB per spec: patch
embeddings provided pre-projected at d_model) + InternLM2 dense decoder
backbone [arXiv:2404.16821]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151655,
    frontend="vision", frontend_tokens=256,
    source="arXiv:2404.16821",
)
