"""ChatGLM3-6B — dense, GQA kv=2, 2d-RoPE (rotary over half the head
dim) [arXiv:2406.12793]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=65024,
    rope_fraction=0.5,
    source="arXiv:2406.12793",
)
