"""StableLM-3B — dense MHA (kv = q = 32), LayerNorm
[hf:stabilityai/stablelm-2-1_6b]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=6912, vocab_size=50304,
    norm="ln", rope_fraction=0.25,
    source="hf:stabilityai/stablelm-2-1_6b",
)
