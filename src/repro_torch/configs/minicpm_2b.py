"""MiniCPM-2B — llama-like dense, MHA 36 heads (padded to 48 for 16-way
TP, DESIGN.md §7), tied embeddings, WSD LR schedule (optim/schedules.py)
[arXiv:2404.06395]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
    d_ff=5760, vocab_size=122753,
    tie_embeddings=True, scale_embed=True,
    source="arXiv:2404.06395",
)
