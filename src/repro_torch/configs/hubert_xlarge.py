"""HuBERT X-Large — encoder-only audio transformer (conv/mel frontend is
a STUB per spec: frame embeddings provided); vocab 504 = k-means cluster
targets.  No decode shapes (encoder-only; DESIGN.md §6)
[arXiv:2106.07447]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504,
    norm="ln", causal=False, frontend="audio", encoder_only=True,
    source="arXiv:2106.07447",
)
