"""Llama-4 Maverick 400B-A17B — interleaved MoE (every 2nd layer),
128 routed experts top-1 + shared expert, GQA kv=8, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

The 40 query heads are physically padded to 48 for 16-way tensor
parallelism (DESIGN.md §7); kv=8 heads are replicated across the model
axis (their projections are small)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    num_experts=128, experts_per_token=1,
    moe_every=2, moe_shared_expert=True,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
