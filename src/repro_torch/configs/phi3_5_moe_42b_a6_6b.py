"""Phi-3.5-MoE 42B-A6.6B — 16 experts, top-2 routing, GQA kv=8
[hf:microsoft/Phi-3.5-MoE-instruct]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=6400, vocab_size=32064,
    num_experts=16, experts_per_token=2,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
