"""Zamba2-2.7B — Mamba2 backbone + one shared attention block applied
every 6 layers [arXiv:2411.15242]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_conv=4, ssm_expand=2,
    attn_every=6,
    source="arXiv:2411.15242",
)
