"""xLSTM-125M — sLSTM + mLSTM blocks at a [7:1]-style ratio (sLSTM at
layers 3 and 9 of 12); d_ff=0 because the up/down projection lives
inside the mLSTM block (proj_factor 2) [arXiv:2405.04517]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    slstm_layers=(3, 9), xlstm_proj_factor=2.0,
    source="arXiv:2405.04517",
)
