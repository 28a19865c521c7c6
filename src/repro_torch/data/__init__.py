"""Synthetic token data for the model zoo."""
from .pipeline import SyntheticLMConfig, make_batch, synthetic_batches

__all__ = ["SyntheticLMConfig", "make_batch", "synthetic_batches"]
