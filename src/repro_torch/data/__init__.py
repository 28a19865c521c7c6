"""Synthetic token data for the model zoo."""
from .pipeline import (SyntheticLMConfig, frontend_batch_kwargs, make_batch,
                       synthetic_batches)

__all__ = ["SyntheticLMConfig", "frontend_batch_kwargs", "make_batch",
           "synthetic_batches"]
