"""Serving steps of the model zoo (training is not ported yet)."""
from .serve import greedy_generate, make_decode_step, make_prefill_step

__all__ = ["greedy_generate", "make_decode_step", "make_prefill_step"]
