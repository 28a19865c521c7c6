"""Training and serving steps of the model zoo."""
from .losses import cross_entropy, token_accuracy
from .serve import greedy_generate, make_decode_step, make_prefill_step
from .step import (TrainConfig, init_strads_state, init_train_state,
                   make_strads_train_step, make_train_step)

__all__ = ["TrainConfig", "cross_entropy", "greedy_generate",
           "init_strads_state", "init_train_state", "make_decode_step",
           "make_prefill_step", "make_strads_train_step", "make_train_step",
           "token_accuracy"]
