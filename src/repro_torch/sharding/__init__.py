"""Layout helpers kept from the JAX package's sharding rules."""
from .rules import (MODEL_AXIS_SIZE, pad_to_multiple, padded_heads,
                    padded_vocab)

__all__ = ["MODEL_AXIS_SIZE", "pad_to_multiple", "padded_heads",
           "padded_vocab"]
