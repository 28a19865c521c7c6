"""Checkpoints of the port: the JAX package's ``.npz`` layout."""
from .npz import latest_step, load_flat, restore_checkpoint, save_checkpoint

__all__ = ["latest_step", "load_flat", "restore_checkpoint",
           "save_checkpoint"]
