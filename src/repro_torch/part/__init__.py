"""Partitioning specs of the port (the partitioners themselves are still
to be ported: ROADMAP.md queue 1, step 6)."""
from .spec import PARTITIONER_KINDS, PartitionerSpec

__all__ = ["PARTITIONER_KINDS", "PartitionerSpec"]
