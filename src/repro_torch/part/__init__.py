"""The partitioning subsystem of the port: the :class:`PartitionerSpec`
a plan carries, the :class:`Assignment` value the engine owns and
checkpoints, the :class:`Partitioner` protocol, and the three policies
behind :func:`build_partitioner` (host numpy, as in the JAX package)."""
from .spec import PARTITIONER_KINDS, PartitionerSpec
from .assignment import Assignment, contiguous_assignment
from .protocol import Partitioner, PartitionerBase, greedy_balance
from .partitioners import (LoadBalancedPartitioner, SizeBalancedPartitioner,
                           StaticPartitioner, build_partitioner)

__all__ = [
    "PARTITIONER_KINDS", "PartitionerSpec", "Assignment",
    "contiguous_assignment", "Partitioner", "PartitionerBase",
    "greedy_balance", "LoadBalancedPartitioner",
    "SizeBalancedPartitioner", "StaticPartitioner", "build_partitioner",
]
