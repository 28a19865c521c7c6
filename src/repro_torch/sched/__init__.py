"""Scheduling policies of the port and the registry a
:class:`SchedulerSpec` resolves through."""
from .protocol import SchedulerBase
from .schedulers import (BlockStructuralScheduler, DynamicPriorityScheduler,
                         RandomScheduler, RotationScheduler,
                         RoundRobinScheduler, build_scheduler,
                         dependency_filter, priority_weights,
                         sample_candidates, structural_gram)
from .spec import SCHEDULER_KINDS, SchedulerSpec

__all__ = ["SCHEDULER_KINDS", "BlockStructuralScheduler",
           "DynamicPriorityScheduler", "RandomScheduler",
           "RotationScheduler", "RoundRobinScheduler", "SchedulerBase",
           "SchedulerSpec", "build_scheduler", "dependency_filter",
           "priority_weights", "sample_candidates", "structural_gram"]
