"""The port's engine, plan and app protocol."""
from .engine import DATA_AXIS, EngineCarry, StradsEngine, resolve_device
from .plan import EXECUTORS, ExecutionPlan, ExecutionReport
from .primitives import RoundResult, StradsAppBase, tree_psum

__all__ = ["DATA_AXIS", "EXECUTORS", "EngineCarry", "ExecutionPlan",
           "ExecutionReport", "RoundResult", "StradsAppBase", "StradsEngine",
           "resolve_device", "tree_psum"]
