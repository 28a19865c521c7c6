"""Architecture registry: ``get_config("<arch-id>")`` returns the exact
assigned :class:`ModelConfig`; ``ARCHS`` lists all ten ids."""
from __future__ import annotations

import importlib

from .base import ModelConfig, InputShape, INPUT_SHAPES  # noqa: F401

ARCHS = (
    "zamba2-2.7b",
    "llama4-maverick-400b-a17b",
    "chatglm3-6b",
    "internvl2-1b",
    "stablelm-3b",
    "granite-3-2b",
    "minicpm-2b",
    "hubert-xlarge",
    "xlstm-125m",
    "phi3.5-moe-42b-a6.6b",
)

_MODULE_OF = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULE_OF:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    mod = importlib.import_module(f".{_MODULE_OF[arch]}", __package__)
    return mod.CONFIG
