"""Architecture registry: ``--arch <id>`` resolves here.

Each module defines ``config()`` (the exact published configuration) and
``smoke_config()`` (a reduced same-family configuration for CPU tests).
Only the archs the PyTorch port runs are listed (gemma2-2b and
mamba2-1.3b, each served and trained); the rest of the JAX package's zoo
is still to be ported (see ROADMAP.md).
"""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCH_IDS = ("gemma2_2b", "mamba2_1p3b")

# public ids -> module names
ALIASES = {"gemma2-2b": "gemma2_2b", "mamba2-1.3b": "mamba2_1p3b"}


def resolve(arch: str) -> str:
    aid = ALIASES.get(arch, arch.replace("-", "_").replace(".", "p"))
    if aid not in ARCH_IDS:
        raise ValueError(f"arch {arch!r} is not ported to repro_torch yet "
                         f"(ported: {ARCH_IDS})")
    return aid


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f".{resolve(arch)}", __package__)
    return mod.config()


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f".{resolve(arch)}", __package__)
    return mod.smoke_config()
