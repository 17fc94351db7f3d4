"""Architecture registry: ``--arch <id>`` resolves here.

Each module defines ``config()`` (the exact published configuration) and
``smoke_config()`` (a reduced same-family configuration for CPU tests).
Every arch of the JAX package's zoo: the dense configs (gemma2-2b,
glm4-9b, phi3-mini-3.8b, granite-34b), the moe ones (qwen2-moe-a2.7b,
mixtral-8x7b), mamba2-1.3b (ssm), zamba2-7b (hybrid),
llama-3.2-vision-90b (vlm) and whisper-medium (encdec).
"""
from __future__ import annotations

import importlib

from ..models.config import SHAPES, ModelConfig, ShapeCell  # noqa: F401

ARCH_IDS = (
    "mamba2_1p3b",
    "llama32_vision_90b",
    "qwen2_moe_a2p7b",
    "mixtral_8x7b",
    "gemma2_2b",
    "glm4_9b",
    "granite_34b",
    "phi3_mini_3p8b",
    "whisper_medium",
    "zamba2_7b",
)

# public ids -> module names
ALIASES = {
    "mamba2-1.3b": "mamba2_1p3b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "gemma2-2b": "gemma2_2b",
    "glm4-9b": "glm4_9b",
    "granite-34b": "granite_34b",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "whisper-medium": "whisper_medium",
    "zamba2-7b": "zamba2_7b",
}

# long_500k applicability: sub-quadratic only
LONG_CONTEXT_OK = {
    "mamba2_1p3b",   # SSM, O(1) state
    "zamba2_7b",     # hybrid; shared-attn KV sharded over (data, model)
    "gemma2_2b",     # alternating local(4k window)/global
    "mixtral_8x7b",  # SWA rolling KV, window 4k
}


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


def cells(arch: str):
    """The (shape) cells assigned to this arch, honoring long_500k skips."""
    aid = resolve(arch)
    return [s for s in SHAPES
            if s.name != "long_500k" or aid in LONG_CONTEXT_OK]


def skipped_cells(arch: str):
    aid = resolve(arch)
    return [s for s in SHAPES
            if s.name == "long_500k" and aid not in LONG_CONTEXT_OK]
