"""Model zoo of the port: configs, layers, backbones, RL-scale models,
heads and sharding rules."""
from .config import ModelConfig, ShapeCell, SHAPES, pad_vocab  # noqa: F401
from . import layers, backbones, sharding, heads, rl_models  # noqa: F401
