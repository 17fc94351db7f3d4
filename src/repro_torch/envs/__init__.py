"""Environments of the port, batched torch counterparts of ``repro/envs``
(CartPole, Pendulum, Catch and the token MDP of LM-PPO training).

Every env is a pair of functions (reset, step) over explicit state dicts of
(B,) tensors.  ``step`` auto-resets on done (the returned obs is the first
obs of the next episode), and env_info is a namedarraytuple with the SAME
fields every step, including ``timeout`` for time-limit value bootstrapping.
"""
from .base import EnvSpec, EnvInfo  # noqa: F401
from .cartpole import make_cartpole
from .catch import make_catch
from .pendulum import make_pendulum
from .token_lm import make_token_lm

REGISTRY = {
    "cartpole": make_cartpole,
    "pendulum": make_pendulum,
    "catch": make_catch,
    "token_lm": make_token_lm,
}


def make_env(name: str, **kwargs) -> EnvSpec:
    return REGISTRY[name](**kwargs)
