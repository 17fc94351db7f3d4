"""Env interface, port of ``repro/envs/base.py``.

step(state, action, generator) -> (state', obs, reward, done, EnvInfo)

- done marks an episode boundary; the state'/obs returned are ALREADY reset
  (auto-reset), so samplers never branch.
- EnvInfo.timeout flags time-limit termination (bootstrap value, don't treat
  as environment death).
- EnvInfo.terminal_obs is the PRE-reset next observation (== obs when not
  done).

The port's envs are batched: state, action, reward and done carry a leading
batch dim (JAX vmaps a single-env ``step`` instead), and ``reset(batch,
generator)`` / ``step`` draw their noise from the ``torch.Generator`` they
are given, on its device.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

from ..core.narrtup import namedarraytuple

EnvInfo = namedarraytuple("EnvInfo", ["timeout", "episode_step", "terminal_obs"])


class EnvSpec(NamedTuple):
    name: str
    reset: Callable          # (batch, generator) -> (state, obs)
    step: Callable           # (state, action, generator) -> (state, obs, reward, done, info)
    observation_space: Any
    action_space: Any
    max_episode_steps: int
