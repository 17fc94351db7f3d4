"""One replay interface (init/insert/sample/update_priorities) so runners
are replay-backend-agnostic; port of the device-resident part of
``repro/replay/interface.py``.

``DeviceReplay`` is the torch ring of ``replay/device.py`` on the device.
It speaks RolloutBatch on insert and returns ``(sample, indices,
is_weights)`` from ``sample``, so the runner's only other contact with
replay data is ``make_algo_batch(algo.batch_spec, sample, ...)``.  The host
buffers (``HostTransitionReplay``, ``HostSequenceReplay``), ``LockedReplay``
and the sharded views wait for the async and distributed slices.
"""
from __future__ import annotations

from typing import Any

import torch

from ..core.batch_spec import rollout_to_transitions
from . import device as dreplay

F32 = torch.float32


def transition_example(env, *, device="cpu") -> dict:
    """Single-transition tree (no batch dim) describing what one slot of a
    transition replay stores for ``env`` — the init-time example."""
    obs = torch.as_tensor(env.observation_space.null_value(), device=device)
    act = torch.as_tensor(env.action_space.null_value(), device=device)
    return {
        "observation": obs,
        "action": act,
        "reward": torch.zeros((), dtype=F32, device=device),
        "done": torch.zeros((), dtype=torch.bool, device=device),
        "timeout": torch.zeros((), dtype=torch.bool, device=device),
        "next_observation": obs,
    }


class ReplayLike:
    """The contract runners program against.

    init(example) -> state
    insert(state, rollout, **extras) -> state
    sample(state, generator, batch_size) -> (sample, indices, is_weights)
    update_priorities(state, indices, *priorities) -> state

    ``device_resident`` says whether the state lives on the device (and the
    sampled batch with it).
    """

    device_resident: bool = False

    def init(self, example) -> Any:
        raise NotImplementedError

    def insert(self, state, rollout, **extras):
        raise NotImplementedError

    def sample(self, state, generator, batch_size: int):
        raise NotImplementedError

    def update_priorities(self, state, indices, *priorities):
        raise NotImplementedError


class DeviceReplay(ReplayLike):
    """Torch ring + sum tree on the example's device."""

    device_resident = True

    def __init__(self, capacity: int, *, prioritized: bool = False,
                 alpha: float = 0.6, beta: float = 0.4):
        self.capacity = capacity
        self.prioritized = prioritized
        self.alpha, self.beta = alpha, beta

    def init(self, example) -> dreplay.ReplayState:
        device = next(iter(example.values())).device
        return dreplay.init_replay(example, self.capacity, device=device)

    def insert(self, state, rollout, **extras):
        return dreplay.insert(state, rollout_to_transitions(rollout))

    def sample(self, state, generator, batch_size: int, *, draws=None):
        return dreplay.sample(state, generator, batch_size,
                              uniform=not self.prioritized, beta=self.beta,
                              draws=draws)

    def update_priorities(self, state, indices, *priorities):
        if not self.prioritized:
            return state
        (td_abs,) = priorities
        return dreplay.update_priorities(state, indices, td_abs,
                                         alpha=self.alpha)
