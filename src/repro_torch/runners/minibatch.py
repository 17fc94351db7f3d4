"""Synchronous off-policy runner (paper §2.2 arrangement, Fig. 2), port of
``OffPolicyRunner`` in ``repro/runners/minibatch.py``: a thin shell over
the per-iteration TrainLoop.

collect -> insert into a device-resident ReplayLike -> k updates (the
paper's replay-ratio knob), after a warm-up that fills the replay to
``min_replay`` through the same collect+insert.  The algorithm is fed
through its declarative BatchSpec.  ``OnPolicyRunner`` waits for the PPO
half of slice 3; checkpoints, restore, the mesh and evaluation samplers for
their ROADMAP items (TrainLoop raises for them).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..replay.interface import DeviceReplay, ReplayLike, transition_example
from ..utils.logger import Logger
from .train_loop import TrainLoop


class OffPolicyRunner:
    """DQN over a device-resident ReplayLike, one iteration at a time."""

    def __init__(self, sampler, algo, *, replay_capacity: int,
                 batch_size: int, n_iterations: int, updates_per_collect: int = 1,
                 min_replay: int = 1000, prioritized: bool = False,
                 beta: float = 0.4,
                 log_interval: int = 10, logger: Optional[Logger] = None,
                 agent_state_kwargs: Optional[dict] = None,
                 replay: Optional[ReplayLike] = None):
        self.sampler, self.algo = sampler, algo
        self.n_iterations = n_iterations
        self.min_replay = min_replay
        self.log_interval = log_interval
        self.logger = logger or Logger()
        self.agent_state_kwargs = agent_state_kwargs or {}
        self.replay = replay if replay is not None else DeviceReplay(
            replay_capacity, prioritized=prioritized, beta=beta)
        self.loop = TrainLoop(sampler, algo, replay=self.replay,
                              batch_size=batch_size,
                              updates_per_collect=updates_per_collect)
        self.replay_state = None

    def run(self, seed: int, params=None, *, device="cuda"):
        """Train from ``seed`` on ``device``; returns (train_state,
        sampler_state, last_info) and keeps the final replay state in
        ``self.replay_state``.  Parameters, sampler and replay draw from three
        generators seeded ``seed``, ``seed + 1`` and ``seed + 2``."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device cuda but no CUDA device is available; "
                               "pass device='cpu' to run the plain versions")
        gens = [torch.Generator(device=device).manual_seed(seed + i)
                for i in range(3)]
        if params is None:
            params = self.sampler.agent.init_params(gens[0])
        train_state = self.algo.init_train_state(gens[0], params)
        sampler_state = self.sampler.init(gens[1], self.agent_state_kwargs)
        replay_state = self.replay.init(
            transition_example(self.sampler.env, device=device))

        # fill to min_replay before training, through the same collect+insert
        steps_per_iter = self.sampler.horizon * self.sampler.n_envs
        warm = 0
        while warm < self.min_replay:
            sampler_state, replay_state = self.loop.collect_insert(
                train_state.params, sampler_state, replay_state)
            warm += steps_per_iter
        train_state, sampler_state, replay_state, last_info = self.loop.drive(
            gens[2], train_state, sampler_state, replay_state,
            n_iterations=self.n_iterations, log_interval=self.log_interval,
            logger=self.logger)
        self.replay_state = replay_state
        return train_state, sampler_state, last_info
