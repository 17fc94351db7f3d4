"""Synchronous runners (paper §2.2 arrangement, Fig. 2), port of
``repro/runners/minibatch.py``: thin shells over the per-iteration
TrainLoop.

OnPolicyRunner: collect -> update.  OffPolicyRunner: collect -> insert into
a device-resident ReplayLike -> k updates (the paper's replay-ratio knob),
after a warm-up that fills the replay to ``min_replay`` through the same
collect+insert.  Both feed the algorithm through its declarative BatchSpec.
Both train on the card unless the caller asks for the CPU, and raise
without one.  Checkpoints and restore wait for ROADMAP Queue 1 item 8, the
mesh for item 12 (TrainLoop raises for them).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..replay.interface import DeviceReplay, ReplayLike, transition_example
from ..utils.logger import Logger
from .train_loop import TrainLoop, _not_ported


def _generators(seed: int, device):
    """Three generators on ``device``, seeded seed, seed+1 and seed+2 (params
    and train state, sampler, updates); raises for a CUDA device without
    a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda but no CUDA device is available; "
                           "pass device='cpu' to run the plain versions")
    return [torch.Generator(device=device).manual_seed(seed + i)
            for i in range(3)]


class OnPolicyRunner:
    """A2C/PPO: sampler batches feed the algorithm directly."""

    def __init__(self, sampler, algo, *, n_iterations: int,
                 log_interval: int = 10, logger: Optional[Logger] = None,
                 ckpt_dir: Optional[str] = None, ckpt_interval: int = 0,
                 eval_sampler=None, sentinels: bool = False,
                 nan_guard: bool = False):
        if ckpt_dir or ckpt_interval:
            raise _not_ported("checkpointing", "item 8")
        self.sampler, self.algo = sampler, algo
        self.n_iterations = n_iterations
        self.log_interval = log_interval
        self.logger = logger or Logger()
        self.eval_sampler = eval_sampler
        self.loop = TrainLoop(sampler, algo, sentinels=sentinels,
                              nan_guard=nan_guard)

    def run(self, seed: int, params=None, restore: bool = False, *,
            device="cuda"):
        """Train from ``seed`` on ``device``; returns (train_state,
        sampler_state, last_info)."""
        if restore:
            raise _not_ported("restore from a checkpoint", "item 8")
        gens = _generators(seed, device)
        if params is None:
            params = self.sampler.agent.init_params(gens[0])
        train_state = self.algo.init_train_state(gens[0], params)
        sampler_state = self.sampler.init(gens[1])
        train_state, sampler_state, _, last_info = self.loop.drive(
            gens[2], train_state, sampler_state, None,
            n_iterations=self.n_iterations, log_interval=self.log_interval,
            logger=self.logger, eval_sampler=self.eval_sampler)
        return train_state, sampler_state, last_info


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
        gens = _generators(seed, device)
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
