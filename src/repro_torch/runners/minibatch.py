"""Synchronous runners (paper §2.2 arrangement, Fig. 2), port of
``repro/runners/minibatch.py``: thin shells over the TrainLoop, fused by
default (one CUDA graph replay an iteration on the card; ``fuse=False``
runs each iteration eagerly), as JAX's shells compile a window by
default.

OnPolicyRunner: collect -> update.  OffPolicyRunner: collect -> insert into
a device-resident ReplayLike -> k updates (the paper's replay-ratio knob),
after a warm-up that fills the replay to ``min_replay`` through the same
collect+insert.  Both feed the algorithm through its declarative BatchSpec.
Both train on the card unless the caller asks for the CPU, and raise
without one.  With ``ckpt_dir`` / ``ckpt_interval`` the loop saves a
checkpoint (the train state; off-policy, the train and replay states) every
``ckpt_interval`` iterations, and ``run(restore=True)`` resumes from the
latest one at its iteration.  The mesh waits for ROADMAP Queue 1 item 12.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..replay.interface import DeviceReplay, ReplayLike, transition_example
from ..train.checkpoint import latest_step, restore_checkpoint
from ..utils.logger import Logger
from .train_loop import TrainLoop


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
                 fuse: bool = True, eval_sampler=None,
                 sentinels: bool = False, nan_guard: bool = False):
        self.sampler, self.algo = sampler, algo
        self.n_iterations = n_iterations
        self.log_interval = log_interval
        self.logger = logger or Logger()
        self.ckpt_dir, self.ckpt_interval = ckpt_dir, ckpt_interval
        self.eval_sampler = eval_sampler
        self.loop = TrainLoop(sampler, algo, fuse=fuse, sentinels=sentinels,
                              nan_guard=nan_guard)

    def run(self, seed: int, params=None, restore: bool = False, *,
            device="cuda"):
        """Train from ``seed`` on ``device`` (with ``restore``, from the
        latest checkpoint in ``ckpt_dir`` and its iteration, if there is
        one); returns (train_state, sampler_state, last_info)."""
        gens = _generators(seed, device)
        if params is None:
            params = self.sampler.agent.init_params(gens[0])
        train_state = self.algo.init_train_state(gens[0], params)
        start_iter = 0
        if restore and self.ckpt_dir and latest_step(self.ckpt_dir) is not None:
            train_state, manifest = restore_checkpoint(
                self.ckpt_dir, train_state, device=device)
            start_iter = manifest["extra"].get("iteration", 0)
        sampler_state = self.sampler.init(gens[1])
        train_state, sampler_state, _, last_info = self.loop.drive(
            gens[2], train_state, sampler_state, None,
            n_iterations=self.n_iterations, log_interval=self.log_interval,
            logger=self.logger, start_iter=start_iter,
            ckpt_dir=self.ckpt_dir, ckpt_interval=self.ckpt_interval,
            eval_sampler=self.eval_sampler)
        return train_state, sampler_state, last_info


class OffPolicyRunner:
    """DQN / DDPG / TD3 / SAC over a device-resident ReplayLike, one
    iteration at a time."""

    def __init__(self, sampler, algo, *, replay_capacity: int,
                 batch_size: int, n_iterations: int, updates_per_collect: int = 1,
                 min_replay: int = 1000, prioritized: bool = False,
                 beta: float = 0.4,
                 log_interval: int = 10, logger: Optional[Logger] = None,
                 ckpt_dir: Optional[str] = None, ckpt_interval: int = 0,
                 agent_state_kwargs: Optional[dict] = None,
                 replay: Optional[ReplayLike] = None, fuse: bool = True):
        self.sampler, self.algo = sampler, algo
        self.n_iterations = n_iterations
        self.min_replay = min_replay
        self.log_interval = log_interval
        self.logger = logger or Logger()
        self.ckpt_dir, self.ckpt_interval = ckpt_dir, ckpt_interval
        self.agent_state_kwargs = agent_state_kwargs or {}
        self.replay = replay if replay is not None else DeviceReplay(
            replay_capacity, prioritized=prioritized, beta=beta)
        self.loop = TrainLoop(sampler, algo, replay=self.replay,
                              batch_size=batch_size,
                              updates_per_collect=updates_per_collect,
                              fuse=fuse)
        self.replay_state = None

    def run(self, seed: int, params=None, restore: bool = False, *,
            device="cuda"):
        """Train from ``seed`` on ``device``; returns (train_state,
        sampler_state, last_info) and keeps the final replay state in
        ``self.replay_state``.  Parameters, sampler and replay draw from three
        generators seeded ``seed``, ``seed + 1`` and ``seed + 2``.  With
        ``restore`` the train and replay states come from the latest
        checkpoint in ``ckpt_dir`` (if there is one), training resumes at its
        iteration, and the warm-up is skipped when the restored replay
        already holds ``min_replay`` transitions."""
        device = torch.device(device)
        gens = _generators(seed, device)
        if params is None:
            params = self.sampler.agent.init_params(gens[0])
        train_state = self.algo.init_train_state(gens[0], params)
        sampler_state = self.sampler.init(gens[1], self.agent_state_kwargs)
        replay_state = self.replay.init(
            transition_example(self.sampler.env, device=device))
        start_iter, warm = 0, 0
        if restore and self.ckpt_dir and latest_step(self.ckpt_dir) is not None:
            (train_state, replay_state), manifest = restore_checkpoint(
                self.ckpt_dir, (train_state, replay_state), device=device)
            start_iter = manifest["extra"].get("iteration", 0)
            warm = int(replay_state.filled)

        # fill to min_replay before training, through the same collect+insert
        steps_per_iter = self.sampler.horizon * self.sampler.n_envs
        while warm < self.min_replay:
            sampler_state, replay_state = self.loop.collect_insert(
                train_state.params, sampler_state, replay_state)
            warm += steps_per_iter
        train_state, sampler_state, replay_state, last_info = self.loop.drive(
            gens[2], train_state, sampler_state, replay_state,
            n_iterations=self.n_iterations, log_interval=self.log_interval,
            logger=self.logger, start_iter=start_iter,
            ckpt_dir=self.ckpt_dir, ckpt_interval=self.ckpt_interval,
            ckpt_payload=lambda ts, rs: (ts, rs))
        self.replay_state = replay_state
        return train_state, sampler_state, last_info
