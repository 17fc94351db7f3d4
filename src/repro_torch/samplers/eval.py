"""Offline evaluation sampler (paper §2.1: "evaluation of the agent in
dedicated environment instances held separately from training"), port of
``repro/samplers/eval.py``.

At each log boundary fresh eval envs are reset from the eval generator and
run for ``max_steps // n_envs`` steps with the agent's greedy or
deterministic ``eval_step`` (core.agent.as_eval); completed episodes are
counted under both budgets —

- max_steps:    total env steps across the eval batch (the horizon);
- max_episodes: completed episodes counted toward the stats, in completion
  order (completions beyond the budget are masked out on the device,
  rlpyt's max-trajectories cutoff without a host round trip).

Same params and the same generator seed give the same metrics.  The
TrainLoop forks the eval generator from the training one (``fold_seed``),
so turning evaluation on changes no training draw.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.agent import as_eval
from ..telemetry import sentinels as sentinels_mod
from ..telemetry import trace
from .serial import SerialSampler

F32 = torch.float32
MASK64 = (1 << 64) - 1


def fold_seed(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (splitmix64 of their
    mix): the port's counterpart of ``jax.random.fold_in`` for generator
    seeds."""
    z = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return (z ^ (z >> 31)) >> 1


class EvalSampler:
    """Dedicated eval envs + eval-mode agent.

    n_envs eval envs run for max_steps // n_envs steps; up to
    ``max_episodes`` completed episodes feed the reported statistics
    (None = no episode cap).  ``agent_state_kwargs`` seeds the eval agent
    state."""

    def __init__(self, env_spec, agent, n_envs: int, max_steps: int, *,
                 max_episodes: Optional[int] = None,
                 agent_state_kwargs: Optional[dict] = None):
        if max_steps < n_envs:
            raise ValueError(f"max_steps {max_steps} < n_envs {n_envs}")
        self.env = env_spec
        self.agent = as_eval(agent)
        self.n_envs = n_envs
        self.horizon = max_steps // n_envs
        self.max_episodes = max_episodes
        self.agent_state_kwargs = agent_state_kwargs or {}
        self._sampler = SerialSampler(env_spec, self.agent, n_envs,
                                      self.horizon)

    def episode_stats(self, reward, done) -> dict:
        """Episode accounting on a collected (T, B) batch, honoring the
        episode budget in completion order (env order within a step)."""
        B = reward.shape[1]
        dev = reward.device
        ep_ret = torch.zeros((B,), dtype=F32, device=dev)
        ep_len = torch.zeros((B,), dtype=F32, device=dev)
        tot_ret = torch.zeros((), dtype=F32, device=dev)
        tot_len = torch.zeros((), dtype=F32, device=dev)
        count = torch.zeros((), dtype=torch.int32, device=dev)
        for r, d in zip(reward, done.to(F32)):
            ep_ret = ep_ret + r
            ep_len = ep_len + 1
            if self.max_episodes is None:
                counted = d
            else:
                # count at most ``room`` completions this step
                take = torch.cumsum(d, 0) <= self.max_episodes - count
                counted = d * take.to(F32)
            tot_ret = tot_ret + torch.sum(counted * ep_ret)
            tot_len = tot_len + torch.sum(counted * ep_len)
            count = count + torch.sum(counted).to(torch.int32)
            ep_ret = ep_ret * (1.0 - d)
            ep_len = ep_len * (1.0 - d)
        # If NO episode finished inside the step budget (a strong policy can
        # outlive max_steps), fall back to the budget-truncated returns so
        # the metric reflects "at least this good" instead of reading 0;
        # ``episodes == 0`` flags the truncation.
        n = torch.clamp(count, min=1).to(F32)
        none_done = count == 0
        return {"avg_return": torch.where(none_done, ep_ret.mean(),
                                          tot_ret / n),
                "avg_len": torch.where(none_done, ep_len.mean(), tot_len / n),
                "episodes": count}

    @torch.no_grad()
    def run(self, params, generator) -> dict:
        """Evaluate ``params`` on envs reset from ``generator``; returns
        scalar metrics (0-d device tensors)."""
        with trace.get_tracer().span("eval_sampler.run"):
            state = self._sampler.init(generator, self.agent_state_kwargs)
            _, batch = self._sampler.collect(params, state)
            out = self.episode_stats(batch.reward, batch.done)
            dev = batch.reward.device
            out["steps"] = torch.full((), self.horizon * self.n_envs,
                                      dtype=torch.int32, device=dev)
            # evaluation is where silently corrupted params first become
            # visible off the training stream
            out["param_nonfinite"] = sentinels_mod.count_nonfinite(params)
            return out
