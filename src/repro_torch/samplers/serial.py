"""Serial sampler (paper §2.1), port of ``repro/samplers/serial.py``.

Agent and batched envs on one device: a Python loop over the horizon
replaces JAX's ``lax.scan``, the env batch dim replaces its ``vmap``, and
action selection stays batched on the device.  Produces a time-major (T, B)
RolloutBatch with agent_info (logp/value or q) and per-episode return tracking
(TrajectoryInfo of §6.1) carried in the state as device tensors, so a
collect never waits for the device.  The state's ``generator`` supplies
the agent's and the envs' randomness and is advanced in place.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils import _pytree as pytree

from ..core.narrtup import namedarraytuple

F32 = torch.float32

RolloutBatch = namedarraytuple(
    "RolloutBatch",
    ["observation", "prev_action", "prev_reward", "action", "reward", "done",
     "timeout", "next_observation", "agent_info"])


class SamplerState(NamedTuple):
    env_state: Any
    obs: Any
    prev_action: Any
    prev_reward: Any
    agent_state: Any
    generator: Any
    # TrajectoryInfo accumulators
    ep_return: Any
    ep_len: Any
    completed_return_sum: Any
    completed_len_sum: Any
    completed_count: Any


class SerialSampler:
    def __init__(self, env_spec, agent, n_envs: int, horizon: int):
        self.env = env_spec
        self.agent = agent
        self.n_envs = n_envs
        self.horizon = horizon

    def init(self, generator, agent_state_kwargs=None) -> SamplerState:
        """Reset the envs on ``generator``'s device; the state keeps the
        generator for every later collect."""
        dev = generator.device
        B = self.n_envs
        env_state, obs = self.env.reset(B, generator)
        null = torch.as_tensor(self.env.action_space.null_value())
        act0 = torch.zeros((B,) + tuple(null.shape), dtype=null.dtype,
                           device=dev)
        agent_state = self.agent.initial_state(
            B, device=dev, **(agent_state_kwargs or {}))
        return SamplerState(
            env_state=env_state, obs=obs,
            prev_action=act0, prev_reward=torch.zeros((B,), dtype=F32, device=dev),
            agent_state=agent_state, generator=generator,
            ep_return=torch.zeros((B,), dtype=F32, device=dev),
            ep_len=torch.zeros((B,), dtype=torch.int32, device=dev),
            completed_return_sum=torch.zeros((), dtype=F32, device=dev),
            completed_len_sum=torch.zeros((), dtype=F32, device=dev),
            completed_count=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def select(self, params, s: SamplerState):
        """Action selection on the current obs; returns (action, info, s')."""
        action, info, agent_state = self.agent.step(
            params, s.generator, s.obs, s.prev_action, s.prev_reward,
            s.agent_state)
        return action, info, s._replace(agent_state=agent_state)

    def step_envs(self, s: SamplerState, action, info):
        """Step the envs with a selected action; returns (s', the step's
        RolloutBatch)."""
        B = self.n_envs
        env_state, obs2, reward, done, env_info = self.env.step(
            s.env_state, action, s.generator)
        # episode bookkeeping (TrajectoryInfo)
        ep_return = s.ep_return + reward
        ep_len = s.ep_len + 1
        d = done.to(F32)
        completed_return_sum = s.completed_return_sum + torch.sum(d * ep_return)
        completed_len_sum = s.completed_len_sum + torch.sum(d * ep_len)
        completed_count = s.completed_count + torch.sum(done,
                                                        dtype=torch.int32)
        ep_return = ep_return * (1.0 - d)
        ep_len = ep_len * (1 - done.to(torch.int32))
        out = RolloutBatch(
            observation=s.obs, prev_action=s.prev_action,
            prev_reward=s.prev_reward, action=action, reward=reward,
            done=done, timeout=env_info.timeout,
            next_observation=env_info.terminal_obs, agent_info=info)
        # prev_action/reward reset to null at episode boundary (paper §6.3)
        nd = 1.0 - d
        # in the dtype the state began with (the action space's null value),
        # as JAX's carry keeps its dtype
        prev_action = (action * nd.to(action.dtype).reshape(
            (B,) + (1,) * (action.dim() - 1))).to(s.prev_action.dtype)
        prev_reward = reward * nd
        return SamplerState(env_state, obs2, prev_action, prev_reward,
                            s.agent_state, s.generator, ep_return, ep_len,
                            completed_return_sum, completed_len_sum,
                            completed_count), out

    @torch.no_grad()
    def collect(self, params, state: SamplerState):
        """One sampling batch: returns (state', RolloutBatch (T, B))."""
        s = state
        steps = []
        for _ in range(self.horizon):
            action, info, s = self.select(params, s)
            s, out = self.step_envs(s, action, info)
            steps.append(out)
        batch = pytree.tree_map(lambda *xs: torch.stack(xs), *steps)
        return s, batch

    @torch.no_grad()
    def bootstrap_value(self, params, state: SamplerState):
        return self.agent.value(params, state.obs, state.prev_action,
                                state.prev_reward, state.agent_state)

    @staticmethod
    def traj_stats(state: SamplerState):
        n = torch.clamp(state.completed_count, min=1).to(F32)
        return {"avg_return": state.completed_return_sum / n,
                "avg_len": state.completed_len_sum / n,
                "episodes": state.completed_count}

    @staticmethod
    def full_agent_state(state: SamplerState):
        """Agent recurrent state at the CURRENT batch boundary, full width."""
        return state.agent_state

    @staticmethod
    def reset_stats(state: SamplerState) -> SamplerState:
        z = state.completed_return_sum
        return state._replace(
            completed_return_sum=torch.zeros_like(z),
            completed_len_sum=torch.zeros_like(z),
            completed_count=torch.zeros_like(state.completed_count))
