"""Concrete agents (paper §6.1): model + distribution -> step function.

Port of the categorical policy-gradient and DQN agents of
``repro/agents.py``.  An agent step is a function
    step(params, generator, obs, prev_action, prev_reward, state)
        -> (action, agent_info dict, new_state)
that the serial sampler calls once per env step on a (B, ...) batch; the
randomness comes from the ``torch.Generator`` it is given.  The PG,
continuous-control and recurrent agents wait for their slices.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .core.distributions import Categorical, EpsilonGreedy

F32 = torch.float32


class AgentDef(NamedTuple):
    init_params: Callable          # generator -> params
    step: Callable                 # (params, gen, obs, pa, pr, state) -> (a, info, state)
    value: Callable                # (params, obs, pa, pr, state) -> value (bootstrap)
    initial_state: Callable        # (batch, *, device, **kw) -> state (None for feed-forward)
    recurrent: bool = False
    # greedy/deterministic counterpart of ``step`` for offline evaluation
    # (paper §2.1 eval mode); same signature.
    eval_step: Optional[Callable] = None


def make_categorical_pg_agent(model) -> AgentDef:
    """A2C/PPO agent over Discrete actions; info: logp, value."""
    dist = Categorical(dim=None)

    def step(params, generator, obs, prev_action, prev_reward, state):
        logits, value = model.apply(params, obs, prev_action, prev_reward)
        action = dist.sample(generator, logits)
        logp = dist.log_likelihood(action, logits)
        return action, {"logp": logp, "value": value}, state

    def value(params, obs, prev_action, prev_reward, state):
        _, v = model.apply(params, obs, prev_action, prev_reward)
        return v

    def eval_step(params, generator, obs, prev_action, prev_reward, state):
        logits, value = model.apply(params, obs, prev_action, prev_reward)
        action = dist.mode(logits)
        logp = dist.log_likelihood(action, logits)
        return action, {"logp": logp, "value": value}, state

    return AgentDef(model.init, step, value, model.initial_state,
                    eval_step=eval_step)


def make_dqn_agent(model, n_actions: int, *, n_atoms: int = 0,
                   v_min=-10.0, v_max=10.0) -> AgentDef:
    """Epsilon-greedy DQN agent; epsilon is carried in the agent state as a
    (B,) vector (Ape-X style)."""
    eg = EpsilonGreedy(n_actions)

    def q_values(params, obs, prev_action, prev_reward):
        q = model.apply(params, obs, prev_action, prev_reward)
        if n_atoms:
            support = torch.linspace(v_min, v_max, n_atoms, dtype=q.dtype,
                                     device=q.device)
            q = torch.sum(torch.softmax(q, dim=-1) * support, dim=-1)
        return q

    def step(params, generator, obs, prev_action, prev_reward, state):
        """state: dict with 'epsilon' scalar or (B,) vector."""
        q = q_values(params, obs, prev_action, prev_reward)
        action = eg.sample(generator, q, state["epsilon"])
        return action, {"q": q}, state

    def value(params, obs, prev_action, prev_reward, state):
        return torch.amax(q_values(params, obs, prev_action, prev_reward), dim=-1)

    def initial_state(batch, epsilon=0.05, *, device="cpu"):
        return {"epsilon": torch.full((batch,), epsilon, dtype=F32,
                                      device=device)}

    def eval_step(params, generator, obs, prev_action, prev_reward, state):
        """Greedy (epsilon=0) — the paper evaluates DQN near-greedily."""
        q = q_values(params, obs, prev_action, prev_reward)
        return torch.argmax(q, dim=-1), {"q": q}, state

    return AgentDef(model.init, step, value, initial_state,
                    eval_step=eval_step)
