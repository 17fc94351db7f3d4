"""Concrete agents (paper §6.1): model + distribution -> step function.

Port of ``repro/agents.py``: categorical and Gaussian policy gradient,
DQN, the recurrent R2D1 agent, and the DDPG / TD3 and SAC actors.  An agent
step is a function
    step(params, generator, obs, prev_action, prev_reward, state)
        -> (action, agent_info dict, new_state)
that the serial sampler calls once per env step on a (B, ...) batch; the
randomness comes from the ``torch.Generator`` it is given.  The DDPG and
SAC agents take the algorithm's combined ``{"actor", "critic"}`` params (or
the actor's alone).  The recurrent R2D1 agent carries its LSTM state and
epsilon in the agent state and feeds its time-major model T = 1 slices.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .core.distributions import (Categorical, EpsilonGreedy, Gaussian,
                                 SquashedGaussian)

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


def make_gaussian_pg_agent(model, act_dim: int) -> AgentDef:
    """PPO-continuous agent (state obs); ``model.apply`` returns
    ((mean, log_std), value)."""
    dist = Gaussian(act_dim)

    def step(params, generator, obs, prev_action, prev_reward, state):
        (mean, log_std), value = model.apply(params, obs, prev_action,
                                             prev_reward)
        action = dist.sample(generator, mean, log_std)
        logp = dist.log_likelihood(action, mean, log_std)
        return action, {"logp": logp, "value": value}, state

    def value(params, obs, prev_action, prev_reward, state):
        _, v = model.apply(params, obs, prev_action, prev_reward)
        return v

    def eval_step(params, generator, obs, prev_action, prev_reward, state):
        (mean, log_std), value = model.apply(params, obs, prev_action,
                                             prev_reward)
        logp = dist.log_likelihood(mean, mean, log_std)
        return mean, {"logp": logp, "value": value}, state

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


def make_r2d1_agent(model, n_actions: int) -> AgentDef:
    """Recurrent epsilon-greedy agent: carries LSTM state (paper §6.3);
    model.apply is time-major — the sampler feeds T=1 slices."""
    eg = EpsilonGreedy(n_actions)

    def q_step(params, obs, prev_action, prev_reward, state):
        q, lstm_state = model.apply(params, obs[None], prev_action[None],
                                    prev_reward[None], state["lstm"])
        return q[0], {"lstm": lstm_state, "epsilon": state["epsilon"]}

    def step(params, generator, obs, prev_action, prev_reward, state):
        q, state = q_step(params, obs, prev_action, prev_reward, state)
        return eg.sample(generator, q, state["epsilon"]), {"q": q}, state

    def value(params, obs, prev_action, prev_reward, state):
        q, _ = q_step(params, obs, prev_action, prev_reward, state)
        return torch.amax(q, dim=-1)

    def initial_state(batch, epsilon=0.05, *, device="cpu"):
        return {"lstm": model.initial_state(batch, device=device),
                "epsilon": torch.full((batch,), epsilon, dtype=F32,
                                      device=device)}

    def eval_step(params, generator, obs, prev_action, prev_reward, state):
        q, state = q_step(params, obs, prev_action, prev_reward, state)
        return torch.argmax(q, dim=-1), {"q": q}, state

    return AgentDef(model.init, step, value, initial_state, recurrent=True,
                    eval_step=eval_step)


def _actor_params(params):
    return params["actor"] if isinstance(params, dict) and "actor" in params \
        else params


def _no_value(params, obs, prev_action, prev_reward, state):
    raise NotImplementedError("QPG agents bootstrap via the critic in the "
                              "algorithm")


def make_ddpg_agent(actor_model, act_dim: int, *, expl_noise=0.1) -> AgentDef:
    """Deterministic actor plus Gaussian exploration noise, clipped to
    [-1, 1] (DDPG / TD3)."""
    def step(params, generator, obs, prev_action, prev_reward, state):
        mu = actor_model.apply(_actor_params(params), obs)
        noise = expl_noise * torch.randn(mu.shape, generator=generator,
                                         device=mu.device, dtype=mu.dtype)
        return torch.clamp(mu + noise, -1.0, 1.0), {}, state

    def eval_step(params, generator, obs, prev_action, prev_reward, state):
        return actor_model.apply(_actor_params(params), obs), {}, state

    return AgentDef(actor_model.init, step, _no_value,
                    actor_model.initial_state, eval_step=eval_step)


def make_sac_agent(actor_model, act_dim: int) -> AgentDef:
    dist = SquashedGaussian(act_dim)

    def step(params, generator, obs, prev_action, prev_reward, state):
        mean, log_std = actor_model.apply(_actor_params(params), obs)
        action, logp = dist.sample_with_logprob(generator, mean, log_std)
        return action, {"logp": logp}, state

    def eval_step(params, generator, obs, prev_action, prev_reward, state):
        """Deterministic squashed mean (standard SAC evaluation policy)."""
        mean, _ = actor_model.apply(_actor_params(params), obs)
        action = torch.tanh(mean)
        return action, {"logp": torch.zeros(action.shape[:1], dtype=F32,
                                            device=action.device)}, state

    return AgentDef(actor_model.init, step, _no_value,
                    actor_model.initial_state, eval_step=eval_step)
