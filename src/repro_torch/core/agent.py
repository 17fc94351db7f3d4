"""Agent base classes (paper §6.1, §6.3), port of ``repro/core/agent.py``.

Agents are functional: parameters and recurrent state are explicit
arguments, and the randomness of a step comes from the ``torch.Generator``
it is given.  All agents receive (observation, prev_action, prev_reward)
per the paper (§6.3); feed-forward agents simply ignore the extras.
"""
from __future__ import annotations

import copy
from typing import Callable

from torch.utils import _pytree as pytree

from .narrtup import namedarraytuple
from .tree import tree_concat

AgentInputs = namedarraytuple("AgentInputs", ["observation", "prev_action", "prev_reward"])
AgentStep = namedarraytuple("AgentStep", ["action", "agent_info"])


class Agent:
    """Base agent: wraps a model apply-fn and a distribution.

    Subclasses define:
      init_params(generator) -> params
      step(params, generator, agent_inputs, state) -> (AgentStep, new_state)
      value(params, agent_inputs, state)      (for bootstrapping, PG algos)

    Modes (paper §2.1): rlpyt agents switch between ``sample_mode`` during
    training and ``eval_mode`` for periodic offline evaluation in dedicated
    eval envs.  Functional agents can't flip internal flags, so the mode is
    a second step function: ``eval_step`` has the same signature as ``step``
    but acts greedily/deterministically (argmax logits, distribution mean,
    epsilon=0) — ``as_eval`` below selects it.  ``samplers/eval.py`` builds
    its rollout on the eval-mode agent.
    """

    recurrent = False
    eval_step = None  # greedy/deterministic counterpart of ``step``

    def __init__(self, model_init: Callable, model_apply: Callable, distribution):
        self.model_init = model_init
        self.model_apply = model_apply
        self.distribution = distribution

    def init_params(self, generator):
        return self.model_init(generator)

    def initial_state(self, batch_size: int, **kwargs):
        """Recurrent agents override; feed-forward returns None."""
        return None

    def step(self, params, generator, agent_inputs, state=None):
        raise NotImplementedError

    def value(self, params, agent_inputs, state=None):
        raise NotImplementedError


def as_eval(agent):
    """The agent in evaluation mode: same interface, greedy/deterministic
    action selection (paper §2.1 offline evaluation).

    Works structurally on anything with a ``step`` and an optional
    ``eval_step`` — class-based Agents and AgentDef namedtuples alike.
    Agents that declare no ``eval_step`` are returned unchanged (their
    sampling behavior is already their evaluation behavior, e.g. a
    random-action baseline)."""
    eval_step = getattr(agent, "eval_step", None)
    if eval_step is None:
        return agent
    if hasattr(agent, "_replace"):  # AgentDef and friends
        return agent._replace(step=eval_step)
    out = copy.copy(agent)
    out.step = eval_step
    return out


class AlternatingAgentMixin:
    """Paper §2.1 'Alternating-GPU' sampling: two env groups ping-pong so env
    stepping of one group overlaps action selection of the other.  The mixin
    provides the half-batch bookkeeping of the alternating sampler."""

    def split_half(self, tree):
        half = pytree.tree_leaves(tree)[0].shape[0] // 2
        first = pytree.tree_map(lambda x: x[:half], tree)
        second = pytree.tree_map(lambda x: x[half:], tree)
        return first, second

    def join_halves(self, a, b):
        return tree_concat([a, b], axis=0)
