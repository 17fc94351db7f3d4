"""DDPG (paper §1.1 Q-value policy-gradient family), port of
``repro/algos/qpg/ddpg.py``.

Deterministic actor mu(s), critic Q(s,a), Polyak target networks.  Batches
come from the replay buffer with time-limit-aware bootstrap masks (paper
footnote 3: bootstrap on timeout using the TRUE pre-reset next obs).

``update`` steps the critic, then the actor against the UPDATED critic, as
JAX does; both optimizers write their params IN PLACE.  The target networks
are a copy of the params made at init (never an alias: the in-place steps
would move them with the online nets) and are replaced each update by the
new f32 tensors of ``soft_update``.  The target side of the critic loss runs
under ``torch.no_grad()``, the counterpart of JAX's ``stop_gradient``.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from ...core.algorithm import OptInfo, TrainState, grads_of
from ...core.batch_spec import BatchSpec
from ...train.optim import Optimizer, soft_update
from ..dqn.dqn import Q_TRANSITION_FIELDS

F32 = torch.float32


def copy_params(params):
    """A detached copy of every leaf: the target networks at init."""
    return pytree.tree_map(lambda p: p.detach().clone(), params)


def bellman_target(batch, gamma: float, v_next):
    """return_ + gamma^n_used * bootstrap * v_next (no gradient)."""
    disc = gamma ** batch["n_used"].to(F32)
    return batch["return_"] + disc * batch["bootstrap"] * v_next


class DDPG:
    batch_spec = BatchSpec("transition", Q_TRANSITION_FIELDS,
                           priority_keys=("td_abs",))

    def __init__(self, actor_fn: Callable, critic_fn: Callable,
                 actor_opt: Optimizer, critic_opt: Optimizer, *,
                 gamma=0.99, tau=0.005):
        self.actor = actor_fn    # (params, obs) -> action in [-1,1]
        self.critic = critic_fn  # (params, obs, act) -> (n_critics, B)
        self.actor_opt, self.critic_opt = actor_opt, critic_opt
        self.gamma, self.tau = gamma, tau

    def init_train_state(self, generator, params) -> TrainState:
        """params: {"actor": ..., "critic": ...}"""
        return TrainState(
            step=0, params=params,
            opt_state={
                "actor": self.actor_opt.init(pytree.tree_leaves(params["actor"])),
                "critic": self.critic_opt.init(
                    pytree.tree_leaves(params["critic"]))},
            extra={"target": copy_params(params)})

    def critic_loss(self, critic_params, target, batch):
        with torch.no_grad():
            nobs = batch["next_observation"]
            a_next = self.actor(target["actor"], nobs)
            v_next = self.critic(target["critic"], nobs, a_next)[0]
            y = bellman_target(batch, self.gamma, v_next)
        q = self.critic(critic_params, batch["observation"], batch["action"])[0]
        td = q - y
        return (torch.mean(batch["is_weights"] * torch.square(td)),
                {"td_abs": torch.abs(td)})

    def actor_loss(self, actor_params, critic_params, batch):
        a = self.actor(actor_params, batch["observation"])
        q = self.critic(critic_params, batch["observation"], a)[0]
        return -torch.mean(q), {}

    def update(self, train_state: TrainState, batch, generator=None):
        p, targ = train_state.params, train_state.extra["target"]
        c_loss, c_aux, c_grads = grads_of(self.critic_loss, p["critic"], targ,
                                          batch)
        _, c_opt, c_gnorm = self.critic_opt.update(
            c_grads, train_state.opt_state["critic"],
            pytree.tree_leaves(p["critic"]))
        a_loss, _, a_grads = grads_of(self.actor_loss, p["actor"],
                                      p["critic"], batch)
        _, a_opt, _ = self.actor_opt.update(
            a_grads, train_state.opt_state["actor"],
            pytree.tree_leaves(p["actor"]))
        ts = TrainState(step=train_state.step + 1, params=p,
                        opt_state={"actor": a_opt, "critic": c_opt},
                        extra={"target": soft_update(targ, p, self.tau)})
        return ts, OptInfo(loss=c_loss, grad_norm=c_gnorm,
                           extra={"actor_loss": a_loss, **c_aux})
