"""SAC, the newer version per the paper (footnote 3): entropy auto-tuning,
twin critics, NO state-value function, and time-limit bootstrapping; port
of ``repro/algos/qpg/sac.py``.

``update`` keeps JAX's order: the critic steps first, its targets built
from next actions the OLD actor draws; the actor loss then reads the
UPDATED critic; the alpha loss uses the actor's logp with the gradient
stopped; last, the target critic is Polyak-averaged toward the new critic.
All three optimizers write in place; ``log_alpha`` is a 0-d tensor that
goes through the list-based Adam as a one-element list.  JAX splits its key
into one draw for the critic and one for the actor: ``update(noise=(n1,
n2))`` takes the two standard-normal draws of the action's shape (a test
passes JAX's), drawn from the generator when None.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
from torch.utils import _pytree as pytree

from ...core.algorithm import OptInfo, TrainState, grads_of
from ...core.batch_spec import BatchSpec
from ...core.distributions import SquashedGaussian
from ...train.optim import Optimizer, adam, soft_update
from ..dqn.dqn import Q_TRANSITION_FIELDS
from .ddpg import bellman_target, copy_params

F32 = torch.float32


class SAC:
    batch_spec = BatchSpec("transition", Q_TRANSITION_FIELDS,
                           priority_keys=("td_abs",))

    def __init__(self, actor_fn: Callable, critic_fn: Callable,
                 actor_opt: Optimizer, critic_opt: Optimizer, *,
                 act_dim: int, gamma=0.99, tau=0.005,
                 target_entropy=None, alpha_lr=3e-4, init_alpha=1.0):
        self.actor = actor_fn    # (params, obs) -> (mean, log_std)
        self.critic = critic_fn  # (params, obs, act) -> (n_critics, B)
        self.actor_opt, self.critic_opt = actor_opt, critic_opt
        self.gamma, self.tau = gamma, tau
        self.dist = SquashedGaussian(act_dim)
        self.target_entropy = (-float(act_dim) if target_entropy is None
                               else target_entropy)
        self.alpha_opt = adam(alpha_lr)
        self.init_alpha = init_alpha

    def init_train_state(self, generator, params) -> TrainState:
        dev = pytree.tree_leaves(params["critic"])[0].device
        log_alpha = torch.full((), math.log(self.init_alpha), dtype=F32,
                               device=dev)
        return TrainState(
            step=0, params=params,
            opt_state={
                "actor": self.actor_opt.init(pytree.tree_leaves(params["actor"])),
                "critic": self.critic_opt.init(
                    pytree.tree_leaves(params["critic"])),
                "alpha": self.alpha_opt.init([log_alpha])},
            extra={"target": {"critic": copy_params(params["critic"])},
                   "log_alpha": log_alpha})

    def critic_loss(self, critic_params, actor_params, target, log_alpha,
                    batch, noise):
        with torch.no_grad():
            nobs = batch["next_observation"]
            mean, log_std = self.actor(actor_params, nobs)
            a_next, logp_next = self.dist.sample_with_logprob_given(
                mean, log_std, noise)
            q_next = self.critic(target["critic"], nobs, a_next)
            v_next = torch.amin(q_next, dim=0) - torch.exp(log_alpha) * logp_next
            y = bellman_target(batch, self.gamma, v_next)
        qs = self.critic(critic_params, batch["observation"], batch["action"])
        td = qs - y[None]
        loss = torch.mean(batch["is_weights"][None] * torch.square(td))
        return loss, {"td_abs": torch.abs(td[0])}

    def actor_loss(self, actor_params, critic_params, log_alpha, batch, noise):
        mean, log_std = self.actor(actor_params, batch["observation"])
        a, logp = self.dist.sample_with_logprob_given(mean, log_std, noise)
        q = torch.amin(self.critic(critic_params, batch["observation"], a),
                       dim=0)
        loss = torch.mean(torch.exp(log_alpha) * logp - q)
        return loss, {"logp": logp}

    def alpha_loss(self, log_alpha, logp):
        return -torch.mean(torch.exp(log_alpha) *
                           (logp + self.target_entropy).detach()), {}

    def update(self, train_state: TrainState, batch, generator=None, *,
               noise=None):
        """``noise``: (critic draw, actor draw), each (B, act_dim) standard
        normal; drawn from ``generator`` when None."""
        if noise is None:
            act = batch["action"]
            noise = [torch.randn(act.shape, generator=generator,
                                 device=act.device, dtype=act.dtype)
                     for _ in range(2)]
        n1, n2 = noise
        p, extra = train_state.params, train_state.extra
        targ, log_alpha = extra["target"], extra["log_alpha"]
        opt = train_state.opt_state

        c_loss, c_aux, c_grads = grads_of(self.critic_loss, p["critic"],
                                          p["actor"], targ, log_alpha, batch,
                                          n1)
        _, c_opt, c_gnorm = self.critic_opt.update(
            c_grads, opt["critic"], pytree.tree_leaves(p["critic"]))

        a_loss, a_aux, a_grads = grads_of(self.actor_loss, p["actor"],
                                          p["critic"], log_alpha, batch, n2)
        _, a_opt, _ = self.actor_opt.update(
            a_grads, opt["actor"], pytree.tree_leaves(p["actor"]))

        logp = a_aux["logp"]
        _, _, al_grads = grads_of(self.alpha_loss, log_alpha, logp)
        _, al_opt, _ = self.alpha_opt.update(al_grads, opt["alpha"],
                                             [log_alpha])

        target = {"critic": soft_update(targ["critic"], p["critic"], self.tau)}
        ts = TrainState(step=train_state.step + 1, params=p,
                        opt_state={"actor": a_opt, "critic": c_opt,
                                   "alpha": al_opt},
                        extra={"target": target, "log_alpha": log_alpha})
        info = OptInfo(loss=c_loss, grad_norm=c_gnorm,
                       extra={"actor_loss": a_loss,
                              "alpha": torch.exp(log_alpha),
                              "entropy": -torch.mean(logp), **c_aux})
        return ts, info
