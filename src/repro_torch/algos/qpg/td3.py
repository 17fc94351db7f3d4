"""TD3: twin critics, target policy smoothing, delayed actor updates; port
of ``repro/algos/qpg/td3.py``.

JAX computes the actor step on every update and keeps it only where
``step % policy_delay == 0``.  The port's optimizers write in place, so it
branches on its Python-int step instead (the update never waits for the
device): on the other steps it computes ``actor_loss`` without a gradient,
for the log, and leaves the actor, its Adam state and both targets
untouched, as JAX's ``where`` leaves them.  ``update_variant(step)`` names
that branch, so a caller that captures updates in CUDA graphs keeps one
graph per branch.  The smoothing noise is a
standard normal of the action's shape, drawn from the generator or passed
in (``noise=``) so a test can hand both frameworks the same draws.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from ...core.algorithm import OptInfo, TrainState, grads_of
from ...core.batch_spec import BatchSpec
from ...train.optim import Optimizer, soft_update
from ..dqn.dqn import Q_TRANSITION_FIELDS
from .ddpg import DDPG, bellman_target


class TD3(DDPG):
    batch_spec = BatchSpec("transition", Q_TRANSITION_FIELDS,
                           priority_keys=("td_abs",))

    def __init__(self, actor_fn: Callable, critic_fn: Callable,
                 actor_opt: Optimizer, critic_opt: Optimizer, *,
                 gamma=0.99, tau=0.005, policy_noise=0.2, noise_clip=0.5,
                 policy_delay=2):
        super().__init__(actor_fn, critic_fn, actor_opt, critic_opt,
                         gamma=gamma, tau=tau)
        self.policy_noise, self.noise_clip = policy_noise, noise_clip
        self.policy_delay = policy_delay

    def critic_loss(self, critic_params, target, batch, noise):
        with torch.no_grad():
            nobs = batch["next_observation"]
            a_next = self.actor(target["actor"], nobs)
            eps = torch.clamp(self.policy_noise * noise, -self.noise_clip,
                              self.noise_clip)
            a_next = torch.clamp(a_next + eps, -1.0, 1.0)
            q_next = self.critic(target["critic"], nobs, a_next)
            v_next = torch.amin(q_next, dim=0)  # clipped double-Q
            y = bellman_target(batch, self.gamma, v_next)
        qs = self.critic(critic_params, batch["observation"], batch["action"])
        td = qs - y[None]
        loss = torch.mean(batch["is_weights"][None] * torch.square(td))
        return loss, {"td_abs": torch.abs(td[0])}

    def update_variant(self, step: int) -> bool:
        """Whether the update that makes train step ``step`` steps the actor
        and the targets."""
        return step % self.policy_delay == 0

    def update(self, train_state: TrainState, batch, generator=None, *,
               noise=None):
        """``noise``: the smoothing draws, (B, act_dim) standard normal;
        drawn from ``generator`` when None."""
        p, targ = train_state.params, train_state.extra["target"]
        if noise is None:
            act = batch["action"]
            noise = torch.randn(act.shape, generator=generator,
                                device=act.device, dtype=act.dtype)
        c_loss, c_aux, c_grads = grads_of(self.critic_loss, p["critic"], targ,
                                          batch, noise)
        _, c_opt, c_gnorm = self.critic_opt.update(
            c_grads, train_state.opt_state["critic"],
            pytree.tree_leaves(p["critic"]))
        step = train_state.step + 1
        a_opt = train_state.opt_state["actor"]
        if self.update_variant(step):
            a_loss, _, a_grads = grads_of(self.actor_loss, p["actor"],
                                          p["critic"], batch)
            _, a_opt, _ = self.actor_opt.update(
                a_grads, a_opt, pytree.tree_leaves(p["actor"]))
            targ = soft_update(targ, p, self.tau)
        else:
            with torch.no_grad():
                a_loss = self.actor_loss(p["actor"], p["critic"], batch)[0]
        ts = TrainState(step=step, params=p,
                        opt_state={"actor": a_opt, "critic": c_opt},
                        extra={"target": targ})
        return ts, OptInfo(loss=c_loss, grad_norm=c_gnorm,
                           extra={"actor_loss": a_loss, **c_aux})
