"""A2C (paper §1.1 policy-gradient family): synchronous advantage
actor-critic, port of ``repro/algos/pg/a2c.py``.

Batch layout is time-major (T, B) from the sampler; one gradient step per
sampled batch (the paper's A2C), GAE for advantages.  GAE runs inside the
loss on the detached value, JAX's ``stop_gradient``.  The optimizer writes
the params IN PLACE.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from ...core.algorithm import OptInfo, TrainState, grads_of
from ...core.batch_spec import BatchSpec
from ...train.optim import Optimizer
from .gae import gae_scan


class A2C:
    batch_spec = BatchSpec("rollout", ("observation", "prev_action",
                                       "prev_reward", "action", "reward",
                                       "done", "bootstrap_value"))

    def __init__(self, apply_fn: Callable, optimizer: Optimizer, *,
                 distribution, gamma=0.99, gae_lambda=1.0,
                 value_coeff=0.5, entropy_coeff=0.01,
                 normalize_advantage=False):
        self.apply = apply_fn          # (params, obs, prev_a, prev_r) -> (logits, value)
        self.opt = optimizer
        self.dist = distribution
        self.gamma, self.lam = gamma, gae_lambda
        self.vc, self.ec = value_coeff, entropy_coeff
        self.norm_adv = normalize_advantage

    def init_train_state(self, generator, params) -> TrainState:
        return TrainState(step=0, params=params,
                          opt_state=self.opt.init(pytree.tree_leaves(params)),
                          extra=None)

    def loss(self, params, batch):
        logits, value = self.apply(params, batch["observation"],
                                   batch.get("prev_action"),
                                   batch.get("prev_reward"))
        adv, ret = gae_scan(batch["reward"], value.detach(),
                            batch["bootstrap_value"], batch["done"],
                            gamma=self.gamma, lam=self.lam)
        if self.norm_adv:
            adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        logp = self.dist.log_likelihood(batch["action"], logits)
        pi_loss = -torch.mean(logp * adv)
        v_loss = 0.5 * torch.mean(torch.square(value - ret))
        ent = torch.mean(self.dist.entropy(logits))
        total = pi_loss + self.vc * v_loss - self.ec * ent
        return total, {"pi_loss": pi_loss, "v_loss": v_loss, "entropy": ent}

    def update(self, train_state: TrainState, batch, generator=None):
        loss, aux, grads = grads_of(self.loss, train_state.params, batch)
        _, opt_state, gnorm = self.opt.update(
            grads, train_state.opt_state,
            pytree.tree_leaves(train_state.params))
        ts = TrainState(step=train_state.step + 1, params=train_state.params,
                        opt_state=opt_state, extra=None)
        return ts, OptInfo(loss=loss, grad_norm=gnorm, extra=aux)
