"""DQN + variants on one loss (paper §1.1), port of
``repro/algos/dqn/dqn.py``: Double, Dueling (model-level), Categorical/C51,
prioritized-replay hooks, n-step returns.

``loss`` is a function of (params, target_params, batch) — params a pytree
of tensors — and ``update`` takes its gradient with ``torch.autograd.grad``,
steps the optimizer (which writes the params IN PLACE) and copies the params
into the target network at ``step % target_update_interval == 0``, after
the optimizer step, as JAX does.  ``td_abs`` is returned for priority
updates.  The target side of the loss runs under ``torch.no_grad()``, the
counterpart of JAX's ``stop_gradient``.

The C51 projection adds the probability mass of colliding ``lo``/``hi``
atoms with ``scatter_add_``, whose order of additions on CUDA is unordered:
the projected distribution differs from JAX's ``.at[].add`` by f32 rounding.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from ...core.algorithm import OptInfo, TrainState, grads_of
from ...core.batch_spec import BatchSpec
from ...train.optim import Optimizer

F32 = torch.float32

#: the replayed-transition contract shared by DQN and the QPG family
Q_TRANSITION_FIELDS = ("observation", "action", "return_", "bootstrap",
                       "next_observation", "n_used", "is_weights")


def huber(x, delta: float = 1.0):
    a = torch.abs(x)
    return torch.where(a <= delta, 0.5 * x * x, delta * (a - 0.5 * delta))


def _take(x, index):
    """x[..., index, :] per row: x (B, A, ...) and index (B,) -> (B, ...)."""
    idx = index.long().reshape((-1, 1) + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand((-1, 1) + tuple(x.shape[2:])))[:, 0]


class DQN:
    batch_spec = BatchSpec("transition", Q_TRANSITION_FIELDS,
                           priority_keys=("td_abs",))

    def __init__(self, apply_fn: Callable, optimizer: Optimizer, *,
                 gamma=0.99, n_step=1, double=True,
                 n_atoms: int = 0, v_min: float = -10.0, v_max: float = 10.0,
                 target_update_interval: int = 250, huber_delta: float = 1.0):
        self.apply = apply_fn          # (params, obs, prev_a, prev_r) -> q or logits
        self.opt = optimizer
        self.gamma, self.n_step = gamma, n_step
        self.double = double
        self.n_atoms = n_atoms
        self.v_min, self.v_max = v_min, v_max
        self.target_interval = target_update_interval
        self.delta = huber_delta

    def init_train_state(self, generator, params) -> TrainState:
        target = pytree.tree_map(lambda p: p.detach().clone(), params)
        return TrainState(step=0, params=params,
                          opt_state=self.opt.init(pytree.tree_leaves(params)),
                          extra={"target": target})

    # ------------------------------------------------------------------
    def _q(self, params, obs):
        return self.apply(params, obs, None, None)

    def _support(self, device):
        return torch.linspace(self.v_min, self.v_max, self.n_atoms, dtype=F32,
                              device=device)

    def loss(self, params, target_params, batch):
        if self.n_atoms:
            return self._c51_loss(params, target_params, batch)
        q = self._q(params, batch["observation"])
        qa = _take(q, batch["action"])
        with torch.no_grad():
            q_next_t = self._q(target_params, batch["next_observation"])
            if self.double:
                q_next_o = self._q(params, batch["next_observation"])
                a_star = torch.argmax(q_next_o, dim=-1)
            else:
                a_star = torch.argmax(q_next_t, dim=-1)
            v_next = _take(q_next_t, a_star)
            disc = self.gamma ** batch["n_used"].to(F32)
            target = batch["return_"] + disc * batch["bootstrap"] * v_next
        td = qa - target
        loss = torch.mean(batch["is_weights"] * huber(td, self.delta))
        return loss, {"td_abs": torch.abs(td).detach(),
                      "q_mean": torch.mean(qa).detach()}

    def _c51_loss(self, params, target_params, batch):
        """Categorical DQN with the Bellman projection onto the fixed support."""
        nA = self.n_atoms
        logits = self._q(params, batch["observation"])  # (B, A, atoms)
        support = self._support(logits.device)
        logp = F.log_softmax(logits, dim=-1)
        logp_a = _take(logp, batch["action"])           # (B, atoms)

        with torch.no_grad():
            t_logits = self._q(target_params, batch["next_observation"])
            t_probs = torch.softmax(t_logits, dim=-1)   # (B, A, atoms)
            if self.double:
                o_probs = torch.softmax(
                    self._q(params, batch["next_observation"]), dim=-1)
                a_star = torch.argmax(torch.sum(o_probs * support, dim=-1), dim=-1)
            else:
                a_star = torch.argmax(torch.sum(t_probs * support, dim=-1), dim=-1)
            p_next = _take(t_probs, a_star)

            disc = (self.gamma ** batch["n_used"].to(F32))[..., None]
            tz = batch["return_"][..., None] + disc * \
                batch["bootstrap"][..., None] * support
            tz = torch.clamp(tz, self.v_min, self.v_max)
            dz = (self.v_max - self.v_min) / (nA - 1)
            b = (tz - self.v_min) / dz                  # (B, atoms) fractional index
            lo = torch.floor(b).long()
            hi = torch.ceil(b).long()
            # distribute probability mass (handles lo == hi)
            eq = (lo == hi).to(F32)
            w_lo = (hi.to(F32) - b) + eq
            w_hi = b - lo.to(F32)
            m = torch.zeros_like(p_next)
            m.scatter_add_(1, lo, p_next * w_lo)
            m.scatter_add_(1, torch.clamp(hi, 0, nA - 1), p_next * w_hi)

        ce = -torch.sum(m * logp_a, dim=-1)
        loss = torch.mean(batch["is_weights"] * ce)
        q_mean = torch.mean(torch.sum(torch.exp(logp_a) * support, dim=-1))
        return loss, {"td_abs": ce.detach(), "q_mean": q_mean.detach()}

    # ------------------------------------------------------------------
    def grads(self, params, target_params, batch):
        """(loss, aux, grads): grads a list in ``tree_leaves(params)`` order."""
        return grads_of(self.loss, params, target_params, batch)

    def update(self, train_state: TrainState, batch, generator=None):
        target = train_state.extra["target"]
        loss, aux, grads = self.grads(train_state.params, target, batch)
        leaves = pytree.tree_leaves(train_state.params)
        _, opt_state, gnorm = self.opt.update(grads, train_state.opt_state,
                                              leaves)
        step = train_state.step + 1
        if step % self.target_interval == 0:
            with torch.no_grad():
                for t, p in zip(pytree.tree_leaves(target), leaves):
                    t.copy_(p)
        ts = TrainState(step=step, params=train_state.params,
                        opt_state=opt_state, extra={"target": target})
        return ts, OptInfo(loss=loss, grad_norm=gnorm, extra=aux)
