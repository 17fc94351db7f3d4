"""R2D1 — non-distributed R2D2 (paper §3.2 headline result), port of
``repro/algos/dqn/r2d1.py``.

Recurrent Q-learning from sequence replay:
- burn-in: the first ``burn_in`` steps only advance the LSTM state (no loss,
  no gradient, for the online and the target net);
- stored recurrent state: sequences start at replay slots where the sampler
  stored the state (periodic storage, paper §1.1 / §6.3);
- value rescaling h(x) = sign(x)(sqrt(|x|+1)-1) + eps*x on targets (R2D2);
- double Q + n-step targets within the sequence, truncated at ``done``;
- priorities: eta*max|td| + (1-eta)*mean|td| over the training segment
  (``td_abs_max`` and ``td_abs_mean`` per sequence; the replay mixes them).

As in rlpyt, ``R2D1`` subclasses ``DQN`` and keeps its train state and
``update``: the gradient through ``torch.autograd.grad``, the optimizer
writing the params IN PLACE, and the params copied into the target network
when ``step % target_update_interval == 0``.  JAX picks the target with
``where`` on its step; the port branches on its Python-int step, so the
update never waits for the device.  The target is a copy made at init and
refreshed by copying, never an alias of the online params.
"""
from __future__ import annotations

from typing import Callable

import torch

from ...core.batch_spec import BatchSpec
from ...train.optim import Optimizer
from .dqn import DQN, huber

F32 = torch.float32
EPS_RESCALE = 1e-3


def value_rescale(x, eps=EPS_RESCALE):
    return torch.sign(x) * (torch.sqrt(torch.abs(x) + 1.0) - 1.0) + eps * x


def value_rescale_inv(x, eps=EPS_RESCALE):
    return torch.sign(x) * (
        torch.square((torch.sqrt(1.0 + 4.0 * eps * (torch.abs(x) + 1.0 + eps))
                      - 1.0) / (2.0 * eps)) - 1.0)


def _take(q, action):
    """q (..., A) at ``action`` (...) -> (...)."""
    return torch.gather(q, -1, action.long()[..., None])[..., 0]


class R2D1(DQN):
    batch_spec = BatchSpec("sequence",
                           ("sequence", "init_state", "is_weights"),
                           priority_keys=("td_abs_max", "td_abs_mean"))

    def __init__(self, apply_fn: Callable, optimizer: Optimizer, *,
                 gamma=0.997, n_step=5, burn_in=40,
                 target_update_interval=2500, eta=0.9, huber_delta=1.0,
                 use_rescale=True):
        # (params, obs (T, B, ...), prev_a, prev_r, state) -> (q, state)
        self.apply = apply_fn
        self.opt = optimizer
        self.gamma, self.n_step = gamma, n_step
        self.burn_in = burn_in
        self.target_interval = target_update_interval
        self.eta = eta
        self.delta = huber_delta
        self.use_rescale = use_rescale

    def loss(self, params, target_params, batch):
        """batch["sequence"] leaves: (batch, L+1, ...) slot-major from the
        sequence replay; init_state at the sequence start."""
        seq = batch["sequence"]
        # to time-major (L+1, batch, ...)
        obs = seq.observation.transpose(0, 1)
        prev_a = seq.prev_action.transpose(0, 1)
        prev_r = seq.prev_reward.transpose(0, 1)
        action = seq.action.transpose(0, 1)
        reward = seq.reward.transpose(0, 1)
        done = seq.done.transpose(0, 1).to(F32)
        state0 = batch["init_state"]
        bi, n = self.burn_in, self.n_step

        # burn-in (no grad) to warm the recurrent state
        state_o = state_t = state0
        if bi > 0:
            with torch.no_grad():
                _, state_o = self.apply(params, obs[:bi], prev_a[:bi],
                                        prev_r[:bi], state0)
                _, state_t = self.apply(target_params, obs[:bi], prev_a[:bi],
                                        prev_r[:bi], state0)

        q, _ = self.apply(params, obs[bi:], prev_a[bi:], prev_r[bi:], state_o)
        qa = _take(q, action[bi:])
        Tt = qa.shape[0] - n  # number of trainable positions
        with torch.no_grad():
            q_t, _ = self.apply(target_params, obs[bi:], prev_a[bi:],
                                prev_r[bi:], state_t)
            # double-Q bootstrap value at every position
            v = _take(q_t, torch.argmax(q, dim=-1))
            if self.use_rescale:
                v = value_rescale_inv(v)
            # n-step return within the sequence: for t, G = sum gamma^i
            # r_{t+i} + gamma^n * v_{t+n}, truncated at done
            r_seg, d_seg = reward[bi:], done[bi:]
            ret = torch.zeros_like(qa[:Tt])
            not_done = torch.ones_like(qa[:Tt])
            for i in range(n):
                ret = ret + (self.gamma ** i) * r_seg[i:Tt + i] * not_done
                not_done = not_done * (1.0 - d_seg[i:Tt + i])
            target = ret + (self.gamma ** n) * not_done * v[n:Tt + n]
            if self.use_rescale:
                target = value_rescale(target)
        td = qa[:Tt] - target
        w = batch["is_weights"][None, :]
        loss = torch.mean(w * huber(td, self.delta))
        td_abs = torch.abs(td).detach()
        return loss, {"td_abs_max": torch.amax(td_abs, dim=0),
                      "td_abs_mean": torch.mean(td_abs, dim=0),
                      "q_mean": torch.mean(qa)}
