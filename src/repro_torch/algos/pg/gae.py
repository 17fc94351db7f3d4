"""Generalized advantage estimation, port of ``repro/algos/pg/gae.py``.

- ``gae_scan``: a reverse loop over time, the reference.
- ``gae_associative``: the same linear recurrence
  adv_t = delta_t + c_t * adv_{t+1} (c_t = gamma*lambda*(1-done_t)) as a
  scan over affine-map composition, in log2(T) doubling steps
  (Hillis-Steele), the counterpart of ``lax.associative_scan``.
- ``discounted_returns``: the n-step discounted return-to-go (A2C's
  target).

Both operate time-major (T, B).
"""
from __future__ import annotations

import torch


def _deltas(rewards, values, bootstrap_value, done, gamma):
    next_values = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    not_done = 1.0 - done.to(values.dtype)
    return rewards + gamma * next_values * not_done - values, not_done


def gae_scan(rewards, values, bootstrap_value, done, *, gamma=0.99, lam=0.95):
    """rewards/values/done: (T, B); bootstrap_value: (B,).  Returns (adv, ret)."""
    deltas, not_done = _deltas(rewards, values, bootstrap_value, done, gamma)
    advs = torch.empty_like(deltas)
    adv = torch.zeros_like(bootstrap_value)
    for t in range(deltas.shape[0] - 1, -1, -1):
        adv = deltas[t] + gamma * lam * not_done[t] * adv
        advs[t] = adv
    return advs, advs + values


def gae_associative(rewards, values, bootstrap_value, done, *, gamma=0.99,
                    lam=0.95):
    """Same recurrence via a scan over affine-map composition.

    adv_t = f_t(adv_{t+1}) with f_t(x) = b_t + a_t*x.  On the time-reversed
    sequence r_i = f_{T-1-i}, adv_{T-1-i} = (r_i o ... o r_0)(0); combining
    x (applied first) with y gives a = a_y*a_x, b = b_y + a_y*b_x.
    """
    deltas, not_done = _deltas(rewards, values, bootstrap_value, done, gamma)
    a = (gamma * lam * not_done).flip(0)
    b = deltas.flip(0)
    d = 1
    while d < a.shape[0]:
        b = torch.cat([b[:d], b[d:] + a[d:] * b[:-d]], dim=0)
        a = torch.cat([a[:d], a[d:] * a[:-d]], dim=0)
        d *= 2
    advs = b.flip(0)
    return advs, advs + values


def discounted_returns(rewards, bootstrap_value, done, *, gamma=0.99):
    """n-step discounted return-to-go: ret_t = r_t + gamma * (1 - done_t)
    * ret_{t+1}, from ret_T = bootstrap_value; (T, B) -> (T, B)."""
    not_done = 1.0 - done.to(rewards.dtype)
    rets = torch.empty_like(rewards)
    ret = bootstrap_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        ret = rewards[t] + gamma * not_done[t] * ret
        rets[t] = ret
    return rets
