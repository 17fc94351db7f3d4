"""V-trace off-policy correction (IMPALA; TorchBeast in PAPERS.md) for the
decoupled async actor/learner (paper §2.3), port of
``repro/train/vtrace.py``.

When the actor runs ahead of parameter publication, its rollouts were drawn
from a stale behavior policy mu while the learner optimizes pi.  V-trace
repairs the value targets with truncated importance weights:

    rho_t = min(pi(a_t|x_t)/mu(a_t|x_t), rho_bar)
    c_t   = lam * min(pi/mu, c_bar)
    delta_t = rho_t * (r_t + gamma * nd_t * V(x_{t+1}) - V(x_t))
    vs_t - V(x_t) = delta_t + gamma * c_t * nd_t * (vs_{t+1} - V(x_{t+1}))

The ``lam`` factor is the lambda-V-trace generalization: at rho_bar = c_bar
= 1 and pi == mu it reduces to GAE(lambda), which is what makes the
staleness-0 async runner agree with the synchronous path.  A reverse loop
over time takes the place of JAX's reverse ``lax.scan``.

Wiring (the BatchSpec seam — no algorithm's update signature changes):
``vtrace_extras`` computes the corrected advantage series adv*_t = vs_t - v_t
under the CURRENT learner params, then inverts the algorithm's own GAE to a
rewritten reward series r_hat such that the algorithm's internal
``gae_scan(r_hat, v, bootstrap, done, gamma, lam)`` reproduces adv*
(``gae_inverse``).  The extras override the ``reward`` field through
``make_algo_batch``, so A2C/PPO run unmodified yet optimize the
V-trace-corrected objective.
"""
from __future__ import annotations

import torch


def vtrace(behavior_logp, target_logp, rewards, values, bootstrap_value,
           done, *, gamma: float = 0.99, lam: float = 1.0,
           rho_bar: float = 1.0, c_bar: float = 1.0):
    """Reference V-trace.  All series time-major (T, B); bootstrap (B,).

    Returns ``(vs, pg_adv)``: the corrected value targets and the truncated
    policy-gradient advantage rho_t * (r_t + gamma*nd*vs_{t+1} - v_t).
    """
    ratio = torch.exp(target_logp - behavior_logp)
    rho = torch.clamp(ratio, max=rho_bar)
    c = lam * torch.clamp(ratio, max=c_bar)
    nd = 1.0 - done.to(values.dtype)
    v_next = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    delta = rho * (rewards + gamma * v_next * nd - values)
    adv = torch.empty_like(delta)
    acc = torch.zeros_like(bootstrap_value)
    for t in range(delta.shape[0] - 1, -1, -1):
        acc = delta[t] + gamma * c[t] * nd[t] * acc
        adv[t] = acc
    vs = adv + values
    vs_next = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    pg_adv = rho * (rewards + gamma * vs_next * nd - values)
    return vs, pg_adv


def vtrace_advantage(behavior_logp, target_logp, rewards, values,
                     bootstrap_value, done, *, gamma: float = 0.99,
                     lam: float = 1.0, rho_bar: float = 1.0,
                     c_bar: float = 1.0):
    """adv*_t = vs_t - V(x_t): the lambda-discounted corrected advantage.

    This is the series the algorithms' internal GAE is steered to reproduce;
    at lam == 1 it coincides with the IMPALA pg advantage (rho == 1 regime).
    """
    vs, _ = vtrace(behavior_logp, target_logp, rewards, values,
                   bootstrap_value, done, gamma=gamma, lam=lam,
                   rho_bar=rho_bar, c_bar=c_bar)
    return vs - values


def gae_inverse(adv, values, bootstrap_value, done, *, gamma: float,
                lam: float):
    """Reward series r_hat with gae_scan(r_hat, values, ...) == adv.

    GAE is lower-triangular in the rewards, so it inverts in closed form:
        delta_hat_t = adv_t - gamma*lam*nd_t*adv_{t+1}
        r_hat_t     = delta_hat_t - gamma*nd_t*v_{t+1} + v_t
    """
    nd = 1.0 - done.to(values.dtype)
    adv_next = torch.cat([adv[1:], torch.zeros_like(bootstrap_value)[None]],
                         dim=0)
    delta_hat = adv - gamma * lam * nd * adv_next
    v_next = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    return delta_hat - gamma * v_next * nd + values


@torch.no_grad()
def vtrace_extras(algo, params, rollout, bootstrap_value, *,
                  rho_bar: float = 1.0, c_bar: float = 1.0):
    """BatchSpec extras implementing V-trace for rollout-mode algorithms.

    Needs the pg-family algorithm surface: ``algo.apply`` -> (logits, value),
    ``algo.dist``, ``algo.gamma``, ``algo.lam``, and the sampler-recorded
    behavior log-prob in ``rollout.agent_info["logp"]``.  Returns extras that
    override ``reward`` (and ``value`` where the spec consumes it, so PPO's
    advantage/value-clip baselines come from the CURRENT learner params
    rather than the stale actor).  Nothing here carries a gradient.
    """
    logits, value = algo.apply(params, rollout.observation,
                               rollout.prev_action, rollout.prev_reward)
    target_logp = algo.dist.log_likelihood(rollout.action, logits)
    behavior_logp = rollout.agent_info["logp"]
    gamma = algo.gamma
    lam = getattr(algo, "lam", 1.0)
    adv = vtrace_advantage(behavior_logp, target_logp, rollout.reward,
                           value, bootstrap_value, rollout.done,
                           gamma=gamma, lam=lam, rho_bar=rho_bar, c_bar=c_bar)
    extras = {"reward": gae_inverse(adv, value, bootstrap_value,
                                    rollout.done, gamma=gamma, lam=lam)}
    if "value" in algo.batch_spec.fields:
        extras["value"] = value
    return extras
