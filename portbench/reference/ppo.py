"""The plain reference of the LM-PPO iteration, in float32 PyTorch.

It follows the program's first steps on the tokens and actions the
program's rollouts sampled (the only outputs it reads, and those to judge
them), and works out again everything else from the same weights and
environment table the benchmark handed the program:

- the rollout's per-step log-probabilities (over the first ``vocab``
  logits) and values, by one forward over the (B, T) tokens: a decode
  through a cache computes the same positions one at a time;
- rewards ``chain[token, action]``; GAE by the reverse recurrence
  adv_t = delta_t + gamma lam (1 - done_t) adv_{t+1}, the advantages
  normalised over the batch, returns adv + value;
- the PPO loss (clipped surrogate over the padded vocabulary's
  log-softmax, 0.5 x squared value error, the entropy bonus), its
  gradient by autograd, the global-norm clip and Adam.

``steps`` returns, for each step, the loss and the rollout readings, the
first step's clipped gradient norm a leaf, and each leaf's change over the
steps.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .lm import F32, RefLM, exact_f32


def gae(rewards, values, done, gamma, lam):
    """(T, B) rewards, values, done -> (adv, ret); the last step of an
    episode bootstraps nothing (done), so no value past T is needed."""
    if not bool(done[-1].all()):
        raise ValueError("reference GAE: the horizon must end episodes")
    T = rewards.shape[0]
    adv = torch.zeros_like(rewards)
    nxt = torch.zeros_like(rewards[0])
    for t in range(T - 1, -1, -1):
        nd = 1.0 - done[t].to(F32)
        v_next = values[t + 1] if t + 1 < T else torch.zeros_like(nxt)
        delta = rewards[t] + gamma * v_next * nd - values[t]
        nxt = delta + gamma * lam * nd * nxt
        adv[t] = nxt
    return adv, adv + values


def steps(cfg: dict, w0: dict, rollouts: list, chain, hp: dict,
          prec: str = "f32"):
    """``rollouts``: per step {"tokens", "actions", "done"} (T, B) as the
    program's rollout produced them.  ``w0``: the initial weights (not
    written).  Returns {"loss": [..], "logp": [(T,B)], "value": [(T,B)],
    "reward": [(T,B)], "pi_loss": [..], "v_loss": [..], "grad_norm": [..]
    (before the clip), "grad1": {leaf: norm}, "change": {leaf: norm}}."""
    V = cfg["vocab"]
    names = sorted(w0)
    params = {n: w0[n].detach().to(F32).clone().requires_grad_(True)
              for n in names}
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    b1, b2, eps = hp["adam_b1"], hp["adam_b2"], hp["adam_eps"]
    out = {"loss": [], "logp": [], "value": [], "reward": [], "pi_loss": [],
           "v_loss": [], "grad_norm": []}
    lm = RefLM(cfg, params, prec)
    with exact_f32():
        for k, ro in enumerate(rollouts):
            tokens = ro["tokens"].t().contiguous()           # (B, T)
            actions = ro["actions"].t().contiguous().long()
            hidden = lm.hidden(tokens, checkpoint=True)
            logits = lm.logits(hidden)
            value = lm.value(hidden)
            with torch.no_grad():
                lp_roll = torch.gather(F.log_softmax(logits[..., :V], -1),
                                       -1, actions[..., None])[..., 0]
                rew = chain[ro["tokens"].long(), ro["actions"].long()]
                adv, ret = gae(rew, value.t(), ro["done"], hp["gamma"],
                               hp["lam"])
                adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
                adv, ret = adv.t(), ret.t()
            logp_all = F.log_softmax(logits, dim=-1)
            logp = torch.gather(logp_all, -1, actions[..., None])[..., 0]
            ratio = torch.exp(logp - lp_roll)
            clip = hp["clip_eps"]
            surr = torch.minimum(ratio * adv,
                                 torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
            pi_loss = -torch.mean(surr)
            v_loss = 0.5 * torch.mean(torch.square(value - ret))
            ent = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, -1))
            total = (pi_loss + hp["value_coeff"] * v_loss
                     - hp["entropy_coeff"] * ent)
            grads = torch.autograd.grad(total, [params[n] for n in names])
            del hidden, logits, logp_all, logp, ratio, surr
            out["loss"].append(float(total.detach()))
            out["pi_loss"].append(float(pi_loss.detach()))
            out["v_loss"].append(float(v_loss.detach()))
            out["logp"].append(lp_roll.t().contiguous())
            out["value"].append(value.detach().t().contiguous())
            out["reward"].append(rew)
            with torch.no_grad():
                gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                out["grad_norm"].append(float(gnorm))
                scale = torch.clamp(hp["grad_clip"] / torch.clamp(
                    gnorm, min=1e-9), max=1.0)
                step = k + 1
                bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
                for n, g in zip(names, grads):
                    g = g * scale
                    if k == 0:
                        out.setdefault("grad1", {})[n] = float(g.norm())
                    m[n].mul_(b1).add_((1 - b1) * g)
                    v[n].mul_(b2).add_((1 - b2) * g * g)
                    params[n] -= hp["lr"] * (m[n] / bc1) / (
                        torch.sqrt(v[n] / bc2) + eps)
            del grads
        with torch.no_grad():
            out["change"] = {n: float((params[n] - w0[n].to(F32)).norm())
                             for n in names}
    return out
