"""LM-scale PPO train step, port of
``repro/algos/pg/ppo.py::make_lm_ppo_train_step``.

Single device: the JAX ``maybe_cast`` (``cfg.cast_weights_bf16``) and
``param_pspecs`` sharding constraints are mesh-only and dropped; the
rlpyt-style minibatch ``PPO`` class waits for the RL slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...models import backbones as bb
from ...train.optim import Optimizer

F32 = torch.float32


def make_lm_ppo_train_step(cfg, optimizer: Optimizer, *, clip_eps=0.2,
                           value_coeff=0.5, entropy_coeff=0.01,
                           n_microbatches: int = 1, aux_coeff: float = 0.01):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).

    batch (token MDP trajectories, batch-major):
      tokens (B, T) int32        observations = prev tokens
      actions (B, T) int32       sampled next tokens
      logp_old, advantage, return_ (B, T) f32

    ``params`` is an ``LM`` with f32 master weights that require grad.
    Microbatch gradient accumulation bounds activation memory; gradients
    accumulate in f32.  The optimizer updates ``params`` in place.  Metrics
    (0-d f32 tensors): loss, grad_norm, pi_loss, v_loss, entropy.
    """

    def loss_fn(params, mb):
        hidden, aux = bb.forward_train(params, mb["tokens"], cfg)
        logits = bb.lm_logits(params, hidden, cfg)
        value = bb.value_out(params, hidden)
        logits = logits.to(F32)
        logp_all = F.log_softmax(logits, dim=-1)
        logp = torch.gather(logp_all, -1,
                            mb["actions"].long()[..., None])[..., 0]
        ratio = torch.exp(logp - mb["logp_old"])
        adv = mb["advantage"]
        surr = torch.minimum(ratio * adv,
                             torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps)
                             * adv)
        pi_loss = -torch.mean(surr)
        v_loss = 0.5 * torch.mean(torch.square(value - mb["return_"]))
        ent = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
        total = (pi_loss + value_coeff * v_loss - entropy_coeff * ent
                 + aux_coeff * aux)
        return total, {"pi_loss": pi_loss, "v_loss": v_loss, "entropy": ent}

    def train_step(params, opt_state, batch):
        B = batch["tokens"].shape[0]
        if B % n_microbatches:
            raise ValueError(f"batch {B} does not split into "
                             f"{n_microbatches} microbatches")
        mb_size = B // n_microbatches
        leaves = [p for p in params.parameters()]
        grads, loss, auxes = None, None, []
        for i in range(n_microbatches):
            mb = {k: v[i * mb_size:(i + 1) * mb_size] for k, v in batch.items()}
            total, aux = loss_fn(params, mb)
            with torch.no_grad():
                # g / n summed in f32, as JAX's 0 + g1/n + g2/n + ...; at
                # n = 1 the gradients themselves, without a copy
                g = [gi.to(F32) if n_microbatches == 1
                     else gi.to(F32) / n_microbatches
                     for gi in torch.autograd.grad(total, leaves)]
                grads = g if grads is None else [a.add_(b)
                                                 for a, b in zip(grads, g)]
            part = total.detach() / n_microbatches
            loss = part if loss is None else loss + part
            auxes.append({k: v.detach() for k, v in aux.items()})
            del g, total, aux
        _, opt_state, gnorm = optimizer.update(grads, opt_state, leaves)
        metrics = {"loss": loss, "grad_norm": gnorm}
        for k in auxes[0]:
            metrics[k] = torch.mean(torch.stack([a[k] for a in auxes]))
        return params, opt_state, metrics

    return train_step
