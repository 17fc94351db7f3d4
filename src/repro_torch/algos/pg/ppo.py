"""PPO (paper §1.1), port of ``repro/algos/pg/ppo.py``: the rlpyt-style
``PPO`` class (clipped surrogate, minibatch epochs) and the LM-scale
``make_lm_ppo_train_step``.

``PPO.update`` runs epochs x minibatches gradient steps, eagerly, over one
permutation of the T*B samples per epoch; the optimizer writes the params
IN PLACE.  The LM step keeps JAX's options: ``cfg.cast_weights_bf16``
(the forward reads bf16 casts of the f32 weight matrices),
``param_pspecs`` (the gradients pass ``sharding.constrain``) and the
compression metrics of a ``cross_replica`` optimizer's state.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from ...core.algorithm import OptInfo, TrainState, grads_of
from ...core.batch_spec import BatchSpec
from ...models import backbones as bb
from ...models import sharding as shd
from ...models.convert import jax_ndim
from ...telemetry import trace
from ...train.optim import Optimizer, compress_metrics
from .gae import gae_associative, gae_scan

F32 = torch.float32


class PPO:
    batch_spec = BatchSpec("rollout", ("observation", "prev_action",
                                       "prev_reward", "action", "reward",
                                       "done", "value", "logp_old",
                                       "bootstrap_value"))

    def __init__(self, apply_fn: Callable, optimizer: Optimizer, *,
                 distribution, gamma=0.99, gae_lambda=0.95,
                 clip_eps=0.2, value_coeff=0.5, entropy_coeff=0.01,
                 epochs=4, minibatches=4, normalize_advantage=True,
                 value_clip: Optional[float] = None, associative_gae=False):
        self.apply = apply_fn
        self.opt = optimizer
        self.dist = distribution
        self.gamma, self.lam = gamma, gae_lambda
        self.clip_eps = clip_eps
        self.vc, self.ec = value_coeff, entropy_coeff
        self.epochs, self.minibatches = epochs, minibatches
        self.norm_adv = normalize_advantage
        self.value_clip = value_clip
        self.gae = gae_associative if associative_gae else gae_scan

    def init_train_state(self, generator, params) -> TrainState:
        return TrainState(step=0, params=params,
                          opt_state=self.opt.init(pytree.tree_leaves(params)),
                          extra=None)

    # -- advantage computation on the full (T, B) batch ---------------------
    def compute_advantages(self, batch):
        return self.gae(batch["reward"], batch["value"],
                        batch["bootstrap_value"], batch["done"],
                        gamma=self.gamma, lam=self.lam)

    def loss(self, params, mb):
        logits, value = self.apply(params, mb["observation"],
                                   mb.get("prev_action"), mb.get("prev_reward"))
        logp = self.dist.log_likelihood(mb["action"], logits)
        ratio = torch.exp(logp - mb["logp_old"])
        adv = mb["advantage"]
        if self.norm_adv:
            # JAX's std is the population std
            adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 1 - self.clip_eps, 1 + self.clip_eps) * adv
        pi_loss = -torch.mean(torch.minimum(surr1, surr2))
        if self.value_clip is not None:
            v_old = mb["value"]
            v_clip = v_old + torch.clamp(value - v_old, -self.value_clip,
                                         self.value_clip)
            v_loss = 0.5 * torch.mean(torch.maximum(
                torch.square(value - mb["return_"]),
                torch.square(v_clip - mb["return_"])))
        else:
            v_loss = 0.5 * torch.mean(torch.square(value - mb["return_"]))
        ent = torch.mean(self.dist.entropy(logits))
        total = pi_loss + self.vc * v_loss - self.ec * ent
        clipfrac = torch.mean((torch.abs(ratio - 1.0) > self.clip_eps).to(F32))
        return total, {"pi_loss": pi_loss, "v_loss": v_loss, "entropy": ent,
                       "clipfrac": clipfrac,
                       "approx_kl": torch.mean(mb["logp_old"] - logp)}

    def update(self, train_state: TrainState, batch, generator=None, *,
               perms=None):
        """batch: time-major (T, B) with observation/action/reward/done/value/
        logp_old/bootstrap_value.  Runs epochs x minibatches gradient steps;
        epoch e visits the samples in the order ``perms[e]`` (drawn from
        ``generator`` when None; a test passes JAX's).  The minibatch size is
        n // minibatches: the remainder of each permutation is dropped."""
        adv, ret = self.compute_advantages(batch)
        T, B = batch["reward"].shape
        n = T * B
        flat = {
            "observation": batch["observation"].flatten(0, 1),
            "action": batch["action"].flatten(0, 1),
            "logp_old": batch["logp_old"].reshape(n),
            "advantage": adv.reshape(n),
            "return_": ret.reshape(n),
            "value": batch["value"].reshape(n),
        }
        if "prev_action" in batch:
            flat["prev_action"] = batch["prev_action"].flatten(0, 1)
            flat["prev_reward"] = batch["prev_reward"].reshape(n)
        if perms is None:
            perms = [torch.randperm(n, generator=generator,
                                    device=generator.device)
                     for _ in range(self.epochs)]
        mb_size = n // self.minibatches
        leaves = pytree.tree_leaves(train_state.params)
        opt_state = train_state.opt_state
        losses, gnorms, auxes = [], [], []
        for e in range(self.epochs):
            perm = torch.as_tensor(perms[e], device=adv.device).long()
            for i in range(self.minibatches):
                idx = perm[i * mb_size:(i + 1) * mb_size]
                mb = {k: v[idx] for k, v in flat.items()}
                loss, aux, grads = grads_of(self.loss, train_state.params, mb)
                _, opt_state, gnorm = self.opt.update(grads, opt_state, leaves)
                losses.append(loss)
                gnorms.append(gnorm)
                auxes.append(aux)
        ts = TrainState(step=train_state.step + 1, params=train_state.params,
                        opt_state=opt_state, extra=None)
        extra = {k: torch.mean(torch.stack([a[k] for a in auxes]))
                 for k in auxes[0]}
        info = OptInfo(loss=torch.mean(torch.stack(losses)),
                       grad_norm=torch.mean(torch.stack(gnorms)), extra=extra)
        return ts, info


@contextlib.contextmanager
def _bf16_weights(params, cfg, specs=None):
    """JAX's ``maybe_cast``: inside the block every f32 parameter whose
    JAX leaf has two or more dims (a layer's norm scale counts its stacked
    superblock dim, as in JAX) reads as its bf16 cast, a node of the
    autograd graph, so the gradient reaches the f32 master.  The block
    spans the backward too: a checkpointed superblock's recompute reads
    the casts the forward read.  ``specs`` ({name: PartitionSpec}) pins
    each cast to its param's spec (``sharding.constrain``)."""
    swapped = []
    for mname, mod in params.named_modules():
        for name, p in list(mod._parameters.items()):
            full = f"{mname}.{name}" if mname else name
            if p is not None and p.dtype == torch.float32 and \
                    jax_ndim(full, p.dim(), cfg) >= 2:
                y = p.to(torch.bfloat16)
                if specs is not None:
                    y = shd.constrain(y, specs[full])
                swapped.append((mod, name, p))
                mod._parameters[name] = y
    try:
        yield
    finally:
        for mod, name, p in swapped:
            mod._parameters[name] = p


def make_lm_ppo_train_step(cfg, optimizer: Optimizer, *, clip_eps=0.2,
                           value_coeff=0.5, entropy_coeff=0.01,
                           n_microbatches: int = 1, aux_coeff: float = 0.01,
                           img_len: int = 0, enc_len: int = 0,
                           unroll_micro: bool = False, param_pspecs=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).

    batch (token MDP trajectories, batch-major):
      tokens (B, T) int32        observations = prev tokens
      actions (B, T) int32       sampled next tokens
      logp_old, advantage, return_ (B, T) f32
      [+ img_embed (B, I, D) when img_len (vlm); enc_frames (B, S, D) when
       enc_len (encdec): passed to forward_train as img / enc_frames, as
       JAX's; with neither, forward_train gets none]

    ``params`` is an ``LM`` with f32 master weights that require grad.
    Microbatch gradient accumulation bounds activation memory; gradients
    accumulate in f32.  The optimizer updates ``params`` in place.  Metrics
    (0-d f32 tensors): loss, grad_norm, pi_loss, v_loss, entropy, and
    ``compress_metrics``' compress_err_norm and grad_norm_shard_max when the
    optimizer is a compressed ``cross_replica`` one.

    ``cfg.cast_weights_bf16``: the forward (and its recompute) reads bf16
    casts of the f32 weight matrices (``_bf16_weights``), as JAX's
    ``maybe_cast``.  ``param_pspecs`` ({name: PartitionSpec},
    ``sharding.param_pspecs``): the casts and each microbatch's gradients
    and their sum pass ``sharding.constrain`` with their param's spec, as
    JAX's ``constrain_grads``.  ``unroll_micro`` is accepted for JAX's
    signature: JAX scans the microbatches unless it is set, the port's
    eager loop is the same either way.

    Spans (``telemetry/trace.py``): ``ppo.step`` holds ``ppo.forward`` (the
    casts and the loss) and ``ppo.backward`` (``autograd.grad``) a
    microbatch, then ``optim.update``.
    """
    del unroll_micro  # the eager loop is JAX's unrolled form already

    def loss_fn(params, mb):
        kw = {}
        if img_len:
            kw["img"] = mb["img_embed"]
        if enc_len:
            kw["enc_frames"] = mb["enc_frames"]
        hidden, aux = bb.forward_train(params, mb["tokens"], cfg, **kw)
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
        with trace.span("ppo.step", microbatches=n_microbatches):
            return _train_step(params, opt_state, batch)

    def _train_step(params, opt_state, batch):
        B = batch["tokens"].shape[0]
        if B % n_microbatches:
            raise ValueError(f"batch {B} does not split into "
                             f"{n_microbatches} microbatches")
        mb_size = B // n_microbatches
        names = [n for n, _ in params.named_parameters()]
        leaves = [p for _, p in params.named_parameters()]
        specs = None if param_pspecs is None else \
            [param_pspecs[n] for n in names]

        def constrain_grads(gs):
            if specs is None:
                return gs
            return [shd.constrain(g, sp) for g, sp in zip(gs, specs)]

        grads, loss, auxes = None, None, []
        for i in range(n_microbatches):
            mb = {k: v[i * mb_size:(i + 1) * mb_size] for k, v in batch.items()}
            # a fresh block each microbatch (a context manager enters once);
            # the casts belong to the forward, which reads them
            with contextlib.ExitStack() as casts:
                with trace.span("ppo.forward", microbatch=i):
                    if cfg.cast_weights_bf16:
                        casts.enter_context(
                            _bf16_weights(params, cfg, param_pspecs))
                    total, aux = loss_fn(params, mb)
                with trace.span("ppo.backward", microbatch=i):
                    gi = torch.autograd.grad(total, leaves,
                                             materialize_grads=True)
            with torch.no_grad():
                # g / n summed in f32, as JAX's 0 + g1/n + g2/n + ...; at
                # n = 1 the gradients themselves, without a copy.  A leaf
                # the loss does not reach (the hybrid's shared block when a
                # depth cut leaves no superblock) gets zeros, as in JAX
                g = constrain_grads([x.to(F32) if n_microbatches == 1
                                     else x.to(F32) / n_microbatches
                                     for x in gi])
                grads = g if grads is None else constrain_grads(
                    [a.add_(b) for a, b in zip(grads, g)])
            part = total.detach() / n_microbatches
            loss = part if loss is None else loss + part
            auxes.append({k: v.detach() for k, v in aux.items()})
            del g, gi, total, aux
        with trace.span("optim.update"):
            _, opt_state, gnorm = optimizer.update(grads, opt_state, leaves)
        metrics = {"loss": loss, "grad_norm": gnorm}
        for k in auxes[0]:
            metrics[k] = torch.mean(torch.stack([a[k] for a in auxes]))
        metrics.update(compress_metrics(opt_state))
        return params, opt_state, metrics

    return train_step
