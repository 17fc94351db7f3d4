"""Optimizers from scratch: Adam / AdamW and SGD with global-norm clipping,
LR schedules, Polyak target-network updates.

Port of the single-device part of ``repro/train/optim.py`` (the
cross-replica wrappers wait for ROADMAP Queue 1 item 12), as plain
functions on lists of tensors with the JAX formulas (bias correction,
``eps`` outside the square root, decoupled weight decay added to the
step).  ``Optimizer(init, update)`` keeps the JAX
interface: ``init(params) -> OptState`` and
``update(grads, state, params) -> (params, state, grad_norm)``.

Unlike JAX, ``update`` writes the new parameters and moments IN PLACE (into
the tensors of ``params`` and ``state``) and returns them: at 1.4 B
parameters a second copy of the weights and moments would cost 17 GB.
A schedule is a function of the step as a 0-d f32 tensor, and returns the
rate on the step's device; ``update`` builds its per-step scalars once, on
the params' device, so no step copies a scalar from the host per tensor.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import math

import torch
from torch.utils import _pytree as pytree

F32 = torch.float32


class OptState(NamedTuple):
    step: int
    mu: Optional[List[torch.Tensor]]
    nu: Optional[List[torch.Tensor]]


class Optimizer(NamedTuple):
    init: Callable    # params -> OptState
    update: Callable  # (grads, state, params) -> (params, state, grad_norm)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=F32, device=step.device)


def linear_warmup_cosine(peak_lr: float, warmup: int, total: int,
                         final_frac: float = 0.1):
    def sched(step):
        step = step.to(F32)
        warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return sched


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of squares) over every tensor, in f32."""
    total = None
    for t in tensors:
        sq = torch.sum(torch.square(t.to(F32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(tensors, max_norm: float):
    norm = global_norm(tensors)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return [g * scale.to(g.dtype) for g in tensors], norm


def _zeros_like_f32(params):
    return [torch.zeros(p.shape, dtype=F32, device=p.device) for p in params]


def _clip_or_norm(grads, grad_clip):
    if grad_clip is not None:
        return clip_by_global_norm(grads, grad_clip)
    return list(grads), global_norm(grads)


def _step_scalar(step: int, device) -> torch.Tensor:
    """The step as a 0-d f32 tensor made on ``device`` (a fill, not a copy
    from the host)."""
    return torch.full((), float(step), dtype=F32, device=device)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, grad_clip: Optional[float] = None
         ) -> Optimizer:
    sched = lr if callable(lr) else constant(lr)

    def init(params):
        params = list(params)
        return OptState(step=0, mu=_zeros_like_f32(params),
                        nu=_zeros_like_f32(params))

    @torch.no_grad()
    def update(grads, state: OptState, params):
        params = list(params)
        grads, gnorm = _clip_or_norm(grads, grad_clip)
        step = state.step + 1
        dev = params[0].device
        step_f = _step_scalar(step, dev)
        lr_t = sched(step_f)
        bc1 = 1 - torch.full((), b1, dtype=F32, device=dev) ** step_f
        bc2 = 1 - torch.full((), b2, dtype=F32, device=dev) ** step_f
        for p, g, m, v in zip(params, grads, state.mu, state.nu):
            g = g.to(F32)
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.to(F32)
            p.copy_((p.to(F32) - lr_t * delta).to(p.dtype))
        return params, OptState(step=step, mu=state.mu, nu=state.nu), gnorm

    return Optimizer(init, update)


def sgd(lr, momentum: float = 0.0, grad_clip: Optional[float] = None
        ) -> Optimizer:
    sched = lr if callable(lr) else constant(lr)

    def init(params):
        return OptState(step=0, mu=_zeros_like_f32(list(params)), nu=None)

    @torch.no_grad()
    def update(grads, state: OptState, params):
        params = list(params)
        grads, gnorm = _clip_or_norm(grads, grad_clip)
        step = state.step + 1
        lr_t = sched(_step_scalar(step, params[0].device))
        for p, g, m in zip(params, grads, state.mu):
            m.copy_(momentum * m + g.to(F32))
            p.copy_((p.to(F32) - lr_t * m).to(p.dtype))
        return params, OptState(step=step, mu=state.mu, nu=None), gnorm

    return Optimizer(init, update)


def soft_update(target, online, tau: float):
    """Polyak averaging for target networks (DDPG/TD3/SAC): new f32 tensors
    ``(1 - tau) * target + tau * online``, leaf by leaf, as in JAX (the
    online params are never aliased)."""
    return pytree.tree_map(
        lambda t, o: (1 - tau) * t.to(F32) + tau * o.to(F32), target, online)
