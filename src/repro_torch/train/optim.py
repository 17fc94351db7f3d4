"""Optimizers from scratch: Adam and SGD with global-norm clipping.

Port of the single-device part of ``repro/train/optim.py`` (AdamW's
weight decay, the schedules other than ``constant`` and the cross-replica
wrappers are not ported yet), as plain
functions on lists of tensors with the JAX formulas (bias correction, and
``eps`` outside the square root).  ``Optimizer(init, update)`` keeps the JAX
interface: ``init(params) -> OptState`` and
``update(grads, state, params) -> (params, state, grad_norm)``.

Unlike JAX, ``update`` writes the new parameters and moments IN PLACE (into
the tensors of ``params`` and ``state``) and returns them: at 1.4 B
parameters a second copy of the weights and moments would cost 17 GB.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import torch

F32 = torch.float32


class OptState(NamedTuple):
    step: int
    mu: Optional[List[torch.Tensor]]
    nu: Optional[List[torch.Tensor]]


class Optimizer(NamedTuple):
    init: Callable    # params -> OptState
    update: Callable  # (grads, state, params) -> (params, state, grad_norm)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=F32)


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


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         grad_clip: Optional[float] = None) -> Optimizer:
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
        step_f = torch.tensor(float(step), dtype=F32)
        lr_t = sched(step_f)
        bc1 = 1 - torch.tensor(b1, dtype=F32) ** step_f
        bc2 = 1 - torch.tensor(b2, dtype=F32) ** step_f
        for p, g, m, v in zip(params, grads, state.mu, state.nu):
            dev = p.device
            g = g.to(F32)
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            delta = (m / bc1.to(dev)) / (torch.sqrt(v / bc2.to(dev)) + eps)
            p.copy_((p.to(F32) - lr_t.to(dev) * delta).to(p.dtype))
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
        lr_t = sched(torch.tensor(float(step), dtype=F32))
        for p, g, m in zip(params, grads, state.mu):
            m.copy_(momentum * m + g.to(F32))
            p.copy_((p.to(F32) - lr_t.to(p.device) * m).to(p.dtype))
        return params, OptState(step=step, mu=state.mu, nu=None), gnorm

    return Optimizer(init, update)
