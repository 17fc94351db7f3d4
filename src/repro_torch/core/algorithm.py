"""Algorithm base interface (paper §6.1), port of ``repro/core/algorithm.py``.

An Algorithm owns the loss and the update rule; it consumes samples gathered
by a sampler and trains the agent.  TrainState bundles the step, the params
(a pytree of tensors), the optimizer state and extras (target network).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

from .batch_spec import BatchSpec
from .narrtup import namedarraytuple

OptInfo = namedarraytuple("OptInfo", ["loss", "grad_norm", "extra"])


class TrainState(NamedTuple):
    step: Any
    params: Any
    opt_state: Any
    extra: Any = None  # e.g. target-network params


class Algorithm:
    """Subclasses define:
    batch_spec: BatchSpec — the fields ``update`` consumes and how they are
        produced; the runner stack feeds every algorithm through
        ``make_algo_batch(algo.batch_spec, ...)``
    init_train_state(generator, params) -> TrainState
    loss(params, batch, ...) -> (scalar, aux)
    update(train_state, batch, generator) -> (train_state, OptInfo)
    """

    batch_spec: Optional[BatchSpec] = None

    def init_train_state(self, generator, params) -> TrainState:
        raise NotImplementedError

    def update(self, train_state: TrainState, batch, generator=None):
        raise NotImplementedError


def grads_of(loss_fn, params, *args):
    """(loss, aux, grads) of ``loss_fn(params, *args) -> (loss, aux)``:
    grads a list in ``tree_leaves(params)`` order, loss and aux detached."""
    leaves, spec = pytree.tree_flatten(params)
    work = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, aux = loss_fn(pytree.tree_unflatten(work, spec), *args)
        grads = torch.autograd.grad(loss, work)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            list(grads))
