"""Optimizers from scratch: Adam / AdamW and SGD with global-norm clipping,
LR schedules, Polyak target-network updates.

Port of ``repro/train/optim.py``, as plain functions on lists of tensors
with the JAX formulas (bias correction, ``eps`` outside the square root,
decoupled weight decay added to the step).  ``Optimizer(init, update)``
keeps the JAX interface: ``init(params) -> OptState`` and
``update(grads, state, params) -> (params, state, grad_norm)``.
``cross_replica`` wraps an optimizer for the data-parallel mesh
(``launch/mesh.py``): the gradients are all-reduced over the mesh's ranks,
in f32 or in int8 with error feedback (``train/compress.py``), before the
inner update.

On a 'model' axis of ranks each rank holds a block of some leaves
(``models/sharding.py``'s ``ModelSplit``).  ``cross_replica(model=)`` owns
the split: it first sums the split-use leaves' partial gradients over the
model axis, then reduces over the data axis, and hands the split to the
wrapped update (``update(..., tp=)``), whose global norm, and so its clip,
is then the norm of the logical tensors (a sharded leaf's sum of squares
summed over the model axis, a replicated one counted once).

Unlike JAX, ``update`` writes the new parameters and moments IN PLACE (into
the tensors of ``params`` and ``state``) and returns them: at 1.4 B
parameters a second copy of the weights and moments would cost 17 GB.
``OptState.step`` is a 0-d int32 tensor on the params' device, as JAX's
count is an int32 array: the host never reads it, so an update captured in
a CUDA graph advances it on every replay.  A schedule is a function of the
step as a 0-d f32 tensor, and returns the rate on the step's device;
``update`` builds its per-step scalars once, on the params' device, so no
step copies a scalar from the host.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional

import math

import torch
from torch.utils import _pytree as pytree

from .compress import CHUNK, EFState, cross_pod_allreduce_

F32 = torch.float32


class OptState(NamedTuple):
    step: torch.Tensor    # 0-d int32 on the params' device
    mu: Optional[List[torch.Tensor]]
    nu: Optional[List[torch.Tensor]]


class CrossReplicaState(NamedTuple):
    """State of a compressed ``cross_replica`` optimizer: the wrapped
    optimizer's state plus this rank's error-feedback residual (a list in
    the params' order, each leaf with a leading shard dim of 1: the rank's
    block of the global (ef_shards, ...) leaf) and two replicated health
    scalars the telemetry sentinels read."""
    inner: Any
    ef: EFState
    shard_grad_norm: torch.Tensor   # pmax over ranks of the pre-reduce norm
    ef_err_norm: torch.Tensor       # global Frobenius norm of the residual


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


def sum_squares(tensors, tp=None) -> torch.Tensor:
    """Sum of squares over every tensor, in f32; a leaf of more than
    ``CHUNK`` elements is squared ``CHUNK`` at a time (no temporary the
    size of the leaf).  ``tp`` (a ``sharding.ModelSplit`` of the tensors'
    leaves): the sum over the logical tensors, every rank's blocks of a
    sharded leaf summed over the model axis."""
    if tp is not None:
        tensors = list(tensors)
        sharded = [t for t, s in zip(tensors, tp.sharded) if s]
        whole = [t for t, s in zip(tensors, tp.sharded) if not s]
        dev = tensors[0].device
        zero = torch.zeros((), dtype=F32, device=dev)
        return tp.mesh.psum(sum_squares(sharded) if sharded else zero) + \
            (sum_squares(whole) if whole else zero)
    total = None
    for t in tensors:
        t = t.to(F32)
        if t.numel() > CHUNK and t.is_contiguous():
            flat = t.view(-1)
            sq = sum(torch.sum(torch.square(flat[i:i + CHUNK]))
                     for i in range(0, flat.numel(), CHUNK))
        else:
            sq = torch.sum(torch.square(t))
        total = sq if total is None else total + sq
    return total


def global_norm(tensors, tp=None) -> torch.Tensor:
    """sqrt(sum of squares) over every tensor, in f32 (the logical
    tensors' under ``tp``, see ``sum_squares``)."""
    return torch.sqrt(sum_squares(tensors, tp))


def clip_by_global_norm(tensors, max_norm: float, tp=None):
    norm = global_norm(tensors, tp)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return [g * scale.to(g.dtype) for g in tensors], norm


def _zeros_like_f32(params):
    return [torch.zeros(p.shape, dtype=F32, device=p.device) for p in params]


def _clip_or_norm(grads, grad_clip, tp=None):
    if grad_clip is not None:
        return clip_by_global_norm(grads, grad_clip, tp)
    return list(grads), global_norm(grads, tp)


def _step_zero(params) -> torch.Tensor:
    """The count before the first update: 0-d int32 on the params' device."""
    return torch.zeros((), dtype=torch.int32, device=params[0].device)


def _leaf_chunks(*tensors):
    """Matching flat pieces of at most ``CHUNK`` elements of same-shape
    tensors (each whole where one is not contiguous), so the element-wise
    update of a 590 M-element embedding holds a few chunks of temporaries,
    not a few copies of the leaf."""
    n = tensors[0].numel()
    if n <= CHUNK or not all(t.is_contiguous() for t in tensors):
        return [tensors]
    flats = [t.view(-1) for t in tensors]
    return [tuple(f[i:i + CHUNK] for f in flats) for i in range(0, n, CHUNK)]


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, grad_clip: Optional[float] = None
         ) -> Optimizer:
    """Adam (AdamW with ``weight_decay``) with optional global-norm
    clipping.  The clip scale multiplies each gradient where the update
    reads it (``clip_by_global_norm``'s values, without a clipped copy of
    the whole gradient), and each leaf is updated ``CHUNK`` elements at a
    time.  ``update``'s ``tp`` is the params' ``ModelSplit`` on a model
    axis, which ``cross_replica(model=)`` passes (the norm of the logical
    tensors)."""
    sched = lr if callable(lr) else constant(lr)

    def init(params):
        params = list(params)
        return OptState(step=_step_zero(params), mu=_zeros_like_f32(params),
                        nu=_zeros_like_f32(params))

    @torch.no_grad()
    def update(grads, state: OptState, params, tp=None):
        params, grads = list(params), list(grads)
        gnorm = global_norm(grads, tp)
        clip = None if grad_clip is None else torch.clamp(
            grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        step = state.step + 1
        dev = params[0].device
        step_f = step.to(F32)
        lr_t = sched(step_f)
        bc1 = 1 - torch.full((), b1, dtype=F32, device=dev) ** step_f
        bc2 = 1 - torch.full((), b2, dtype=F32, device=dev) ** step_f
        for leaf in zip(params, grads, state.mu, state.nu):
            for p, g, m, v in _leaf_chunks(*leaf):
                if clip is not None:
                    g = g * clip.to(g.dtype)
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
        params = list(params)
        return OptState(step=_step_zero(params), mu=_zeros_like_f32(params),
                        nu=None)

    @torch.no_grad()
    def update(grads, state: OptState, params, tp=None):
        params = list(params)
        grads, gnorm = _clip_or_norm(grads, grad_clip, tp)
        step = state.step + 1
        lr_t = sched(step.to(F32))
        for p, g, m in zip(params, grads, state.mu):
            m.copy_(momentum * m + g.to(F32))
            p.copy_((p.to(F32) - lr_t * m).to(p.dtype))
        return params, OptState(step=step, mu=state.mu, nu=None), gnorm

    return Optimizer(init, update)


def _axes(axis) -> tuple:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def cross_replica(opt: Optimizer, axis, *, compress: Optional[str] = None,
                  ef_shards: int = 1, scale_groups=None,
                  model=None) -> Optimizer:
    """Data-parallel wrapper: all-reduce grads over ``axis`` before the inner
    update (paper §2.4 synchronous multi-GPU: "gradients all-reduced").

    ``axis`` is a ``launch.mesh.DataMesh`` (the port's counterpart of a
    bound axis name) or a tuple of them, outermost first.  Because every
    loss in the repo is a mean over its (rank-local) batch, the pmean of
    per-rank grads equals the gradient of the global-batch mean, so the
    wrapped update, run on every rank with replicated params, is the SAME
    update the serial loop takes on the full batch.  Clipping and the
    reported grad norm see the reduced grads.  Idempotent: wrapping twice
    with the same (axis, compress) is a no-op.

    With ``compress=None`` the grads pmean over every axis of the tuple (one
    all-reduce an axis).  With ``compress="int8_ef"`` the reduction has two
    stages: a full-precision pmean over the inner axes (``axis[1:]``), then
    the int8 error-feedback all-reduce (``cross_pod_allreduce``) over the
    outermost axis.  Compression carries state: ``init`` wraps the inner
    state in ``CrossReplicaState`` with this rank's EF residual, one slice
    of the global (ef_shards, ...) leaf, so each leaf is (1,) + the
    param's shape; ``ef_shards`` must be the outer axis' size.  The
    compressed update reduces the gradients it is given in place (each
    step's fresh ones: no caller reads them afterwards) where they are
    contiguous f32.  ``scale_groups`` (``compress.cross_pod_allreduce_``'s ``groups``) lets
    leaves share an int8 scale: an LM's layers, which JAX stacks into one
    leaf (``models.convert.jax_leaf_groups``).

    ``model`` (a ``sharding.ModelSplit``): the params are a rank's blocks
    on a model axis.  The split-use leaves' partial gradients are summed
    over it first; ``axis`` reduces over the data axes only; the int8
    scales are maxed over the model axis (``cross_pod_allreduce_``);
    ``shard_grad_norm`` / ``ef_err_norm`` and the wrapped update's norm
    (``opt.update(..., tp=model)``) are the logical tensors' norms.
    """
    axes = _axes(axis)
    tag = (axes, compress) if model is None else (axes, compress, model)
    if getattr(opt.update, "_cross_replica_axis", None) == tag:
        return opt

    def model_sums(grads):
        return list(grads) if model is None else model.sum_split_(grads)

    def inner_update(grads, state, params):
        if model is None:
            return opt.update(grads, state, params)
        return opt.update(grads, state, params, tp=model)

    if compress is None:
        def update(grads, state, params):
            grads = model_sums(grads)
            for ax in axes:
                grads = ax.pmean_all(grads)
            return inner_update(grads, state, params)

        update._cross_replica_axis = tag
        return Optimizer(opt.init, update)

    if compress != "int8_ef":
        raise ValueError(f"unknown compress mode {compress!r} "
                         f"(supported: 'int8_ef')")
    outer, inner_axes = axes[0], axes[1:]
    if ef_shards != outer.size:
        raise ValueError(f"ef_shards {ef_shards} but the compressed axis "
                         f"{outer.axis!r} has {outer.size} ranks")

    def init(params):
        params = list(params)
        return CrossReplicaState(
            inner=opt.init(params),
            ef=EFState(residual=[torch.zeros((1,) + tuple(p.shape), dtype=F32,
                                             device=p.device)
                                 for p in params]),
            shard_grad_norm=torch.zeros((), dtype=F32,
                                        device=params[0].device),
            ef_err_norm=torch.zeros((), dtype=F32, device=params[0].device))

    @torch.no_grad()
    def update(grads, state: CrossReplicaState, params):
        grads = model_sums(grads)
        for ax in inner_axes:  # stage 1: full-precision inner reduction
            grads = ax.pmean_all(grads)
        # reduced in place: a copy only of a gradient that is not
        # contiguous f32
        grads = [g.to(F32).contiguous() for g in grads]
        local_norm = global_norm(grads, model)
        # stage 2: int8 + error feedback over the outermost axis, on this
        # rank's slice of the residual (updated in place)
        cross_pod_allreduce_(grads, [r[0] for r in state.ef.residual],
                             axis=outer, groups=scale_groups,
                             model=None if model is None else model.mesh)
        err_sq = sum_squares(state.ef.residual, model)
        new_params, inner_state, gnorm = inner_update(grads, state.inner,
                                                      params)
        new_state = CrossReplicaState(
            inner=inner_state, ef=state.ef,
            shard_grad_norm=outer.pmax(local_norm),
            ef_err_norm=torch.sqrt(outer.psum(err_sq)))
        return new_params, new_state, gnorm

    update._cross_replica_axis = tag
    return Optimizer(init, update)


def cross_replica_specs(mesh) -> CrossReplicaState:
    """Which leaves of a ``CrossReplicaState`` are per rank, as a prefix
    tree for ``train.checkpoint`` (``shardings=``): the EF residual is
    sharded over ``mesh``'s axis (one slice a rank), everything else
    replicated (None)."""
    return CrossReplicaState(inner=None, ef=EFState(residual=mesh),
                             shard_grad_norm=None, ef_err_norm=None)


def cross_replica_states(opt_state) -> list:
    """Every CrossReplicaState node of a tree (an optimizer state, a dict of
    them)."""
    return [s for s in pytree.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, CrossReplicaState))
        if isinstance(s, CrossReplicaState)]


def compress_metrics(opt_state) -> dict:
    """Compression-health scalars from any tree holding CrossReplicaState
    nodes: residual norm (summed in quadrature over several optimizers) and
    max pre-reduce shard grad norm.  {} when nothing is compressed."""
    states = cross_replica_states(opt_state)
    if not states:
        return {}
    err = torch.sqrt(sum(torch.square(s.ef_err_norm) for s in states))
    shard = torch.amax(torch.stack([s.shard_grad_norm for s in states]))
    return {"compress_err_norm": err, "grad_norm_shard_max": shard}


def soft_update(target, online, tau: float):
    """Polyak averaging for target networks (DDPG/TD3/SAC): new f32 tensors
    ``(1 - tau) * target + tau * online``, leaf by leaf, as in JAX (the
    online params are never aliased)."""
    return pytree.tree_map(
        lambda t, o: (1 - tau) * t.to(F32) + tau * o.to(F32), target, online)
