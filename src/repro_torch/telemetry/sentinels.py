"""Per-iteration health sentinels, port of ``repro/telemetry/sentinels.py``
for one device.

``Sentinels`` is a namedtuple of 0-d device tensors computed after each
update — norms, loss moments, non-finite counts, replay occupancy and
priority mass, env steps.  The TrainLoop keeps each iteration's sentinels
on the device, stacks a window of them and reads them on the host once, at
the window's end: ``first_nonfinite_iter`` for the NaN guard and
``summarize`` for the log row.  ``compute`` only reads tensors that are
already live, so turning sentinels on changes no parameter bit.

The optimizer writes the params in place, so ``compute`` needs a copy of
the params from before the update (``prev_params``) for ``update_norm``;
the loop takes that copy only when sentinels are on.

``replicate`` (the SPMD reduction of shard-local sentinels) waits for the
mesh, ROADMAP Queue 1 item 12.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core.tree import tree_global_norm

F32 = torch.float32
I32 = torch.int32


class Sentinels(NamedTuple):
    """Per-iteration on-device health scalars (all shape ())."""
    loss: Any
    loss_sq: Any            # second moment -> window variance at the host
    grad_norm: Any
    param_norm: Any
    update_norm: Any        # ||params_new - params_old||_2
    nonfinite_grads: Any    # 0/1: global grad norm went inf/nan
    nonfinite_params: Any   # count of non-finite parameter elements
    replay_filled: Any      # occupied slots (0 when no device replay)
    replay_priority_mass: Any   # sum-tree root (total priority mass)
    replay_priority_max: Any    # max leaf priority
    env_steps: Any          # env steps generated this iteration
    # compression health (0 without a compressed gradient reduction, which
    # waits for the mesh):
    compress_err_norm: Any
    grad_norm_shard_max: Any


class NonFiniteError(RuntimeError):
    """nan_guard tripwire: params went non-finite inside a window."""

    def __init__(self, iteration: int, n_bad: int):
        super().__init__(
            f"non-finite parameters first appeared at iteration {iteration} "
            f"({n_bad} bad elements)")
        self.iteration = iteration
        self.n_bad = n_bad


def count_nonfinite(tree) -> torch.Tensor:
    """Total non-finite elements across a pytree (int32 0-d tensor)."""
    total = None
    for x in pytree.tree_leaves(tree):
        if x is None:
            continue
        n = torch.sum(~torch.isfinite(x.to(F32)), dtype=I32)
        total = n if total is None else total + n
    return total


def compute(prev_params, new_params, loss, grad_norm, replay_state,
            env_steps: int) -> Sentinels:
    """Build one iteration's sentinels on the params' device.

    ``prev_params`` is a copy of the params from before the update (the
    optimizer wrote ``new_params`` in place); ``replay_state`` is a device
    ``ReplayState`` or None for on-policy loops; ``grad_norm`` is the
    already-computed value from OptInfo.
    """
    gn = torch.as_tensor(grad_norm).to(F32)
    dev = gn.device
    loss = torch.as_tensor(loss).to(F32)
    delta = pytree.tree_map(lambda a, b: a.to(F32) - b.to(F32), new_params,
                            prev_params)
    zero = torch.zeros((), dtype=F32, device=dev)
    if replay_state is not None:
        size = replay_state.tree.shape[0] // 2
        filled = replay_state.filled.to(F32)
        mass = replay_state.tree[1]
        pmax = torch.amax(replay_state.tree[size:])
    else:
        filled = mass = pmax = zero
    return Sentinels(
        loss=loss,
        loss_sq=torch.square(loss),
        grad_norm=gn,
        param_norm=tree_global_norm(new_params),
        update_norm=tree_global_norm(delta),
        nonfinite_grads=(~torch.isfinite(gn)).to(I32),
        nonfinite_params=count_nonfinite(new_params),
        replay_filled=filled,
        replay_priority_mass=mass,
        replay_priority_max=pmax,
        env_steps=torch.full((), env_steps, dtype=I32, device=dev),
        compress_err_norm=zero,
        grad_norm_shard_max=gn,
    )


def replicate(s: Sentinels, axis: str) -> Sentinels:
    raise NotImplementedError(
        "sentinels.replicate (shard-local -> global sentinels) is not ported "
        "to repro_torch yet (ROADMAP Queue 1, item 12: the mesh)")


def _host(stacked: Sentinels) -> Sentinels:
    """Every field on the host in one copy (f64 holds the int32 counts
    exactly)."""
    rows = torch.stack([x.detach().to(torch.float64) for x in stacked])
    return Sentinels(*rows.cpu().numpy())


def summarize(stacked: Sentinels) -> dict:
    """Window-stacked sentinels -> scalar log row (one host read).

    Gauges (norms, replay occupancy) report the last iteration; moments
    aggregate the whole window; counters sum it.
    """
    s = _host(stacked)
    n = max(s.loss.shape[0], 1)
    mean = float(s.loss.mean())
    var = max(float(s.loss_sq.mean()) - mean * mean, 0.0)
    return {
        "sent_loss_mean": mean,
        "sent_loss_std": float(np.sqrt(var)),
        "sent_grad_norm": float(s.grad_norm[-1]),
        "sent_param_norm": float(s.param_norm[-1]),
        "sent_update_norm": float(s.update_norm[-1]),
        "sent_nonfinite_grads": int(s.nonfinite_grads.sum()),
        "sent_nonfinite_params": int(s.nonfinite_params[-1]),
        "sent_replay_filled": float(s.replay_filled[-1]),
        "sent_priority_mass": float(s.replay_priority_mass[-1]),
        "sent_priority_max": float(s.replay_priority_max[-1]),
        "sent_env_steps": int(s.env_steps.sum()),
        "sent_window_iters": int(n),
        "sent_compress_err_norm": float(s.compress_err_norm[-1]),
        "sent_grad_norm_shard_max": float(s.grad_norm_shard_max[-1]),
    }


def first_nonfinite_iter(stacked: Sentinels) -> Optional[tuple]:
    """(window-local first bad iteration, bad-element count) or None."""
    bad = np.asarray(stacked.nonfinite_params.detach().cpu())
    hits = np.flatnonzero(bad > 0)
    if hits.size == 0:
        return None
    i = int(hits[0])
    return i, int(bad[i])
