"""Checkpoint / restart, port of ``repro/train/checkpoint.py`` in its format.

Format: one ``.npz`` of the flattened leaves plus a JSON manifest (step,
leaf paths, shapes and dtypes, the mesh shape at save time), both written
atomically (a temporary file, then ``os.replace``), so a preempted run never
leaves a torn checkpoint.  A leaf's path is built as JAX's ``_path_str``
builds it (dict keys, sequence indices and ``.field`` for named tuples,
joined by ``/``), and ``restore_checkpoint`` matches leaves by that path,
never by position: JAX flattens a dict in sorted key order, torch in
insertion order.  So a tree of dicts, lists and arrays written by either
package restores in the other with identical values.

The port's Python-int leaves (``TrainState.step``, ``OptState.step``, the
replay ring's ``cursor`` and ``filled``) are stored as 0-d int32 arrays, as
JAX stores its int32 steps, and come back as ints; ``None`` is no leaf, as
in JAX.  No generator state is saved (JAX saves no PRNG key).  Elastic
re-sharding (``shardings=``) waits for ROADMAP Queue 1 item 12.

The port's optimizers keep their moments as flat lists in the params' leaf
order, JAX's as trees shaped like the params.  ``save_checkpoint`` writes
every ``TrainState`` it meets in JAX's layout and ``restore_checkpoint``
reads it back into the port's, so every runner writes one layout and a whole
train state (params, optimizer state, targets) saved by one package
restores in the other.

An LM (``models/backbones.LM``) keeps one module per layer where JAX stacks
each superblock's leaves.  ``save_lm_checkpoint`` writes ``(params,
opt_state)`` as JAX's ``launch/train.py`` does, in JAX's layout: stacked
``blocks``, moments shaped like the params (``models/convert.py``
``params_to_jax``), staged through host memory; ``restore_lm_checkpoint``
reads such a checkpoint, from either package, back into the LM's
parameters and moments in place.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core.algorithm import TrainState
from ..models.convert import params_of_jax, params_to_jax
from .optim import OptState

_INT32 = np.iinfo(np.int32)


def _path_str(path) -> str:
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return "/".join(parts)


def _leaves(tree):
    """(path string, leaf) of every leaf but ``None``."""
    return [(_path_str(path), leaf) for path, leaf in
            pytree.tree_flatten_with_path(tree)[0] if leaf is not None]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, int) and not isinstance(leaf, bool) and \
            _INT32.min <= leaf <= _INT32.max:
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _moment_owners(train_state):
    """The params each optimizer state of ``train_state`` steps: the whole
    params for a single OptState (DQN, R2D1, A2C, PPO); for a dict of them
    (DDPG / TD3 / SAC) ``params[key]``, or ``extra["log_" + key]`` (SAC's
    alpha)."""
    opt, params = train_state.opt_state, train_state.params
    if isinstance(opt, OptState):
        return params
    return {k: params[k] if k in params else train_state.extra[f"log_{k}"]
            for k in opt}


def _map_opt(train_state, fn):
    opt = train_state.opt_state
    if opt is None:
        return train_state
    owners = _moment_owners(train_state)
    if isinstance(opt, OptState):
        return train_state._replace(opt_state=fn(opt, owners))
    return train_state._replace(
        opt_state={k: fn(opt[k], owners[k]) for k in opt})


def _moments_as(state: OptState, fn) -> OptState:
    return state._replace(mu=None if state.mu is None else fn(state.mu),
                          nu=None if state.nu is None else fn(state.nu))


def _to_tree(state, owner):
    spec = pytree.tree_structure(owner)
    return _moments_as(state, lambda m: pytree.tree_unflatten(m, spec))


def _to_list(state, owner):
    return _moments_as(state, pytree.tree_leaves)


def _each_train_state(tree, fn):
    """``tree`` with ``_map_opt(ts, fn)`` for every TrainState ``ts`` in it;
    the tensors are shared."""
    return pytree.tree_map(
        lambda x: _map_opt(x, fn) if isinstance(x, TrainState) else x, tree,
        is_leaf=lambda x: isinstance(x, TrainState))


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, *,
                    extra: Optional[dict] = None) -> str:
    """Write ``tree`` as ``step_{step:010d}.npz`` / ``.json`` in
    ``ckpt_dir``; returns the ``.npz`` path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tree = _each_train_state(tree, _to_tree)
    arrays, manifest_leaves = {}, []
    for i, (path, leaf) in enumerate(_leaves(tree)):
        name = f"leaf_{i}"
        arr = _to_numpy(leaf)
        arrays[name] = arr
        manifest_leaves.append({"name": name, "path": path,
                                "shape": list(arr.shape),
                                "dtype": str(arr.dtype)})
    manifest = {"step": int(step), "n_leaves": len(arrays),
                "mesh_shape": None, "leaves": manifest_leaves,
                "extra": extra or {}}
    final_npz = os.path.join(ckpt_dir, f"step_{step:010d}.npz")
    final_json = os.path.join(ckpt_dir, f"step_{step:010d}.json")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".npz.tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, final_npz)
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".json.tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, final_json)
    return final_npz


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(fn[5:-5]) for fn in os.listdir(ckpt_dir)
             if fn.startswith("step_") and fn.endswith(".json")]
    return max(steps) if steps else None


def _restored(arr: np.ndarray, like, device):
    if isinstance(like, bool):
        return bool(arr)
    if isinstance(like, int):
        return int(arr)
    if isinstance(like, float):
        return float(arr)
    if device is None:
        device = like.device if isinstance(like, torch.Tensor) else "cpu"
    return torch.from_numpy(arr).to(device)


def restore_checkpoint(ckpt_dir: str, tree_like: Any, *,
                       step: Optional[int] = None, device=None,
                       shardings: Any = None):
    """Restore into the structure of ``tree_like``; returns (tree,
    manifest).  Tensors land on ``device``, or where the matching leaf of
    ``tree_like`` lies when ``device`` is None; int, bool and float leaves
    come back as Python values."""
    if shardings is not None:
        raise NotImplementedError("restore_checkpoint: shardings= is not "
                                  "ported to repro_torch yet (ROADMAP Queue "
                                  "1, item 12)")
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    with open(os.path.join(ckpt_dir, f"step_{step:010d}.json")) as f:
        manifest = json.load(f)
    flat, spec = pytree.tree_flatten_with_path(
        _each_train_state(tree_like, _to_tree))
    n = sum(leaf is not None for _, leaf in flat)
    if n != manifest["n_leaves"]:
        raise ValueError(f"tree has {n} leaves, checkpoint "
                         f"{manifest['n_leaves']}")
    by_path = {m["path"]: m for m in manifest["leaves"]}
    out = []
    with np.load(os.path.join(ckpt_dir, f"step_{step:010d}.npz")) as data:
        for path, like in flat:
            if like is None:
                out.append(None)
                continue
            key = _path_str(path)
            if key not in by_path:
                raise KeyError(f"{key}: not in the checkpoint")
            arr = data[by_path[key]["name"]]
            if tuple(arr.shape) != tuple(np.shape(like)):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} vs "
                                 f"model {tuple(np.shape(like))}")
            out.append(_restored(arr, like, device))
    return _each_train_state(pytree.tree_unflatten(out, spec),
                             _to_list), manifest


def _lm_tree(params, opt_state: OptState, cfg, fn):
    """``(params, opt_state)`` of an LM in JAX's layout, each tensor passed
    through ``fn`` before it is stacked."""
    names = [n for n, _ in params.named_parameters()]

    def tree(tensors):
        return params_to_jax(((n, fn(t)) for n, t in zip(names, tensors)),
                             cfg)

    return (tree([p for _, p in params.named_parameters()]),
            _moments_as(opt_state, tree))


def save_lm_checkpoint(ckpt_dir: str, step: int, params, opt_state: OptState,
                       cfg, *, extra: Optional[dict] = None) -> str:
    """Write an LM's ``(params, opt_state)`` in JAX's layout; returns the
    ``.npz`` path."""
    return save_checkpoint(ckpt_dir, step,
                           _lm_tree(params, opt_state, cfg,
                                    lambda t: t.detach().cpu()),
                           extra=extra)


@torch.no_grad()
def restore_lm_checkpoint(ckpt_dir: str, params, opt_state: OptState, cfg, *,
                          step: Optional[int] = None):
    """Restore an LM checkpoint (JAX's layout, written by either package)
    into ``params`` and ``opt_state``'s moments in place, leaf by leaf
    through host memory; returns (opt_state with the saved step,
    manifest)."""
    like = _lm_tree(params, opt_state, cfg,
                    lambda t: torch.empty_like(t, device="meta"))
    (ptree, saved), manifest = restore_checkpoint(ckpt_dir, like, step=step,
                                                  device="cpu")
    names = [n for n, _ in params.named_parameters()]
    dests = [p for _, p in params.named_parameters()]
    srcs = params_of_jax(ptree, names, cfg)
    for moments, tree in ((opt_state.mu, saved.mu), (opt_state.nu, saved.nu)):
        if moments is not None:
            dests += moments
            srcs += params_of_jax(tree, names, cfg)
    for dst, src in zip(dests, srcs):
        dst.copy_(src)
    return opt_state._replace(step=saved.step), manifest
