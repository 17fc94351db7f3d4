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

The port's Python-int leaves (``TrainState.step``) are stored as 0-d int32
arrays, as JAX stores its int32 steps, and come back as ints; its 0-d int32
tensors (``OptState.step``, the replay ring's ``cursor`` and ``filled``)
are stored the same way and come back as tensors; ``None`` is no leaf, as
in JAX.  No generator state is saved (JAX saves no PRNG key).

On a data mesh (``launch/mesh.py``) each rank holds its block of the leaves
sharded over the mesh's axis (the replay rings, the EF residual) and the
whole of the replicated ones.  ``shardings`` names the sharded leaves: a
prefix tree of ``tree`` whose leaves are a ``DataMesh`` (sharded over its
axis on dim 0) or None (replicated), as JAX's tree of NamedShardings.
``save_checkpoint(shardings=, mesh=)`` gathers each sharded leaf to its
global value, JAX's layout, and the mesh's rank 0 writes the files (the
manifest's ``mesh_shape`` records the mesh); ``restore_checkpoint(shardings=)`` gives
each rank the replicated leaves whole and its block of each sharded one,
so a run saved on N ranks restores on M (elastic re-sharding) wherever the
leaves' global shapes agree.  Without ``shardings`` a restore returns the
global leaves whole.

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
parameters and moments in place.  On a (data x model) mesh
(``launch/mesh.py``'s ``Mesh2D``) the save gathers each leaf the model
axis splits to its global value, leaf by leaf through the host (a 14 B
parameter state does not fit one card), the mesh's first rank writes and
the manifest's ``mesh_shape`` is (D, M); the restore hands each rank its
block, so a checkpoint saved at one model extent restores at another.
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
from ..models import sharding as shd
from ..models.convert import params_of_jax, params_to_jax
from .compress import EFState
from .optim import CrossReplicaState, OptState, cross_replica_specs

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


_SINGLE = (OptState, CrossReplicaState)


def _moment_owners(train_state):
    """The params each optimizer state of ``train_state`` steps: the whole
    params for a single OptState (DQN, R2D1, A2C, PPO; or its
    CrossReplicaState); for a dict of them (DDPG / TD3 / SAC)
    ``params[key]``, or ``extra["log_" + key]`` (SAC's alpha)."""
    opt, params = train_state.opt_state, train_state.params
    if isinstance(opt, _SINGLE):
        return params
    return {k: params[k] if k in params else train_state.extra[f"log_{k}"]
            for k in opt}


def _map_opt(train_state, fn):
    opt = train_state.opt_state
    if opt is None:
        return train_state
    owners = _moment_owners(train_state)
    if isinstance(opt, _SINGLE):
        return train_state._replace(opt_state=fn(opt, owners))
    return train_state._replace(
        opt_state={k: fn(opt[k], owners[k]) for k in opt})


def _moments_as(state, fn):
    """``state`` with ``fn`` applied to each list shaped like the params: an
    OptState's moments, and a CrossReplicaState's EF residual besides its
    inner state's moments."""
    if isinstance(state, CrossReplicaState):
        return state._replace(inner=_moments_as(state.inner, fn),
                              ef=EFState(residual=fn(state.ef.residual)))
    return state._replace(mu=None if state.mu is None else fn(state.mu),
                          nu=None if state.nu is None else fn(state.nu))


def _to_tree(state, owner):
    spec = pytree.tree_structure(owner)
    return _moments_as(state, lambda m: pytree.tree_unflatten(m, spec))


def _to_list(state, owner):
    return _moments_as(state, pytree.tree_leaves)


def _is_mesh(x) -> bool:
    """A sharding leaf: a mesh axis (``launch/mesh.DataMesh``) that gathers
    and splits blocks."""
    return hasattr(x, "all_gather") and hasattr(x, "block")


def _sharded_paths(shardings) -> dict:
    """{path: mesh} of every mesh leaf of a ``shardings`` prefix tree
    (None leaves, replicated, are left out)."""
    if shardings is None:
        return {}
    flat, _ = pytree.tree_flatten_with_path(
        shardings, is_leaf=lambda x: x is None or _is_mesh(x))
    return {_path_str(path): m for path, m in flat if _is_mesh(m)}


def _mesh_for(path: str, sharded: dict):
    """The mesh ``path`` is sharded over (its own entry or an ancestor's),
    or None."""
    parts = path.split("/")
    for i in range(len(parts), 0, -1):
        m = sharded.get("/".join(parts[:i]))
        if m is not None:
            return m
    return sharded.get("")


def _each_train_state(tree, fn):
    """``tree`` with ``_map_opt(ts, fn)`` for every TrainState ``ts`` in it;
    the tensors are shared."""
    return pytree.tree_map(
        lambda x: _map_opt(x, fn) if isinstance(x, TrainState) else x, tree,
        is_leaf=lambda x: isinstance(x, TrainState))


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, *,
                    extra: Optional[dict] = None, shardings: Any = None,
                    mesh=None, model=None) -> str:
    """Write ``tree`` as ``step_{step:010d}.npz`` / ``.json`` in
    ``ckpt_dir``; returns the ``.npz`` path.  ``mesh`` (default: the mesh
    ``shardings`` names, see the module docstring) is the data mesh whose
    ranks all call this: the sharded leaves are gathered, the mesh's rank
    0 writes, every rank returns once the files are in place, and the
    manifest's ``mesh_shape`` is the mesh's.  ``model``: a model axis
    beside it (every rank of both calls this; ``tree`` holds global
    values): its rank 0 of data rank 0 writes, and ``mesh_shape`` is
    (D, M)."""
    sharded = _sharded_paths(shardings)
    if mesh is None and sharded:
        mesh = next(iter(sharded.values()))
    tree = _each_train_state(tree, _to_tree)
    arrays, manifest_leaves = {}, []
    for i, (path, leaf) in enumerate(_leaves(tree)):
        name = f"leaf_{i}"
        over = _mesh_for(path, sharded)
        if over is not None:
            leaf = over.all_gather(torch.as_tensor(leaf), dim=0)
        arr = _to_numpy(leaf)
        arrays[name] = arr
        manifest_leaves.append({"name": name, "path": path,
                                "shape": list(arr.shape),
                                "dtype": str(arr.dtype)})
    shape = None if mesh is None else [mesh.size]
    if model is not None:
        shape = [1 if mesh is None else mesh.size, model.size]
    manifest = {"step": int(step), "n_leaves": len(arrays),
                "mesh_shape": shape,
                "leaves": manifest_leaves, "extra": extra or {}}
    final_npz = os.path.join(ckpt_dir, f"step_{step:010d}.npz")
    final_json = os.path.join(ckpt_dir, f"step_{step:010d}.json")
    if (mesh is None or mesh.index == 0) and \
            (model is None or model.index == 0):
        _write(ckpt_dir, final_npz, final_json, arrays, manifest)
    # every rank returns once the writer has written: the writer's data
    # group waits for it, then each model group for its data rank
    for axis in (mesh, model):
        if axis is not None and axis.distributed:
            axis.barrier()
    return final_npz


def _write(ckpt_dir, final_npz, final_json, arrays, manifest) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".npz.tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, final_npz)
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".json.tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, final_json)


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
    come back as Python values.  ``shardings`` (see the module docstring):
    each leaf under a ``DataMesh`` comes back as this rank's block of the
    saved global leaf, on whatever mesh the checkpoint was saved."""
    sharded = _sharded_paths(shardings)
    for m in sharded.values():
        if not m.distributed and m.size > 1:
            raise ValueError("restore_checkpoint(shardings=): a mesh of "
                             f"{m.size} shards without a process group has "
                             "no rank to restore a block for")
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
            mesh = _mesh_for(key, sharded)
            if mesh is not None:
                arr = mesh.block(torch.from_numpy(arr), dim=0).numpy()
            if tuple(arr.shape) != tuple(np.shape(like)):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} vs "
                                 f"model {tuple(np.shape(like))}")
            out.append(_restored(arr, like, device))
    return _each_train_state(pytree.tree_unflatten(out, spec),
                             _to_list), manifest


def _lm_tree(params, opt_state, cfg, fn):
    """``(params, opt_state)`` of an LM in JAX's layout, each tensor passed
    through ``fn(name, tensor)`` before it is stacked.  A
    ``CrossReplicaState``'s EF residual (this rank's slice, (1,) + a
    param's shape a leaf) becomes JAX's (1,) + the stacked leaf's shape:
    its block of the (ef_shards, ...) global leaf."""
    names = [n for n, _ in params.named_parameters()]

    def tree(tensors):
        return params_to_jax(((n, fn(n, t)) for n, t in zip(names, tensors)),
                             cfg)

    def opt_tree(state):
        if isinstance(state, CrossReplicaState):
            res = pytree.tree_map(lambda x: x[None], tree(
                [r[0] for r in state.ef.residual]))
            return state._replace(inner=opt_tree(state.inner),
                                  ef=EFState(residual=res))
        return _moments_as(state, tree)

    return (tree([p for _, p in params.named_parameters()]),
            opt_tree(opt_state))


def _lm_shardings(opt_state, mesh):
    """The ``shardings`` prefix of ``_lm_tree``'s pair: the EF residual
    sharded over ``mesh``, everything else replicated."""
    if mesh is None or not isinstance(opt_state, CrossReplicaState):
        return None
    return (None, cross_replica_specs(mesh))


def _lm_axes(params, cfg, mesh):
    """(data axis, model axis or None, {name: spec} on the model axis) of
    ``mesh``: a data ``DataMesh``, a ``Mesh2D`` or None."""
    model = getattr(mesh, "model", None)
    data = getattr(mesh, "data", mesh)
    if model is None or model.size == 1:
        return data, None, None
    return data, model, shd.param_pspecs(params, cfg, tp=model.size)


def _leaf_dim(t, spec) -> int:
    """How many leading dims ``t`` has before its param's (the EF
    residual's shard dim)."""
    return t.dim() - len(spec)


def save_lm_checkpoint(ckpt_dir: str, step: int, params, opt_state, cfg, *,
                       extra: Optional[dict] = None, mesh=None) -> str:
    """Write an LM's ``(params, opt_state)`` in JAX's layout; returns the
    ``.npz`` path.  ``opt_state``: an ``OptState``, or on a data ``mesh``
    (every rank calls this) a compressed ``cross_replica`` optimizer's
    ``CrossReplicaState``, whose EF residual slices are gathered into
    JAX's (ef_shards, ...) leaves; the mesh's rank 0 writes.  ``mesh`` may
    be a ``Mesh2D``: each leaf its model axis splits is gathered, one at a
    time, to its global value on the host."""
    data, model, specs = _lm_axes(params, cfg, mesh)

    def host(name, t):
        if model is not None:
            sp = specs[name]
            lead = _leaf_dim(t, sp)
            t = shd.gather_leaf(name, t.detach(),
                                shd.P(*([None] * lead), *sp), model)
        return t.detach().cpu()

    return save_checkpoint(ckpt_dir, step,
                           _lm_tree(params, opt_state, cfg, host),
                           extra=extra,
                           shardings=_lm_shardings(opt_state, data),
                           mesh=data, model=model)


@torch.no_grad()
def restore_lm_checkpoint(ckpt_dir: str, params, opt_state, cfg, *,
                          step: Optional[int] = None, mesh=None):
    """Restore an LM checkpoint (JAX's layout, written by either package)
    into ``params`` and ``opt_state``'s moments (and EF residual: this
    rank's block on ``mesh``) in place, leaf by leaf through host memory;
    returns (opt_state with the saved step, manifest).  On a ``Mesh2D``
    each rank takes its block of every leaf its model axis splits."""
    data, model, specs = _lm_axes(params, cfg, mesh)

    def global_like(name, t):
        shape = list(t.shape)
        if model is not None:
            for d in shd.model_dims(specs[name]):
                shape[_leaf_dim(t, specs[name]) + d] *= model.size
        return torch.empty(shape, dtype=t.dtype, device="meta")

    like = _lm_tree(params, opt_state, cfg, global_like)
    (ptree, saved), manifest = restore_checkpoint(
        ckpt_dir, like, step=step, device="cpu",
        shardings=_lm_shardings(opt_state, data))
    names = [n for n, _ in params.named_parameters()]
    dests = [p for _, p in params.named_parameters()]
    owners = list(names)
    srcs = params_of_jax(ptree, names, cfg)
    inner, saved_inner = opt_state, saved
    if isinstance(opt_state, CrossReplicaState):
        inner, saved_inner = opt_state.inner, saved.inner
        dests += [r[0] for r in opt_state.ef.residual]
        owners += names
        srcs += params_of_jax(pytree.tree_map(lambda x: x[0],
                                              saved.ef.residual), names, cfg)
        dests += [opt_state.shard_grad_norm, opt_state.ef_err_norm]
        owners += [None, None]
        srcs += [saved.shard_grad_norm, saved.ef_err_norm]
    for moments, tree in ((inner.mu, saved_inner.mu),
                          (inner.nu, saved_inner.nu)):
        if moments is not None:
            dests += moments
            owners += names
            srcs += params_of_jax(tree, names, cfg)
    for dst, src, name in zip(dests, srcs, owners):
        if model is not None and name is not None:
            src = shd.local_slice(name, src, specs[name], model)
        dst.copy_(src)
    inner = inner._replace(step=saved_inner.step.to(inner.step.device))
    if isinstance(opt_state, CrossReplicaState):
        return opt_state._replace(inner=inner), manifest
    return inner, manifest
