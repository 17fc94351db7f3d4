"""Sharding rules: logical param/activation axes -> mesh axes (the rules
half of ``repro/models/sharding.py``), and their execution on a 'model'
axis of ranks.

Specs are derived from (leaf name, shape) by ``param_pspecs``, so init
code and sharding rules cannot drift.  ``PartitionSpec`` is the port's own
tuple of mesh-axis names (``None``, a name, or a tuple of names a dim),
the shape of JAX's.

The port's params are per-layer modules (``LM.named_parameters()``), where
JAX stacks each superblock leaf along leading scan dims
(``models/convert.py``).  A JAX rule pads a stacked leaf with leading
``None``s and keeps FSDP off the stacked dims, so the spec of a port leaf
is JAX's spec of its stacked leaf with the stacked dims dropped.

``constrain(x, spec)`` is JAX's sharding constraint on the installed
mesh: it checks the spec against the mesh and returns ``x`` itself (a
rank's tensors are already its own).  ``make_shardings`` pairs each spec
with the mesh, one ``(mesh, spec)`` record a leaf, as JAX's
``NamedSharding``s.

The execution half.  JAX's 'model' axis is a GSPMD auto axis: XLA places
each leaf by ``param_pspecs`` and inserts the collectives.  The port runs
it on ranks (``launch/mesh.py``'s ``Mesh2D.model``, installed by
``install_2d``; ``model_axis()`` returns it): a rank holds the block of
each leaf its spec gives it (``local_slice``; ``gather_leaf`` is the
inverse), and the layers call Megatron's collectives where GSPMD would
place them:

- ``tp_copy`` (f): identity forward, all-reduce backward, where a
  replicated input enters sharded work;
- ``tp_reduce`` (g): all-reduce forward, identity backward, after a
  row-parallel product or a vocab-parallel lookup;
- ``tp_gather``: all-gather forward, this rank's block of the gradient
  backward, where a full value is needed (the logits);
- ``tp_allsum``: all-reduce forward and backward (f after g), a sum whose
  replicated result each rank uses in its own way (the gated norm's mean
  of squares over every SSD head).

The residual stream stays replicated over the model ranks; JAX's
sequence-parallel ``constrain_res`` is a layout of the same function.
Each is the identity where no model axis is installed.

A replicated leaf (its spec names no 'model' dim) is used whole on every
rank, or in part: ``split_use`` leaves are read inside a module's sharded
work (SSD's ``wB``, ``wC``, ``A_log``, ``dt_bias``, ``conv_w`` and
``norm_scale``; ``wk`` / ``wv`` where the KV heads do not divide), so each
rank's gradient of one is partial and is summed over the axis before the
update.  ``model_split`` derives the list from the rules and the modules
(a module whose own leaves include a sharded one runs split, and every
replicated leaf of it is split-use but the ones it names in
``TP_REPLICATED_USE``: the moe router, the value head), never by hand.
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Any, Optional, Sequence

import torch

_GLOBAL_MESH = None
_DP_AXES: tuple = ("data",)
_TP_AXIS: str = "model"


class PartitionSpec(tuple):
    """One entry a tensor dim: ``None`` (replicated), a mesh-axis name, or
    a tuple of names (the dim split over their product); a tuple of one
    name is that name, as in JAX's."""

    def __new__(cls, *axes):
        return super().__new__(cls, tuple(
            a[0] if isinstance(a, tuple) and len(a) == 1 else a
            for a in axes))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def set_global_mesh(mesh, dp_axes=("data",), tp_axis="model"):
    """``mesh``: anything with ``.shape[axis]`` and ``.axis_names``
    (``launch.mesh.AbstractMesh``, a ``DataMesh``), or None."""
    global _GLOBAL_MESH, _DP_AXES, _TP_AXIS
    _GLOBAL_MESH = mesh
    _DP_AXES = tuple(dp_axes)
    _TP_AXIS = tp_axis


def get_global_mesh():
    return _GLOBAL_MESH


def dp_axes() -> tuple:
    return _DP_AXES


def tp_axis() -> str:
    return _TP_AXIS


def tp_size() -> int:
    if _GLOBAL_MESH is None:
        return 1
    return _GLOBAL_MESH.shape[_TP_AXIS]


def n_batch_shards() -> int:
    if _GLOBAL_MESH is None:
        return 1
    n = 1
    for a in _DP_AXES:
        n *= _GLOBAL_MESH.shape[a]
    return n


def _axis_names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def constrain(x, spec: PartitionSpec):
    """JAX's ``with_sharding_constraint`` on the installed mesh; identity
    when none is installed.  On the port's meshes a rank already holds its
    slice (of the batch, and of a leaf or activation the model axis
    splits), so this returns ``x`` unchanged after checking the spec
    against the mesh: a spec longer than ``x``'s
    rank or naming an axis the mesh lacks raises ValueError.  A dim that
    its axes do not divide is allowed, as JAX pads it (``sharded_bytes``
    counts the padding)."""
    if _GLOBAL_MESH is None:
        return x
    if len(spec) > x.dim():
        raise ValueError(f"constrain: spec {spec!r} has {len(spec)} entries "
                         f"for a tensor of shape {tuple(x.shape)}")
    sizes = _GLOBAL_MESH.shape
    for entry in spec:
        for a in _axis_names(entry):
            if a not in sizes:
                raise ValueError(f"constrain: axis {a!r} of {spec!r} is not "
                                 f"on the mesh {dict(sizes)}")
    return x


class NamedSharding(tuple):
    """``(mesh, spec)``: JAX's ``NamedSharding``, a spec bound to a mesh."""

    def __new__(cls, mesh, spec: PartitionSpec):
        return super().__new__(cls, (mesh, spec))

    @property
    def mesh(self):
        return self[0]

    @property
    def spec(self) -> PartitionSpec:
        return self[1]


def make_shardings(pspec_tree, mesh=None):
    """One ``NamedSharding(mesh, spec)`` a leaf of ``pspec_tree`` (a spec,
    or a dict / list / tuple of them; ``param_pspecs``' dict), on ``mesh``
    or the installed one; None when there is no mesh, as JAX's."""
    mesh = mesh or _GLOBAL_MESH
    if mesh is None:
        return None

    def walk(t):
        if isinstance(t, PartitionSpec):
            return NamedSharding(mesh, t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        raise TypeError(f"make_shardings: {type(t).__name__} is not a "
                        "PartitionSpec tree")

    return walk(pspec_tree)


def batch_spec(*trailing) -> PartitionSpec:
    """P over batch dim: batch -> all dp axes."""
    return P(_DP_AXES, *trailing)


def shard_count(spec: PartitionSpec, mesh) -> int:
    """How many pieces ``spec`` cuts a tensor into on ``mesh``."""
    n = 1
    for ax in spec:
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                n *= mesh.shape[a]
    return n


# ---------------------------------------------------------------------------
# Param partition rules.  Leaf-name conventions (see layers.py's modules):
#   tok_embed (V, D)            -> (tp, None)      vocab-sharded embedding
#   lm_head   (D, V)            -> (None, tp)
#   wq/wz/wx  (D, H, dh)        -> (None, tp, None)   [heads shardable]
#   wk/wv     (D, Hkv, dh)      -> (None, tp|None, None)
#   wo        (H, dh, D)        -> (tp, None, None)
#   wi/wg     (D, F)            -> (None, tp)
#   wd        (F, D)            -> (tp, None)
#   experts_wi/wg (E, D, F)     -> (None, None, tp)   [per-expert TP]
#   experts_wd    (E, F, D)     -> (None, tp, None)
#   wB/wC     (D, G, N)         -> replicated (G small)
#   router / norms / scalars    -> replicated
# ---------------------------------------------------------------------------
_RULES = {
    "tok_embed": ("model", None),
    "pos_embed": (None, None),
    "lm_head": (None, "model"),
    "value_head": (None, None),
    "wq": (None, "model", None),
    "wk": (None, "KV", None),
    "wv": (None, "KV", None),
    "wo": ("model", None, None),
    "wz": (None, "model", None),
    "wx": (None, "model", None),
    "wdt": (None, "model"),
    "wB": (None, None, None),
    "wC": (None, None, None),
    "out_proj": ("model", None, None),
    "wi": (None, "model"),
    "wg": (None, "model"),
    "wd": ("model", None),
    "experts_wi": (None, None, "model"),
    "experts_wg": (None, None, "model"),
    "experts_wd": (None, "model", None),
    "router": (None, None),
}


_HEAD_GATED = {"wq", "wo", "wz", "wx", "wdt", "out_proj"}


def _rule_for(name: str, shape, n_heads_divisible: bool, kv_divisible: bool):
    base = _RULES.get(name)
    if base is None:
        return (None,) * len(shape)  # norms, biases, A_log, conv, scalars
    spec = []
    for ax in base:
        if ax == "KV":
            spec.append("model" if kv_divisible else None)
        elif ax == "model" and name in _HEAD_GATED:
            spec.append("model" if n_heads_divisible else None)
        else:
            spec.append(ax)
    return tuple(spec)


def _leaf_rule(name: str, shape, cfg, tp: int) -> list:
    """The model-axis rule of one leaf (its last name component ``name``)
    of ``shape`` on a model axis of ``tp``, as a list of entries: JAX's
    ``spec_leaf`` before FSDP."""
    heads_ok = cfg.n_heads % tp == 0
    kv_ok = cfg.n_kv_heads % tp == 0
    ok = heads_ok
    if name in ("wz", "wx", "wdt", "out_proj") and cfg.d_state:
        ok = cfg.ssm_n_heads % tp == 0
    rank = len(shape)
    rule = list(_rule_for(name, shape, ok, kv_ok))
    if len(rule) < rank:  # stacked dim(s) in front, as JAX's leaves
        rule = [None] * (rank - len(rule)) + rule
    rule = rule[:rank]
    # drop sharding on dims that don't divide
    for i, (dim, ax) in enumerate(zip(shape, rule)):
        if ax is not None and (tp <= 1 or dim % tp != 0):
            rule[i] = None
    return rule


def leaf_spec(name: str, shape, cfg, tp: Optional[int] = None
              ) -> PartitionSpec:
    """The spec of one leaf (``name`` a ``named_parameters()`` name or its
    last component) on a model axis of ``tp`` (default: the installed
    mesh's): ``param_pspecs``' spec without FSDP."""
    return P(*_leaf_rule(name.rsplit(".", 1)[-1], tuple(shape), cfg,
                         tp or tp_size()))


def param_pspecs(params, cfg, tp: Optional[int] = None,
                 fsdp_axes: Optional[Sequence[str]] = None) -> dict:
    """``{name: PartitionSpec}`` for ``params`` (an ``nn.Module``, or
    ``(name, tensor)`` pairs named as ``named_parameters()``), from each
    leaf's last name component and its GLOBAL shape (a rank's own block
    of a leaf the model axis splits is mapped back to it).

    ``fsdp_axes``: additionally shard each *named weight* leaf over these
    mesh axes on its largest still-unsharded dim (ZeRO-3/FSDP), so resident
    param bytes drop by the fsdp factor.  Small unnamed leaves (norm
    scales, biases) stay replicated."""
    tp = tp or tp_size()
    mesh = _GLOBAL_MESH
    fsdp_size = 1
    if fsdp_axes and mesh is not None:
        for a in fsdp_axes:
            fsdp_size *= mesh.shape[a]
    named_params = params.named_parameters() \
        if hasattr(params, "named_parameters") else params
    split = {}
    if hasattr(params, "named_modules"):
        for mname, mod in params.named_modules():
            for n in getattr(mod, "tp_global", {}):
                split[f"{mname}.{n}" if mname else n] = mod.tp_global[n]

    def spec_leaf(path, shape):
        shape = split.get(path, shape)
        name = path.rsplit(".", 1)[-1]
        rule = _leaf_rule(name, shape, cfg, tp)
        n_pad = max(len(shape) - len(_RULES.get(name, shape)), 0)
        # FSDP: largest unsharded non-stacked dim of named weights
        if name in _RULES and fsdp_axes and fsdp_size > 1:
            cands = [i for i in range(n_pad, len(shape))
                     if rule[i] is None and shape[i] % fsdp_size == 0]
            if cands:
                i = max(cands, key=lambda j: shape[j])
                rule[i] = tuple(fsdp_axes) if len(fsdp_axes) > 1 \
                    else fsdp_axes[0]
        return P(*rule)

    return {name: spec_leaf(name, tuple(t.shape)) for name, t in named_params}


# ---------------------------------------------------------------------------
# The execution half on a 'model' axis of ranks (see the module docstring)
# ---------------------------------------------------------------------------
def model_axis():
    """The installed mesh's 'model' axis where it runs on ranks (a
    ``launch.mesh.Mesh2D``'s ``model``, a ``DataMesh`` of more than one
    rank, or a dry run's ``RecordingMesh``), else None: no mesh, an
    ``AbstractMesh``, a model extent of 1."""
    m = getattr(_GLOBAL_MESH, "model", None)
    return m if m is not None and m.size > 1 else None


def model_dims(spec: PartitionSpec) -> list:
    """The dims ``spec`` splits over the tp axis."""
    return [i for i, e in enumerate(spec) if _TP_AXIS in _axis_names(e)]


def _block(x, dim: int, index: int, n: int, what: str):
    if x.shape[dim] % n:
        raise ValueError(f"{what}: dim {dim} of {tuple(x.shape)} does not "
                         f"split over {n} model ranks")
    k = x.shape[dim] // n
    idx = [slice(None)] * len(x.shape)
    idx[dim] = slice(index * k, (index + 1) * k)
    return x[tuple(idx)]


def local_slice(name: str, full, spec: PartitionSpec, mesh):
    """This rank's block of the global leaf ``full`` (a tensor or a numpy
    array) named ``name`` under ``spec``: every dim the spec splits over
    the model axis cut evenly, block ``mesh.index`` of ``mesh.size``.  A
    contiguous copy, so the whole leaf can be freed."""
    for d in model_dims(spec):
        full = _block(full, d, mesh.index, mesh.size, name)
    if isinstance(full, torch.Tensor):
        return full.clone(memory_format=torch.contiguous_format)
    import numpy as np
    return np.ascontiguousarray(full)


def gather_leaf(name: str, local: torch.Tensor, spec: PartitionSpec, mesh
                ) -> torch.Tensor:
    """The inverse of ``local_slice``: the global leaf, every model rank's
    block gathered in axis order (every rank of ``mesh`` calls this).
    ``name`` is for the reader; a replicated leaf comes back as it is."""
    del name
    for d in model_dims(spec):
        local = mesh.all_gather(local.contiguous(), dim=d)
    return local


class LeafSlicer:
    """How ``init_lm`` and ``params_from_jax`` build a rank's leaves on a
    model axis: the spec of a leaf from its name and global shape
    (``leaf_spec``), its local shape, and the rank's block of a global
    value."""

    def __init__(self, cfg, mesh):
        self.cfg, self.mesh = cfg, mesh

    def spec(self, name: str, shape) -> PartitionSpec:
        return leaf_spec(name, shape, self.cfg, self.mesh.size)

    def local_shape(self, name: str, shape) -> tuple:
        out = list(shape)
        for d in model_dims(self.spec(name, shape)):
            out[d] //= self.mesh.size
        return tuple(out)

    def slice(self, name: str, full):
        return local_slice(name, full, self.spec(name, tuple(full.shape)),
                           self.mesh)


_SLICERS: list = []   # the active ``slicing`` blocks, innermost last


@contextmanager
def slicing(cfg, mesh=None):
    """Inside the block the layer modules are built as this rank's blocks
    (``LeafSlicer(cfg, mesh)``; ``mesh`` defaults to ``model_axis()``; no
    axis: whole leaves, as outside)."""
    mesh = mesh if mesh is not None else model_axis()
    _SLICERS.append(None if mesh is None or mesh.size == 1
                    else LeafSlicer(cfg, mesh))
    try:
        yield _SLICERS[-1]
    finally:
        _SLICERS.pop()


def current_slicer() -> Optional[LeafSlicer]:
    return _SLICERS[-1] if _SLICERS else None


class _Copy(torch.autograd.Function):
    """f: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g), None


class _Reduce(torch.autograd.Function):
    """g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.psum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllSum(torch.autograd.Function):
    """f after g: all-reduce forward and backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.psum(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g), None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward, this rank's block backward."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.all_gather(x.contiguous(), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.block(g, dim=ctx.dim).contiguous(), None, None


def tp_copy(x):
    """f (see the module docstring); identity without a model axis."""
    m = model_axis()
    return x if m is None else _Copy.apply(x, m)


def tp_reduce(x):
    """g: the sum over the model ranks of their partial ``x``."""
    m = model_axis()
    return x if m is None else _Reduce.apply(x, m)


def tp_allsum(x):
    """The sum over the model ranks, in forward and backward."""
    m = model_axis()
    return x if m is None else _AllSum.apply(x, m)


def tp_gather(x, dim: int = -1):
    """Every model rank's block of ``x`` concatenated along ``dim``."""
    m = model_axis()
    if m is None:
        return x
    return _Gather.apply(x, m, dim % x.dim())


@dataclasses.dataclass(frozen=True)
class ModelSplit:
    """An LM's leaves on the model axis ``mesh``, in ``named_parameters()``
    order: ``sharded[i]``, the rank holds a block of leaf i;
    ``split_use[i]``, leaf i is replicated and each rank uses a part of it
    (its gradient is partial: ``sum_split_`` sums it over the axis).  The
    optimizer's global norm reads ``sharded`` (``train/optim.py``)."""
    mesh: Any
    names: tuple
    sharded: tuple
    split_use: tuple

    def sum_split_(self, grads) -> list:
        """``grads`` with every split-use leaf's gradient summed over the
        model axis (one all-reduce)."""
        grads = list(grads)
        idx = [i for i, s in enumerate(self.split_use) if s]
        if idx:
            for i, g in zip(idx, self.mesh.psum_all([grads[i] for i in idx])):
                grads[i] = g
        return grads


def model_split(params, cfg, mesh=None) -> Optional[ModelSplit]:
    """The ``ModelSplit`` of ``params`` (an ``LM`` built on the model axis
    ``mesh``, default ``model_axis()``); None without a model axis.  A
    module runs split when one of its own leaves is sharded; its other
    leaves are then split-use, but those it lists in
    ``TP_REPLICATED_USE`` (read before its sharded work)."""
    mesh = mesh if mesh is not None else model_axis()
    if mesh is None:
        return None
    specs = param_pspecs(params, cfg, tp=mesh.size)
    flags = {}
    for mname, mod in params.named_modules():
        own = [(f"{mname}.{n}" if mname else n, n)
               for n, p in mod._parameters.items() if p is not None]
        runs_split = any(model_dims(specs[full]) for full, _ in own)
        keep = getattr(mod, "TP_REPLICATED_USE", ())
        for full, n in own:
            sharded = bool(model_dims(specs[full]))
            flags[full] = (sharded, runs_split and not sharded
                           and n not in keep)
    names = tuple(n for n, _ in params.named_parameters())
    return ModelSplit(mesh, names, tuple(flags[n][0] for n in names),
                      tuple(flags[n][1] for n in names))
