"""Sharding rules: logical param/activation axes -> mesh axes (the rules
half of ``repro/models/sharding.py``).

Specs are derived from (leaf name, shape) by ``param_pspecs``, so init
code and sharding rules cannot drift.  Pure: nothing here places a tensor.
``PartitionSpec`` is the port's own tuple of mesh-axis names (``None``, a
name, or a tuple of names a dim), the shape of JAX's.

The port's params are per-layer modules (``LM.named_parameters()``), where
JAX stacks each superblock leaf along leading scan dims
(``models/convert.py``).  A JAX rule pads a stacked leaf with leading
``None``s and keeps FSDP off the stacked dims, so the spec of a port leaf
is JAX's spec of its stacked leaf with the stacked dims dropped.

The execution half: ``constrain(x, spec)`` is JAX's sharding constraint
on the installed mesh.  The port's meshes (``launch/mesh.py``) are data
axes of ranks, each rank holding its own slice of the batch, and a
'model' axis of extent 1, so a constraint moves nothing: it checks the
spec against the mesh and returns ``x`` itself.
``make_shardings`` pairs each spec with the mesh, one ``(mesh, spec)``
record a leaf, as JAX's ``NamedSharding``s (nothing in the port places a
tensor by them: a rank's tensors are already its own).
"""
from __future__ import annotations

from typing import Optional, Sequence

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
    slice and the 'model' extent is 1, so this returns ``x`` unchanged
    after checking the spec against the mesh: a spec longer than ``x``'s
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


def param_pspecs(params, cfg, tp: Optional[int] = None,
                 fsdp_axes: Optional[Sequence[str]] = None) -> dict:
    """``{name: PartitionSpec}`` for ``params`` (an ``nn.Module``, or
    ``(name, tensor)`` pairs named as ``named_parameters()``), from each
    leaf's last name component.

    ``fsdp_axes``: additionally shard each *named weight* leaf over these
    mesh axes on its largest still-unsharded dim (ZeRO-3/FSDP), so resident
    param bytes drop by the fsdp factor.  Small unnamed leaves (norm
    scales, biases) stay replicated."""
    tp = tp or tp_size()
    heads_ok = cfg.n_heads % tp == 0
    kv_ok = cfg.n_kv_heads % tp == 0
    ssm_ok = (cfg.ssm_n_heads % tp == 0) if cfg.d_state else True
    mesh = _GLOBAL_MESH
    fsdp_size = 1
    if fsdp_axes and mesh is not None:
        for a in fsdp_axes:
            fsdp_size *= mesh.shape[a]
    named_params = params.named_parameters() \
        if hasattr(params, "named_parameters") else params

    def spec_leaf(path, shape):
        name = path.rsplit(".", 1)[-1]
        rank = len(shape)
        ok = heads_ok
        if name in ("wz", "wx", "wdt", "out_proj") and cfg.d_state:
            ok = ssm_ok
        named = name in _RULES
        rule = list(_rule_for(name, shape, ok, kv_ok))
        n_pad = 0
        if len(rule) < rank:  # stacked dim(s) in front, as JAX's leaves
            n_pad = rank - len(rule)
            rule = [None] * n_pad + rule
        rule = rule[:rank]
        # drop sharding on dims that don't divide
        for i, (dim, ax) in enumerate(zip(shape, rule)):
            if ax is not None and (tp <= 1 or dim % tp != 0):
                rule[i] = None
        # FSDP: largest unsharded non-stacked dim of named weights
        if named and fsdp_axes and fsdp_size > 1:
            cands = [i for i in range(n_pad, rank)
                     if rule[i] is None and shape[i] % fsdp_size == 0]
            if cands:
                i = max(cands, key=lambda j: shape[j])
                rule[i] = tuple(fsdp_axes) if len(fsdp_axes) > 1 \
                    else fsdp_axes[0]
        return P(*rule)

    return {name: spec_leaf(name, tuple(t.shape)) for name, t in named_params}
