"""namedarraytuple, port of ``repro/core/narrtup.py`` (paper §4).

A namedarraytuple is a namedtuple whose indexed/sliced read & write apply to
the *leaves* (tensors or numpy arrays) rather than to the tuple fields,
recursively through nested structure, with identical syntax whether the
target is a bare array or a tree:

    dest[slice_or_indexes] = src        # in place, torch or numpy leaves
    dest = dest.at[idx].set(src)        # functional: new leaves, as in JAX

``src`` may be a matching structure, a single value broadcast to all fields,
or contain ``None`` placeholders for fields to skip.  Each generated class is
a pytree node to ``torch.utils._pytree`` (which treats every namedtuple
class as one), so namedarraytuples flow through ``tree_map`` /
``tree_flatten`` unchanged.  ``None`` is a pytree *leaf* there (JAX: an empty
node), so the helpers below skip it explicitly.

Classes are memoized in a module-level registry keyed by (typename, fields)
so dynamically-created classes pickle correctly.
"""
from __future__ import annotations

import string
from collections import namedtuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

_CLASS_REGISTRY: dict = {}


def is_namedtuple_class(obj) -> bool:
    return isinstance(obj, type) and issubclass(obj, tuple) and hasattr(obj, "_fields")


def is_namedarraytuple_class(obj) -> bool:
    return is_namedtuple_class(obj) and getattr(obj, "_is_namedarraytuple", False)


def is_namedtuple(obj) -> bool:
    return is_namedtuple_class(type(obj))


def is_namedarraytuple(obj) -> bool:
    return is_namedarraytuple_class(type(obj))


def _like(value, leaf):
    """``value`` as something ``leaf[index] = ...`` accepts."""
    if isinstance(leaf, torch.Tensor) and not isinstance(value, torch.Tensor):
        return torch.as_tensor(np.asarray(value), dtype=leaf.dtype,
                               device=leaf.device)
    return value


def _leaf_at(leaf, index, opname, src):
    """Functional ``leaf.at[index].set/add(src)`` on one tensor."""
    if is_namedarraytuple(leaf):
        return getattr(leaf.at[index], opname)(src)
    out = leaf.clone() if isinstance(leaf, torch.Tensor) else np.array(leaf)
    src = _like(src, out)
    # repeated indices accumulate under "add", as jnp's .at[].add does
    if opname == "set":
        out[index] = src
    elif isinstance(out, np.ndarray):
        np.add.at(out, index, src)
    elif isinstance(index, torch.Tensor):
        out.index_put_((index,), torch.broadcast_to(
            src, out[index].shape).to(out.dtype), accumulate=True)
    else:
        out[index] += src
    return out


class _AtIndexer:
    """Functional ``.at[idx].set(src)`` mirroring jax array semantics on trees."""

    __slots__ = ("_nat",)

    def __init__(self, nat):
        self._nat = nat

    def __getitem__(self, index):
        return _AtOps(self._nat, index)


class _AtOps:
    __slots__ = ("_nat", "_index")

    def __init__(self, nat, index):
        self._nat = nat
        self._index = index

    def _apply(self, opname, src):
        nat, index = self._nat, self._index
        if is_namedtuple(src):
            src = tuple(src)  # structural positional match
        new_fields = []
        for j, (name, leaf) in enumerate(zip(nat._fields, nat)):
            if isinstance(src, tuple):
                s = src[j]
            elif isinstance(src, dict):
                s = src.get(name)
            else:
                s = src
            if leaf is None or s is None:
                new_fields.append(leaf)
            else:
                new_fields.append(_leaf_at(leaf, index, opname, s))
        return type(nat)(*new_fields)

    def set(self, src):
        return self._apply("set", src)

    def add(self, src):
        return self._apply("add", src)


def namedarraytuple(typename: str, field_names, return_namedtuple_cls: bool = False):
    """Create (or fetch memoized) namedarraytuple class.

    ``field_names`` may be a string of space/comma separated names, a sequence
    of names, or an existing namedtuple class to mirror.
    """
    if is_namedtuple_class(field_names):
        nt_cls = field_names
        field_names = nt_cls._fields
    else:
        if isinstance(field_names, str):
            field_names = field_names.replace(",", " ").split()
        field_names = tuple(field_names)
        nt_cls = None

    key = (typename, field_names)
    if key in _CLASS_REGISTRY:
        cls = _CLASS_REGISTRY[key]
        return (cls, cls.__bases__[0]) if return_namedtuple_cls else cls

    for name in (typename,) + field_names:
        if not all(c in string.ascii_letters + string.digits + "_" for c in name):
            raise ValueError(f"invalid identifier: {name!r}")

    if nt_cls is None:
        nt_cls = namedtuple(typename + "_base", field_names)

    class _NAT(nt_cls):
        _is_namedarraytuple = True
        __slots__ = ()

        def __getitem__(self, index):
            """Index into every non-None leaf (NOT field selection)."""
            try:
                return type(self)(*(None if f is None else f[index] for f in self))
            except IndexError as e:
                for name, f in zip(self._fields, self):
                    if f is None:
                        continue
                    try:
                        _ = f[index]
                    except IndexError:
                        raise IndexError(
                            f"Occurred in {type(self).__name__} at field {name!r}"
                        ) from e
                raise

        def __setitem__(self, index, value):
            """In-place write, recursing through structure.

            ``value`` may be a matching structure or a single value for all
            fields; ``None`` fields (either side) are skipped.
            """
            if is_namedtuple(value):
                value = tuple(value)  # structural match (namedarraytuple or namedtuple)
            if isinstance(value, tuple):
                if len(value) != len(self):
                    raise ValueError(
                        f"length mismatch writing {type(self).__name__}: "
                        f"{len(value)} vs {len(self)}"
                    )
                for f, v in zip(self, value):
                    if f is None or v is None:
                        continue
                    f[index] = v if is_namedarraytuple(f) else _like(v, f)
            else:
                for f in self:
                    if f is None or value is None:
                        continue
                    f[index] = value if is_namedarraytuple(f) else _like(value, f)

        @property
        def at(self):
            return _AtIndexer(self)

        def __contains__(self, key):
            return key in self._fields

        def get(self, name, default=None):
            return getattr(self, name, default)

        def items(self):
            return zip(self._fields, self)

    _NAT.__name__ = typename
    _NAT.__qualname__ = typename
    _CLASS_REGISTRY[key] = _NAT
    return (_NAT, nt_cls) if return_namedtuple_cls else _NAT


# ---------------------------------------------------------------------------
# buffer helpers (rlpyt rlpyt/utils/buffer.py equivalents)
# ---------------------------------------------------------------------------

def buffer_from_example(example, leading_dims=(), *, use_numpy=True,
                        dtype=None, device="cpu"):
    """Allocate a zeroed buffer tree shaped like ``example`` with extra
    leading dims: numpy leaves, or torch tensors on ``device`` when
    ``use_numpy`` is False."""
    if isinstance(leading_dims, int):
        leading_dims = (leading_dims,)

    def alloc(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        x = np.asarray(x)
        dt = np.dtype(dtype) if dtype is not None else x.dtype
        shape = tuple(leading_dims) + x.shape
        if use_numpy:
            return np.zeros(shape, dt)
        return torch.zeros(shape, dtype=torch.from_numpy(
            np.zeros((), dt)).dtype, device=device)

    return pytree.tree_map(alloc, example)


def get_leading_dims(tree, n_dims: int = 1):
    """Shared leading dims across all leaves (raises on mismatch)."""
    leaves = [x for x in pytree.tree_leaves(tree) if x is not None]
    if not leaves:
        return ()
    lead = tuple(leaves[0].shape[:n_dims])
    for leaf in leaves[1:]:
        if tuple(leaf.shape[:n_dims]) != lead:
            raise ValueError(
                f"mismatched leading dims: {tuple(leaf.shape[:n_dims])} vs {lead}"
            )
    return lead


def buffer_method(tree, method_name: str, *args, **kwargs):
    """Call a method on every leaf (e.g. 'clone', 'to', 'astype')."""
    return pytree.tree_map(
        lambda x: None if x is None else getattr(x, method_name)(*args, **kwargs),
        tree)
