"""Small pytree helpers shared across the port, port of
``repro/core/tree.py`` over ``torch.utils._pytree``.

``None`` is a pytree leaf to ``torch.utils._pytree`` (JAX: an empty node),
so every helper passes ``None`` leaves through and counts them as nothing.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

F32 = torch.float32


def _map(fn, *trees):
    return pytree.tree_map(lambda x, *r: None if x is None else fn(x, *r),
                           *trees)


def _tensors(tree):
    return [x for x in pytree.tree_leaves(tree) if x is not None]


def tree_select(pred, on_true, on_false):
    """Elementwise ``torch.where`` over matching trees (pred broadcast to
    leaves)."""
    return _map(lambda a, b: torch.where(pred, a, b), on_true, on_false)


def jax_order_leaves(tree):
    """A tree's leaves in JAX's flattening order: dict keys sorted, tuples
    (named or not) and lists in order, ``None`` no leaf.  Works on any
    leaves (numpy arrays too); files that number leaves (the host replay's
    ``state_dict``) use it to match the JAX package's numbering."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in jax_order_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for sub in tree for x in jax_order_leaves(sub)]
    return [tree]


def tree_zeros_like(tree, dtype=None):
    return _map(lambda x: torch.zeros_like(x, dtype=dtype), tree)


def tree_stack(trees, axis=0):
    return _map(lambda *xs: torch.stack(xs, dim=axis), *trees)


def tree_concat(trees, axis=0):
    return _map(lambda *xs: torch.cat(xs, dim=axis), *trees)


def tree_count_params(tree) -> int:
    return int(sum(x.numel() for x in _tensors(tree)))


def tree_bytes(tree) -> int:
    return int(sum(x.numel() * x.element_size() for x in _tensors(tree)))


def tree_global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in f32 (a 0-d tensor)."""
    total = None
    for x in _tensors(tree):
        sq = torch.sum(torch.square(x.to(F32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def tree_cast(tree, dtype):
    return _map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)
