"""Leading-dimension protocol (paper §6.4), port of
``repro/core/leading_dims.py``.

The same model forward must serve three call shapes:
  []        single example   (buffer-spec construction)
  [B]       sampling batch   (batched action selection)
  [T, B]    training batch   (time-major optimization)

``infer_leading_dims`` inspects an input against its known feature rank and
returns reshape info; ``restore_leading_dims`` puts outputs back.  Works on
bare tensors and on namedarraytuple/pytree inputs (first leaf governs).
"""
from __future__ import annotations

from torch.utils import _pytree as pytree


def _map(fn, tree):
    return pytree.tree_map(lambda x: None if x is None else fn(x), tree)


def infer_leading_dims(x, feature_ndim: int):
    """Return (lead_dim, T, B, flat_x) where flat_x is reshaped to [T*B, ...].

    lead_dim in {0,1,2}: number of leading dims present on input.
    """
    leaves = [leaf for leaf in pytree.tree_leaves(x) if leaf is not None]
    shape = tuple(leaves[0].shape)
    lead_dim = len(shape) - feature_ndim
    if lead_dim not in (0, 1, 2):
        raise ValueError(f"bad leading dims: shape={shape}, feature_ndim={feature_ndim}")
    if lead_dim == 2:
        T, B = shape[0], shape[1]
    elif lead_dim == 1:
        T, B = 1, shape[0]
    else:
        T, B = 1, 1
    flat_x = _map(lambda leaf: leaf.reshape((T * B,) + tuple(leaf.shape[lead_dim:])), x)
    return lead_dim, T, B, flat_x


def restore_leading_dims(outputs, lead_dim: int, T: int = 1, B: int = 1):
    """Reshape outputs [T*B, ...] back to the caller's leading dims."""

    def restore(leaf):
        if lead_dim == 2:
            return leaf.reshape((T, B) + tuple(leaf.shape[1:]))
        if lead_dim == 1:
            return leaf  # already [B, ...]
        return leaf.squeeze(0)

    return _map(restore, outputs)
