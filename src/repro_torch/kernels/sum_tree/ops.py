"""Blocked-priority state and the public wrappers around the sum-tree
kernel, port of ``repro/kernels/sum_tree/ops.py``.

Two API surfaces:

- ``BlockedPriorities`` / ``set_priorities`` / ``sample_proportional`` — the
  standalone blocked layout (kernel tests and benches).
- ``tree_update_blocked`` / ``tree_sample_blocked`` — the same math operating
  directly on ``replay/device.py``'s ``(2*size,)`` binary sum tree.  Key
  layout fact: for ``n_blocks = size // block_size`` (both powers of two),
  the tree's internal level at indices ``[n_blocks, 2*n_blocks)`` IS the
  per-block sums — no second data structure; the replay state is read in
  place, and either backend can consume a tree the other produced.

The samplers launch the CUDA kernel (``csrc/sum_tree.cu``) for CUDA tensors,
count each launch in their ``launches`` attribute, and raise on what the
kernel does not take — there is no fallback on the card.  For CPU tensors
they compute the kernel's plain version (``sum_tree.sample_plain``).
``tree_update_blocked`` is plain PyTorch ops on every device, as the JAX
function is jnp, not Pallas.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .sum_tree import sample_blocked, sample_plain

F32 = torch.float32


def _sample(leaves, block_sums, u):
    """(idx, prob, launched): the kernel for CUDA tensors, the plain version
    for CPU ones."""
    tensors = (leaves, block_sums, u)
    if all(t.device.type == "cpu" for t in tensors):
        return (*sample_plain(leaves, block_sums, u), False)
    if all(t.is_cuda for t in tensors):
        return (*sample_blocked(leaves, block_sums, u), True)
    raise ValueError(f"sum_tree: tensors must all be on the CPU or all on "
                     f"CUDA, got {[str(t.device) for t in tensors]}")


class BlockedPriorities(NamedTuple):
    leaves: torch.Tensor      # (n_blocks, block_size)
    block_sums: torch.Tensor  # (n_blocks,)


def init_priorities(capacity: int, block_size: int = 512, *,
                    device="cpu") -> BlockedPriorities:
    n_blocks = -(-capacity // block_size)
    return BlockedPriorities(
        leaves=torch.zeros((n_blocks, block_size), dtype=F32, device=device),
        block_sums=torch.zeros((n_blocks,), dtype=F32, device=device))


def set_priorities(state: BlockedPriorities, idx, priorities) -> BlockedPriorities:
    flat = state.leaves.reshape(-1).clone()
    flat[idx.long()] = priorities.to(F32)
    leaves = flat.reshape(state.leaves.shape)
    return BlockedPriorities(leaves=leaves, block_sums=torch.sum(leaves, dim=1))


def total(state: BlockedPriorities):
    return torch.sum(state.block_sums)


def sample_proportional(state: BlockedPriorities, generator, batch: int):
    """Stratified proportional sampling; returns (idx, prob)."""
    dev = state.leaves.device
    u01 = torch.rand((batch,), generator=generator, device=dev, dtype=F32)
    u = (torch.arange(batch, device=dev) + u01) / batch * total(state)
    idx, prob, launched = _sample(state.leaves, state.block_sums, u)
    sample_proportional.launches += launched
    return idx, prob


sample_proportional.launches = 0


# ---------------------------------------------------------------------------
# replay/device.py (2*size,) sum-tree layout
# ---------------------------------------------------------------------------

def tree_update_blocked(tree: torch.Tensor, idx, priorities) -> torch.Tensor:
    """Blocked equivalent of the pointer-walk ``tree_set``, IN PLACE: scatter
    the leaves, then rebuild every internal level bottom-up with vectorized
    pairwise sums (log2(size) adds, no dynamic ancestor indexing).  Each
    parent is the same ``left + right`` the walk computes.  Repeated indices
    in ``idx`` write one of their values (``index_put_`` is unordered on
    CUDA); the replay's are the same transition with the same priority."""
    size = tree.shape[0] // 2
    tree[size + idx.long()] = priorities.to(tree.dtype)
    lo = size
    while lo > 1:
        level = tree[lo:2 * lo]
        torch.add(level[0::2], level[1::2], out=tree[lo // 2:lo])
        lo //= 2
    return tree


def tree_sample_blocked(tree: torch.Tensor, u, *, block_size: int = 512):
    """Proportional sampling over a ``(2*size,)`` sum tree through the
    blocked kernel.  u: (batch,) f32 in [0, total).  Returns (leaf_idx i32,
    prob)."""
    size = tree.shape[0] // 2
    bs = min(block_size, size)
    n_blocks = size // bs
    leaves = tree[size:].view(n_blocks, bs)
    bsums = tree[n_blocks:2 * n_blocks]
    idx, prob, launched = _sample(leaves, bsums, u.to(F32).contiguous())
    tree_sample_blocked.launches += launched
    return idx, prob


tree_sample_blocked.launches = 0
