"""Device-resident replay, port of ``repro/replay/device.py``.

Buffer state is a ``ReplayState`` of tensors on the device: storage leaves
(capacity, ...), a (2*size,) sum tree, and the ring's ``cursor`` and
``filled`` as 0-d int32 tensors, as JAX's.  The host never reads them, so an
insert or a sample captured in a CUDA graph stays right on every replay.
Unlike the
JAX functions, ``insert``, ``tree_set`` and ``update_priorities`` write the
storage and the tree IN PLACE and return the state: at rlpyt's Atari scale
(2^20 slots) a copy per insert would move the whole buffer.

Prioritized sampling dispatches through the kernel registry's ``sum_tree``
op, as in JAX: ``ref`` runs the pointer-walk ``tree_set`` and the
fixed-depth descent; ``cuda`` runs the blocked update (plain PyTorch ops)
and the blocked sampling kernel (``kernels/sum_tree``).  ``auto`` resolves
to ``cuda`` for a tree on the card and to ``ref`` on the CPU.

Randomness comes from a ``torch.Generator``; ``tree_sample`` and ``sample``
also take the draws themselves (``u01``, ``draws``) so a test can hand both
frameworks the same numbers.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils import _pytree as pytree

from ..kernels import registry as kernel_registry
from ..kernels.sum_tree import ops as sum_tree_ops

F32 = torch.float32


class ReplayState(NamedTuple):
    storage: Any          # leaves (N, ...) flat slot-major
    cursor: torch.Tensor  # 0-d int32 next write slot
    filled: torch.Tensor  # 0-d int32 number of valid slots
    tree: torch.Tensor    # (2*size,) sum tree (tree[1] is the root)


def _tree_size(capacity: int) -> int:
    size = 1
    while size < capacity:
        size *= 2
    return size


def _capacity(state: ReplayState) -> int:
    return pytree.tree_leaves(state.storage)[0].shape[0]


def init_replay(example, capacity: int, *, device="cpu") -> ReplayState:
    """example: transition pytree with leaves shaped (...,) (no batch dim)."""
    storage = pytree.tree_map(
        lambda x: torch.zeros((capacity,) + tuple(torch.as_tensor(x).shape),
                              dtype=torch.as_tensor(x).dtype, device=device),
        example)
    size = _tree_size(capacity)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return ReplayState(storage=storage, cursor=zero, filled=zero.clone(),
                       tree=torch.zeros((2 * size,), dtype=F32, device=device))


def insert(state: ReplayState, batch, priorities=None) -> ReplayState:
    """batch leaves: (B, ...); priorities (B,) or None (max-priority init:
    max(largest leaf, 1))."""
    B = pytree.tree_leaves(batch)[0].shape[0]
    cap = _capacity(state)
    idx = (state.cursor + torch.arange(B, device=state.tree.device)) % cap
    pytree.tree_map(lambda s, b: s.index_copy_(0, idx, b.to(s.dtype)),
                    state.storage, batch)
    if priorities is None:
        cur_max = torch.clamp(torch.amax(state.tree[_tree_size(cap):]), min=1.0)
        priorities = cur_max.expand(B)
    tree = tree_set(state.tree, idx, priorities)
    return ReplayState(storage=state.storage, cursor=(state.cursor + B) % cap,
                       filled=torch.clamp(state.filled + B, max=cap),
                       tree=tree)


# ---------------------------------------------------------------------------
# the sum tree (reference semantics for kernels/sum_tree)
# ---------------------------------------------------------------------------

def tree_set(tree: torch.Tensor, idx, priorities) -> torch.Tensor:
    """Leaf update + upward propagation (fixed depth), IN PLACE.

    Under the ``cuda`` backend the blocked update scatters the leaves and
    rebuilds all levels bottom-up with vectorized pairwise sums — the same
    values (each parent is left + right either way)."""
    if kernel_registry.backend_for("sum_tree", site="replay.tree_set",
                                   device=tree.device) != "ref":
        return sum_tree_ops.tree_update_blocked(tree, idx, priorities)
    size = tree.shape[0] // 2
    node = idx.long() + size
    tree[node] = priorities.to(tree.dtype)
    for _ in range(size.bit_length() - 1):
        parent = node // 2
        tree[parent] = tree[2 * parent] + tree[2 * parent + 1]
        node = parent
    return tree


def tree_sample(tree: torch.Tensor, generator, batch: int, *, u01=None):
    """Stratified proportional sampling; returns (idx, prob).

    Position k of the batch is u = (k + u01[k]) / batch * root, with u01
    drawn from ``generator`` unless given.  Under the ``cuda`` backend the
    blocked kernel reads the tree's ``[n_blocks, 2*n_blocks)`` level as the
    per-block sums and resolves every sample in one launch, instead of the
    O(log n) pointer-chasing descent.  Both pick the smallest leaf with
    cumsum > u, so zero-priority runs and boundary ties agree."""
    dev = tree.device
    if u01 is None:
        u01 = torch.rand((batch,), generator=generator, device=dev, dtype=F32)
    total = tree[1]
    u = (torch.arange(batch, device=dev) + u01) / batch * total
    if kernel_registry.backend_for("sum_tree", site="replay.tree_sample",
                                   device=dev) != "ref":
        return sum_tree_ops.tree_sample_blocked(tree, u)
    size = tree.shape[0] // 2
    node = torch.ones((batch,), dtype=torch.long, device=dev)
    for _ in range(size.bit_length() - 1):
        left = 2 * node
        lval = tree[left]
        go_right = u >= lval
        u = torch.where(go_right, u - lval, u)
        node = torch.where(go_right, left + 1, left)
    prob = tree[node] / torch.clamp(total, min=1e-9)
    return (node - size).to(torch.int32), prob


def sample(state: ReplayState, generator, batch: int, *, uniform: bool = False,
           beta: float = 0.4, draws=None):
    """Returns (batch_tree, idx, is_weights).

    ``draws`` replaces the random numbers: for the uniform path the ages
    (batch,) in [0, filled), for the prioritized path the u01 of
    ``tree_sample``.  The uniform ages are 62-bit draws modulo ``filled``,
    which stays on the device (a bias below 2^-31)."""
    cap = _capacity(state)
    dev = state.tree.device
    n = torch.clamp(state.filled, min=1)
    if uniform:
        ages = draws if draws is not None else torch.randint(
            0, 1 << 62, (batch,), generator=generator, device=dev) % n
        # map ages onto the ring (newest-first not required for uniform)
        idx = (state.cursor - 1 - ages.long()) % cap
        w = torch.ones((batch,), dtype=F32, device=dev)
    else:
        idx, prob = tree_sample(state.tree, generator, batch, u01=draws)
        w = (n.to(F32) * torch.clamp(prob, min=1e-12)) ** (-beta)
        w = w / torch.clamp(torch.amax(w), min=1e-12)
    out = pytree.tree_map(lambda s: s[idx.long()], state.storage)
    return out, idx, w


def update_priorities(state: ReplayState, idx, td_errors, *, alpha=0.6,
                      eps=1e-6) -> ReplayState:
    pr = (torch.abs(td_errors) + eps) ** alpha
    return state._replace(tree=tree_set(state.tree, idx, pr))
