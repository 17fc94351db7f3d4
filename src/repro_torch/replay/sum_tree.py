"""Sum tree for proportional prioritized replay (paper cites Schaul et al.),
a copy of ``repro/replay/sum_tree.py``.

Array-backed complete binary tree: leaves hold priorities, internal nodes
hold subtree sums.  Stratified sampling descends from the root — O(log n) per
sample, vectorized over the batch.  This numpy version backs the host replay
(``replay/host.py``) and stays numpy on the host, so that for the same
``np.random.Generator`` it gives the JAX package's indices and probabilities
bit for bit; ``kernels/sum_tree`` samples the device replay on the card.
"""
from __future__ import annotations

import numpy as np


class SumTree:
    def __init__(self, capacity: int):
        # round up to power of two for a fixed-depth descent
        depth = max(int(np.ceil(np.log2(max(capacity, 2)))), 1)
        self.capacity = capacity
        self.size = 1 << depth
        self.depth = depth
        self.tree = np.zeros(2 * self.size, np.float64)

    @property
    def total(self) -> float:
        return float(self.tree[1])

    def set(self, idx, priority):
        """Set leaves idx (int array) to priority (float array)."""
        idx = np.atleast_1d(np.asarray(idx, np.int64))
        if idx.size == 0:
            return
        priority = np.broadcast_to(np.asarray(priority, np.float64), idx.shape)
        # dedupe (keep last write wins) so propagation is consistent
        uniq, last = np.unique(idx[::-1], return_index=True)
        pr = priority[::-1][last]
        node = uniq + self.size
        self.tree[node] = pr
        node = node // 2
        while node[0] >= 1:
            left = self.tree[2 * node]
            right = self.tree[2 * node + 1]
            self.tree[node] = left + right
            node = np.unique(node // 2)
            if node[0] == 0:
                break

    def get(self, idx):
        return self.tree[np.asarray(idx, np.int64) + self.size]

    def sample(self, batch: int, rng: np.random.Generator, stratified: bool = True):
        """Sample leaf indices proportional to priority; returns (idx, prob)."""
        total = self.tree[1]
        if total <= 0:
            raise ValueError("empty sum tree")
        if stratified:
            u = (np.arange(batch) + rng.random(batch)) / batch * total
        else:
            u = rng.random(batch) * total
        node = np.ones(batch, np.int64)
        for _ in range(self.depth):
            left = 2 * node
            lval = self.tree[left]
            go_right = u >= lval
            u = np.where(go_right, u - lval, u)
            node = np.where(go_right, left + 1, left)
        leaf = node - self.size
        leaf = np.minimum(leaf, self.capacity - 1)
        prob = self.tree[node] / total
        return leaf, prob
