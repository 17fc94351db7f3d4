"""Flat oracle for blocked proportional sampling, port of
``repro/kernels/sum_tree/ref.py``, and the rule that holds a sampler to it.

Given priorities p (flat, length n) and positions u in [0, sum(p)), return
for each u the smallest index i with cumsum(p)[i] > u, clamped to n - 1 —
the semantics of a sum-tree descent (``replay/device.py``) and of the
two-level kernel (``sum_tree.py``).  In f64 when p is f64.
"""
from __future__ import annotations

import torch


def sample_reference(priorities, u):
    dt = torch.float64 if priorities.dtype == torch.float64 else torch.float32
    cum = torch.cumsum(priorities.to(dt), 0)
    idx = torch.sum(cum[None, :] <= u.to(dt)[:, None], dim=1)
    idx = torch.clamp(idx, max=priorities.shape[0] - 1)
    total = cum[-1]
    prob = priorities.to(dt)[idx] / torch.clamp(total, min=1e-12)
    return idx.to(torch.int32), prob


def rounding_terms(n_blocks: int, block_size: int) -> int:
    """f32 additions between the leaves and a boundary the two-level sampler
    compares u with, counted generously: the block sums' own sums (at most
    ``block_size`` each), the scan of ``n_blocks`` block sums, the residual
    ``u - base`` and the scan of one row of ``block_size`` leaves."""
    return n_blocks + 2 * block_size + 1


def agreement(idx, prob, priorities, u, *, n_terms: int, exact: bool):
    """Hold a sampler's (idx, prob) for positions u against the f64 oracle
    over the flat f32 ``priorities``.

    - ``exact``: every index must be the oracle's (integer priorities with a
      total below 2^24, where every f32 partial sum is exact in any order).
    - otherwise, the rounding rule: an index that differs from the oracle's
      is allowed only where u lies within delta = n_terms * 2^-24 * total of
      every f64 boundary between the two leaves.
    - prob against p[idx] / total in f64 (p of the sampler's own idx), within
      a relative (n_terms + 1) * 2^-24: the f32 total is a sum of the same
      leaves, then one division.

    Returns a dict: n, mismatches, violations (of the index rule),
    out_of_range, prob_rel_err (largest |prob - ref| / (bound * ref)), delta.
    """
    p64 = priorities.detach().to(torch.float64).cpu()
    c64 = torch.cumsum(p64, 0)
    total = float(c64[-1])
    u64 = u.detach().to(torch.float64).cpu()
    got = idx.detach().to(torch.int64).cpu()
    n = p64.shape[0]
    # the oracle's count #{c <= u} on the monotone f64 prefix sums
    want = torch.searchsorted(c64, u64, right=True).clamp(max=n - 1)
    out_of_range = int(((got < 0) | (got >= n)).sum())
    got_c = got.clamp(0, n - 1)
    diff = got_c != want
    delta = n_terms * 2.0 ** -24 * total
    lo = torch.minimum(got_c, want)
    hi = torch.maximum(got_c, want) - 1
    near = ((u64 - c64[lo]).abs() <= delta) & ((u64 - c64[hi.clamp(min=0)])
                                               .abs() <= delta)
    violations = int((diff & ~near).sum()) if not exact else int(diff.sum())
    bound = (n_terms + 1) * 2.0 ** -24
    ref = p64[got_c] / max(total, 1e-12)
    rel = (prob.detach().to(torch.float64).cpu() - ref).abs() / (
        bound * ref + 1e-300)
    return {"n": int(got.shape[0]), "mismatches": int(diff.sum()),
            "violations": violations + out_of_range,
            "out_of_range": out_of_range,
            "prob_rel_err": float(rel.max()) if rel.numel() else 0.0,
            "delta": delta}


def agreement_ok(stats) -> bool:
    return stats["violations"] == 0 and stats["prob_rel_err"] <= 1.0
