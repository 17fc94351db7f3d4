"""The one traffic generator: a queue of requests from a mix's parameters
and a seed.

A mix file (``traffic/<name>.json``) gives lengths as distributions,
``{"dist": "uniform" | "log_uniform", "lo": a, "hi": b}``, and the queue's
depth as ``slots`` plus ``queue_per_s`` requests a second of window: more
than the window can serve, so the queue never drains while it is open.
Request ``i`` takes the sizes at the quantiles of the R2 sequence
(frac(1/2 + i a1), frac(1/2 + i a2), a1 and a2 the inverse powers of the
plastic number): every prefix of the queue spreads evenly over both
distributions, and every seed gets the same sizes in the same order.  The
seed draws only the prompt tokens, so seeds change which tokens are
served, not how much work a window holds.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

# the R2 sequence's steps: 1 / rho and 1 / rho^2, rho the plastic number
R2_STEPS = (0.7548776662466927, 0.5698402909980532)


@dataclasses.dataclass
class Spec:
    """One request as the benchmark made it."""
    rid: int
    prompt: np.ndarray        # (prompt_len,) int32
    max_tokens: int


def size_at(dist: dict, q: float) -> int:
    """The size at quantile ``q`` of ``dist``, as an integer."""
    lo, hi = float(dist["lo"]), float(dist["hi"])
    if dist["dist"] == "uniform":
        v = lo + q * (hi - lo)
    elif dist["dist"] == "log_uniform":
        v = math.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
    else:
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    return int(round(v))


def n_requests(mix: dict, seconds: float) -> int:
    return mix["slots"] + int(math.ceil(mix["queue_per_s"] * seconds))


def sizes(mix: dict, n: int):
    """[(prompt_len, max_tokens)] of the queue's first ``n`` requests."""
    a_out, a_prompt = R2_STEPS
    return [(size_at(mix["prompt_len"], (0.5 + i * a_prompt) % 1.0),
             size_at(mix["output_len"], (0.5 + i * a_out) % 1.0))
            for i in range(n)]


def make_requests(mix: dict, seconds: float, seed: int,
                  vocab: int) -> List[Spec]:
    rng = np.random.Generator(np.random.PCG64(int(seed)))
    reqs = []
    for rid, (plen, olen) in enumerate(sizes(mix, n_requests(mix, seconds))):
        prompt = rng.integers(0, vocab, size=plen, dtype=np.int32)
        reqs.append(Spec(rid=rid, prompt=prompt, max_tokens=olen))
    return reqs
