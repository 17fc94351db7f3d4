"""Serving workload: requests and Poisson arrival traces.

The paper's throughput claim (§2.3, and TorchBeast's dynamic-batching
inference server) is about *mixed* traffic: requests with different prompt
and generation lengths arriving asynchronously.  A trace here is a list of
:class:`Request` with exponential inter-arrival gaps (Poisson process),
prompt lengths and generation budgets drawn uniformly from ranges — the
mix that makes lockstep fixed-batch decoding waste FLOPs on retired slots.

Traces are plain host data (numpy), deterministic per seed, so the static
and continuous modes of ``serving/engine.py`` replay the *same* trace.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Request:
    """One decode request plus its measured lifecycle timestamps (seconds,
    relative to the engine's clock start)."""

    rid: int
    prompt: np.ndarray            # (prompt_len,) int32 token ids
    max_tokens: int               # generation budget (retire at this count)
    arrival_s: float = 0.0

    # filled in by the engine
    t_admitted: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finished: Optional[float] = None
    n_generated: int = 0
    tokens: Optional[np.ndarray] = None  # generated ids (n_generated,)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_finished is None:
            return None
        return self.t_finished - self.arrival_s

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival_s


def poisson_trace(
    seed: int,
    n_requests: int,
    rate: float,
    *,
    prompt_len_range: Tuple[int, int],
    max_tokens_range: Tuple[int, int],
    vocab: int,
) -> List[Request]:
    """Poisson arrivals at ``rate`` req/s; prompt lengths and generation
    budgets uniform over inclusive ranges.  Deterministic per seed."""
    rs = np.random.RandomState(seed)
    gaps = rs.exponential(1.0 / max(rate, 1e-9), size=n_requests)
    arrivals = np.cumsum(gaps)
    plo, phi = prompt_len_range
    glo, ghi = max_tokens_range
    reqs = []
    for i in range(n_requests):
        plen = int(rs.randint(plo, phi + 1))
        gen = int(rs.randint(glo, ghi + 1))
        prompt = rs.randint(0, vocab, size=plen).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_tokens=gen,
                            arrival_s=float(arrivals[i])))
    return reqs


def summarize_requests(reqs: List[Request]) -> dict:
    """Latency/TTFT percentiles over finished requests."""
    done = [r for r in reqs if r.t_finished is not None]
    if not done:
        return {"n_finished": 0}
    lat = np.array([r.latency_s for r in done])
    ttft = np.array([r.ttft_s for r in done if r.ttft_s is not None])
    out = {
        "n_finished": len(done),
        "p50_latency_s": float(np.percentile(lat, 50)),
        "p99_latency_s": float(np.percentile(lat, 99)),
        "mean_latency_s": float(lat.mean()),
    }
    if ttft.size:
        out["ttft_p50_s"] = float(np.percentile(ttft, 50))
        out["ttft_p99_s"] = float(np.percentile(ttft, 99))
    return out
