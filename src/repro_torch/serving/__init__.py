"""Serving subsystem of the PyTorch port: continuous (in-flight) batching.

- ``workload``:  Poisson arrival traces of mixed-length requests.
- ``scheduler``: FCFS admission-controlled queue + slot bookkeeping.
- ``slots``:     SlotCache — bucketed single-prompt prefill, exact tail
                 advance, in-place slot surgery over ``models/backbones``.
- ``engine``:    ContinuousBatchEngine — the decode-block loop that swaps
                 finished sequences for waiting prompts every block, with a
                 lockstep ``mode="static"`` baseline.

Entry point: ``python -m repro_torch.launch.serve [--continuous]``.
"""
from .engine import ContinuousBatchEngine, make_decode_block
from .scheduler import Scheduler
from .slots import DEFAULT_BUCKETS, SlotCache, bucket_for
from .workload import Request, poisson_trace, summarize_requests

__all__ = [
    "ContinuousBatchEngine", "make_decode_block", "Scheduler", "SlotCache",
    "DEFAULT_BUCKETS", "bucket_for", "Request", "poisson_trace",
    "summarize_requests",
]
