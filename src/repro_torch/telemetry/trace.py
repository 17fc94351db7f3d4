"""Host-side tracing: spans, structured JSONL events, device-memory snapshots.

The PyTorch port of ``repro/telemetry/trace.py``, cut to what the serving
path uses:

- ``span("serve.prefill")``: times a host phase, names it on the
  ``torch.profiler`` timeline (``record_function``) and emits a structured
  JSONL event.  PyTorch dispatches CUDA work asynchronously, so a span
  measures device time only where the code inside it synchronises.
- ``memory_snapshot``: ``torch.cuda.memory_stats()`` at phase boundaries;
  skipped when no CUDA device is initialised.

The JAX recompile detector (``watch_jit`` / ``poll_recompiles``) has no
counterpart: eager PyTorch never traces or compiles a program.

Events are dicts with ``ts`` (unix seconds), ``kind``, ``name`` plus
kind-specific fields; they land in an in-memory ring and, when the tracer is
configured with a path, one JSON object per line in a ``.jsonl`` file.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from contextlib import contextmanager
from typing import Optional

import torch

RING_CAPACITY = 4096


class Tracer:
    """Event collector: ring buffer + optional JSONL file sink."""

    def __init__(self, path: Optional[str] = None,
                 ring_capacity: int = RING_CAPACITY):
        self.path = path
        self._file = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._file = open(path, "a", buffering=1)
        self.events: deque = deque(maxlen=ring_capacity)
        # (op, site, backend) triples already reported as kernel_dispatch
        # events: eager code resolves the backend on every call, JAX once per
        # trace, so the port reports each resolution once per tracer.
        self.dispatch_seen: set = set()

    def emit(self, kind: str, name: str, **fields) -> dict:
        event = {"ts": round(time.time(), 6), "kind": kind, "name": name,
                 **fields}
        self.events.append(event)
        if self._file is not None:
            self._file.write(json.dumps(event) + "\n")
        return event

    @contextmanager
    def span(self, name: str, **attrs):
        """Time a host phase; annotate the profiler timeline; emit a
        ``span`` event with ``dur_s`` on exit."""
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.emit("span", name, dur_s=round(time.perf_counter() - t0, 6),
                  **attrs)

    def memory_snapshot(self, tag: str) -> None:
        """One ``memory`` event per initialised CUDA device."""
        if not torch.cuda.is_initialized():
            return
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            if not stats:
                continue
            self.emit("memory", tag, device=f"cuda:{i}",
                      bytes_in_use=stats.get("allocated_bytes.all.current"),
                      peak_bytes_in_use=stats.get("allocated_bytes.all.peak"),
                      bytes_reserved=stats.get("reserved_bytes.all.current"))

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


# -- process-global tracer ---------------------------------------------------
_global_tracer = Tracer()


def get_tracer() -> Tracer:
    return _global_tracer


def configure(path: Optional[str] = None) -> Tracer:
    """Install (and return) a fresh global tracer writing JSONL to ``path``.
    The previous tracer's file is closed; its ring is discarded."""
    global _global_tracer
    _global_tracer.close()
    _global_tracer = Tracer(path)
    return _global_tracer


def span(name: str, **attrs):
    """Module-level convenience: a span on the global tracer."""
    return _global_tracer.span(name, **attrs)


def emit(kind: str, name: str, **fields) -> dict:
    """Module-level convenience: an event on the global tracer."""
    return _global_tracer.emit(kind, name, **fields)


@contextmanager
def chrome_trace(profile: Optional[str], log_dir: Optional[str], device,
                 filename: str):
    """The entry points' ``--profile[=DIR]``: run the body under
    ``torch.profiler`` (the CPU, and CUDA on a CUDA device; the tracer's
    spans appear as ranges) and write its Chrome trace to
    ``DIR/filename`` (DIR defaults to ``<log_dir>/profile``).  ``profile``
    None runs the body unprofiled."""
    if profile is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        out_dir = profile or os.path.join(log_dir or ".", "profile")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, filename)
        prof.export_chrome_trace(path)
        print(f"profiler trace written to {path}")
