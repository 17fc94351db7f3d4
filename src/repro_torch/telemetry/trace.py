"""Host-side tracing: spans, structured JSONL events, device-memory snapshots.

The PyTorch port of ``repro/telemetry/trace.py``, cut to what the port uses:

- ``span("engine.admit", rid=3)``: times a host phase and records a
  ``span`` event.  PyTorch dispatches CUDA work asynchronously and no span
  synchronises, so a span's wall is the host's; the device work launched
  inside it is found from the profiler's launch records (a kernel's
  correlation id leads to the host call that launched it, and that call's
  time to the span).
- ``memory_snapshot``: ``torch.cuda.memory_stats()`` at phase boundaries;
  skipped when no CUDA device is initialised.

The JAX recompile detector (``watch_jit`` / ``poll_recompiles``) has no
counterpart: eager PyTorch never traces or compiles a program.

**When anything records.**  A tracer records while it is *configured*
(``configure(path)``, as the entry points do; ``configure(None)`` records
in memory only) or while a ``torch.profiler`` is running, so a profiled
stretch holds the program's spans with nothing else switched on.  The
process starts with an unconfigured tracer (``reset()`` returns to it):
then ``span`` returns one shared no-op context after a single check (no
clock read, no profiler range, no event), and ``emit`` and
``memory_snapshot`` return at once.

**A span record** holds JAX's fields (``ts``, ``kind``, ``name``,
``dur_s``, the attributes) and ``t0_ns`` / ``t1_ns``, both
``time.time_ns()``, the clock ``torch.profiler`` stamps its events on:
``ts`` is ``t1_ns`` in seconds and ``dur_s`` their difference.  It also
holds an ``id``, the ``parent`` id of the span that encloses it on the
same thread (None at the top), attributes set inside the body
(``with span(...) as sp: sp.set(tokens=n)``), and ``error`` (the
exception's type) when the body raised; such a span is recorded too.
While a profiler runs, a span also names its stretch on the profiler's
host timeline as an operator-scope range.  A user-scope range
(``record_function``) would add a copy of itself to the device's
timeline, which readers of device time would count as device work.

Events are dicts that land in an in-memory ring.  A tracer configured with
a path also keeps the events not yet written, and appends them to its
``.jsonl`` file, one JSON object a line, at ``flush()`` (the entry points
call it at their log boundaries), whenever a ring's worth is waiting (so a
long phase between flushes holds at most that many, and its file stays
current to within them), and at ``close()``; the process-global tracer is
closed at exit.
"""
from __future__ import annotations

import atexit
import itertools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Optional

import torch
# an operator-scope profiler range: on the host timeline only
from torch._C._profiler import _RecordFunctionFast as _profiler_range

RING_CAPACITY = 4096

_profiling = torch._C._autograd._profiler_enabled


class _NoSpan:
    """The span of a tracer that records nothing: one shared instance."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NO_SPAN = _NoSpan()


class _Span:
    """One recording span; see the module docstring."""

    __slots__ = ("tracer", "name", "attrs", "id", "parent", "t0", "range")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.tracer, self.name, self.attrs = tracer, name, attrs

    def set(self, **attrs) -> None:
        """Attributes known only inside the body (counts, outcomes)."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = self.tracer._stack()
        self.parent = stack[-1] if stack else None
        self.id = next(self.tracer._ids)
        stack.append(self.id)
        self.range = _profiler_range(self.name) if _profiling() else None
        if self.range is not None:
            self.range.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, typ, exc, tb):
        t1 = time.time_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        self.tracer._stack().pop()
        fields = dict(self.attrs, t0_ns=self.t0, t1_ns=t1, id=self.id,
                      parent=self.parent)
        if typ is not None:
            fields["error"] = typ.__name__
        self.tracer._record({"ts": t1 * 1e-9, "kind": "span",
                             "name": self.name,
                             "dur_s": (t1 - self.t0) * 1e-9, **fields})
        return False


class Tracer:
    """Event collector: ring buffer + optional JSONL file, written at
    ``flush`` / ``close``.  ``configured=False`` records only while a
    profiler runs (the process's default tracer)."""

    def __init__(self, path: Optional[str] = None,
                 ring_capacity: int = RING_CAPACITY, *,
                 configured: bool = True):
        self.path = path
        self.configured = configured
        self.events: deque = deque(maxlen=ring_capacity)
        self._unwritten: list = []
        self._ids = itertools.count(1)
        self._local = threading.local()
        # (op, site, backend) triples already reported as kernel_dispatch
        # events: eager code resolves the backend on every call, JAX once per
        # trace, so the port reports each resolution once per tracer.
        self.dispatch_seen: set = set()

    def recording(self) -> bool:
        return self.configured or _profiling()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, event: dict) -> dict:
        self.events.append(event)
        if self.path:
            self._unwritten.append(event)
            if len(self._unwritten) >= self.events.maxlen:
                self.flush()
        return event

    def emit(self, kind: str, name: str, **fields) -> Optional[dict]:
        if not (self.configured or _profiling()):
            return None
        return self._record({"ts": round(time.time(), 6), "kind": kind,
                             "name": name, **fields})

    def span(self, name: str, **attrs):
        """A host phase (see the module docstring); a shared no-op context
        when nothing records."""
        if not (self.configured or _profiling()):
            return NO_SPAN
        return _Span(self, name, attrs)

    def memory_snapshot(self, tag: str) -> None:
        """One ``memory`` event per initialised CUDA device."""
        if not self.recording() or not torch.cuda.is_initialized():
            return
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            if not stats:
                continue
            self.emit("memory", tag, device=f"cuda:{i}",
                      bytes_in_use=stats.get("allocated_bytes.all.current"),
                      peak_bytes_in_use=stats.get("allocated_bytes.all.peak"),
                      bytes_reserved=stats.get("reserved_bytes.all.current"))

    def flush(self) -> None:
        """Append the events not yet written to the JSONL file."""
        if not self.path or not self._unwritten:
            return
        pending, self._unwritten = self._unwritten, []
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with open(self.path, "a") as f:
            f.writelines(json.dumps(e) + "\n" for e in pending)

    def close(self) -> None:
        """Flush; later events stay in the ring only."""
        self.flush()
        self.path = None


# -- process-global tracer ---------------------------------------------------
_global_tracer = Tracer(configured=False)


def get_tracer() -> Tracer:
    return _global_tracer


def configure(path: Optional[str] = None) -> Tracer:
    """Install (and return) a fresh global tracer that records, writing
    JSONL to ``path`` (in memory only where None).  The previous tracer is
    closed; its ring is discarded."""
    global _global_tracer
    _global_tracer.close()
    _global_tracer = Tracer(path)
    return _global_tracer


def reset() -> Tracer:
    """Back to the process's default: a fresh global tracer that records
    only while a profiler runs.  The previous tracer is closed."""
    global _global_tracer
    _global_tracer.close()
    _global_tracer = Tracer(configured=False)
    return _global_tracer


atexit.register(lambda: _global_tracer.close())


def span(name: str, **attrs):
    """Module-level convenience: a span on the global tracer."""
    return _global_tracer.span(name, **attrs)


def emit(kind: str, name: str, **fields) -> Optional[dict]:
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
