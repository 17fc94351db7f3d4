"""The program's own spans in a ``--trace 1`` run, and the device
operations each one launched.

The port's tracer (``repro_torch.telemetry.trace``) records a span while a
profiler runs, so the profiled stretch of a run holds the program's spans
(``engine.admit``, ``slots.prefill``, ``ppo.forward``, ...) in its ring,
stamped with ``time.time_ns()``, the clock the profiler stamps its events
on.  ``read(rec)`` keeps the spans that overlap the stretch the benchmark
profiled (from the first of its own spans' start to the last one's end)
and re-reads the profiler's events once a run.

A device operation belongs to the span that holds the host call that
launched it.  The profiler's correlation id links each kernel, copy or
set on the device to its CUDA API call on the host
(``cudaLaunchKernel``, ``cudaMemcpyAsync``, ``cudaGraphLaunch`` for every
kernel of a replayed graph, ``cuLaunchKernel``), and that call's start lies
inside the span on the host's clock.  Where the device's start time was
used instead, work that runs after its span has ended on the host (the
program's spans do not synchronise) would go to whatever span the host had
reached by then.  A device operation whose launch the trace does not hold
belongs to no span; ``read`` prints how many there are.
"""
from __future__ import annotations

import bisect
import re
import sys
import weakref
from typing import NamedTuple, Optional

import torch

from . import arith
from .devtrace import PREFIX, _ns

# the host side of a launch: a CUDA API call (cuda... or the lower cu...)
LAUNCH = re.compile(r"cu(da)?[A-Z]")
ANNOTATION = "gpu_user_annotation"


class Span(NamedTuple):
    name: str
    t0: float          # seconds on the profiler's clock
    t1: float
    attrs: dict

    @property
    def wall(self) -> float:
        return self.t1 - self.t0


class Op(NamedTuple):
    name: str
    start: float       # on the device, seconds on the profiler's clock
    end: float
    launch: Optional[float]   # the launching call's start on the host


class ProgramTrace:
    """The program's spans in the profiled stretch and the device
    operations, with the joins the readers need."""

    def __init__(self, spans, ops):
        self.spans = sorted(spans, key=lambda s: s.t0)
        self.ops = sorted(ops, key=lambda o: o.start)
        self._starts = [o.start for o in self.ops]
        self._longest = max((o.end - o.start for o in self.ops), default=0.0)
        self.launched = sorted((o for o in self.ops if o.launch is not None),
                               key=lambda o: o.launch)
        self._launches = [o.launch for o in self.launched]

    def named(self, name, **attrs):
        """The spans called ``name`` whose attributes include ``attrs``."""
        return [s for s in self.spans if s.name == name and
                all(s.attrs.get(k) == v for k, v in attrs.items())]

    def launched_in(self, spans):
        """The device operations whose launch lies inside one of
        ``spans`` on the host, each once."""
        out = {}
        for s in spans:
            lo = bisect.bisect_left(self._launches, s.t0)
            hi = bisect.bisect_right(self._launches, s.t1)
            for o in self.launched[lo:hi]:
                out[id(o)] = o
        return sorted(out.values(), key=lambda o: o.start)

    def busy(self, lo, hi) -> float:
        """Seconds of [lo, hi] in which some device operation ran."""
        a = bisect.bisect_left(self._starts, lo - self._longest)
        b = bisect.bisect_right(self._starts, hi)
        return arith.union_seconds([(o.start, o.end) for o in self.ops[a:b]],
                                   lo, hi)


_read = weakref.WeakKeyDictionary()


def stretch(tr):
    """(start, end) of the benchmark's own spans: the profiled stretch."""
    if not tr.ranges:
        return None
    return min(s for _, s, _ in tr.ranges), max(e for _, _, e in tr.ranges)


def program_spans(lo, hi):
    """The tracer's span records that overlap [lo, hi] (seconds)."""
    from repro_torch.telemetry import trace
    out = []
    for e in list(trace.get_tracer().events):
        if e.get("kind") != "span" or "t0_ns" not in e:
            continue
        t0, t1 = e["t0_ns"] * 1e-9, e["t1_ns"] * 1e-9
        if t1 < lo or t0 > hi:
            continue
        attrs = {k: v for k, v in e.items() if k not in (
            "ts", "kind", "name", "dur_s", "t0_ns", "t1_ns", "id", "parent")}
        out.append(Span(e["name"], t0, t1, attrs))
    return out


def device_ops(prof):
    """Every operation on the device (not the benchmark's spans' copies,
    not user annotations), each with its launching call's host start."""
    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:
        return []
    cuda = torch.autograd.DeviceType.CUDA
    launches, dev = {}, []
    for ev in results.events():
        name = ev.name()
        if ev.device_type() == cuda:
            kind = ev.activity_type() if hasattr(ev, "activity_type") \
                else None
            if name.startswith(PREFIX) or kind == ANNOTATION:
                continue
            start = _ns(ev, "start")
            dev.append((name, start, start + _ns(ev, "duration"),
                        ev.correlation_id()))
        elif LAUNCH.match(name):
            launches[ev.correlation_id()] = _ns(ev, "start")
    return [Op(n, s, e, launches.get(c)) for n, s, e, c in dev]


def read(rec) -> Optional[ProgramTrace]:
    """The program's trace of a run: None without a device trace or a
    profiled stretch.  Read once a run."""
    tr = rec.get("trace")
    if tr is None:
        return None
    if tr not in _read:
        win = stretch(tr)
        if win is None:
            _read[tr] = None
        else:
            pt = ProgramTrace(program_spans(*win), device_ops(tr.prof))
            orphans = len(pt.ops) - len(pt.launched)
            print(f"progspans: {len(pt.spans)} program spans, "
                  f"{len(pt.ops)} device operations, {orphans} without "
                  "their launch in the trace", file=sys.stderr)
            _read[tr] = pt
    return _read[tr]


def mean_ms(spans) -> Optional[float]:
    """Mean host wall of ``spans`` in milliseconds; None where there are
    none."""
    if not spans:
        return None
    return 1e3 * sum(s.wall for s in spans) / len(spans)


def update_phases(pt):
    """{phase: the device operations it launched} for the traced updates'
    phases (``ppo.forward``, ``ppo.backward``, ``optim.update``), and
    ``None``: those launched inside ``ppo.step`` that no phase holds."""
    steps = pt.named("ppo.step")
    out = {name: pt.launched_in(pt.named(name))
           for name in ("ppo.forward", "ppo.backward", "optim.update")}
    held = {id(o) for ops in out.values() for o in ops}
    out[None] = [o for o in pt.launched_in(steps) if id(o) not in held]
    return out


def device_ms(ops, n) -> Optional[float]:
    """Device milliseconds of ``ops`` over ``n`` (the updates traced)."""
    if not n or not ops:
        return None
    return 1e3 * sum(o.end - o.start for o in ops) / n
