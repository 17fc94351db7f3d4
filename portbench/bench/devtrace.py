"""The device trace of a ``--trace 1`` run, read from ``torch.profiler``.

``DeviceTrace`` profiles host and device activity, and ``span(name)``
marks a stretch of the run as ``portbench.<name>`` that ends in a
synchronise, so the device work a span launched ends inside it.  After
``stop`` the raw kineto events are read once into plain lists of
(name, start_s, end_s): ``kernels`` (every operation on the device:
kernels, copies, sets; not the spans' own marks on the device's
timeline), ``ranges`` (the benchmark's spans) and ``host_ops``
(everything else on the host), all on the profiler's clock.
"""
from __future__ import annotations

import contextlib

import torch

from . import arith

PREFIX = "portbench."
NAME_MAX = 160


def _ns(ev, what):
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return f() * 1e-9
    return getattr(ev, f"{what}_us")() * 1e-6


class DeviceTrace:
    def __init__(self, device):
        self.device = torch.device(device)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.kernels, self.ranges, self.host_ops = [], [], []

    def start(self):
        self.prof.start()

    def stop(self):
        self.prof.stop()
        self._read()

    @contextlib.contextmanager
    def span(self, name):
        with torch.profiler.record_function(PREFIX + name):
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def _read(self):
        inner = self.prof.profiler
        results = getattr(inner, "kineto_results", None)
        if results is None:
            return
        for ev in results.events():
            start = _ns(ev, "start")
            item = (ev.name(), start, start + _ns(ev, "duration"))
            marker = item[0].startswith(PREFIX)
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                if not marker:   # a span's copy on the device's timeline
                    self.kernels.append(item)
            elif marker:
                self.ranges.append(item)
            else:
                self.host_ops.append(item)

    # -- what the readers and the breakdown use -------------------------------
    def range_bounds(self, name):
        """(start, end) of every ``portbench.<name>`` span."""
        return [(s, e) for n, s, e in self.ranges if n == PREFIX + name]

    def window(self, name):
        """The traced window: from the first ``name`` span's start to the
        last one's end."""
        spans = [(s, e) for n, s, e in self.ranges if n == PREFIX + name]
        if not spans:
            return None
        return min(s for s, _ in spans), max(e for _, e in spans)

    def kernels_in(self, bounds, match=None):
        """Device operations that start inside any of ``bounds``, whose
        name contains ``match`` (all where None)."""
        out = []
        for n, s, e in self.kernels:
            if match is not None and match not in n:
                continue
            if any(lo <= s < hi for lo, hi in bounds):
                out.append((n, s, e))
        return out

    def busy(self, lo, hi):
        return arith.union_seconds([(s, e) for _, s, e in self.kernels],
                                   lo, hi)

    def breakdown(self, lo, hi, top=10):
        """The device operations that took most time and the longest idle
        gaps, each named by the benchmark span and the host operation
        running at its middle."""
        by_name = {}
        for n, s, e in self.kernels:
            if lo <= s < hi:
                by_name[n] = by_name.get(n, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = []
        spans = [r for r in self.ranges if r[0].startswith(PREFIX)]
        for g0, g1 in arith.gaps([(s, e) for _, s, e in self.kernels],
                                 lo, hi)[:top]:
            mid = 0.5 * (g0 + g1)
            where = [r for r in spans if r[1] <= mid <= r[2]]
            host = [o for o in self.host_ops if o[1] <= mid <= o[2]]
            label = max(where, key=lambda r: r[1])[0][len(PREFIX):] \
                if where else "outside spans"
            if host:
                label += "/" + max(host, key=lambda o: o[1])[0]
            idle.append([label[:NAME_MAX], g1 - g0])
        return {"device_ops": [[n[:NAME_MAX], t] for n, t in ops],
                "idle_gaps": idle}
