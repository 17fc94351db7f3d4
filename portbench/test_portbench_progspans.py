"""The readers of the program's own spans (``bench/progspans.py`` and the
metrics that use it) against records built and worked by hand: the
program's spans in the tracer's ring, and profiler events whose
correlation ids join each device operation to the host call that launched
it, with operations that run after their span has ended on the host.
Then the profiler switch end to end: a traced CPU smoke run of the
batch-generation cell reports the admission's prefill and tail from the
program's spans, and an untraced one leaves the program's ring empty."""
import json
import os
import subprocess
import sys
import types

import pytest
import torch

from bench import progspans, spec
from repro_torch.telemetry import trace

import test_portbench_runs as runs

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU
MS = 1_000_000          # nanoseconds a millisecond
BASE = 5_000 * 1_000 * MS   # the clock's origin in the hand-built records


class Event:
    """A profiler event as ``progspans`` reads it."""

    def __init__(self, name, device, start_ms, dur_ms, corr):
        self._v = (name, device, BASE + round(start_ms * MS),
                   round(dur_ms * MS), corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


class Trace:
    """The ``DeviceTrace`` of a hand-built record: what ``progspans``
    reads of it."""

    def __init__(self, prof, ranges):
        self.prof, self.ranges = prof, ranges


def launch(name, at_ms, corr):
    return Event(name, CPU, at_ms, 0.01, corr)


def kernel(start_ms, end_ms, corr, name="kernel"):
    return Event(name, CUDA, start_ms, end_ms - start_ms, corr)


def record(ranges, events, spans):
    """A run's record: the benchmark's spans (ms), the profiler's events,
    and the program's spans [(name, t0 ms, t1 ms, parent index, attrs)]
    put in a configured tracer's ring."""
    tracer = trace.configure(None)
    for i, (name, t0, t1, parent, attrs) in enumerate(spans):
        t0_ns, t1_ns = BASE + round(t0 * MS), BASE + round(t1 * MS)
        tracer.events.append({
            "ts": t1_ns * 1e-9, "kind": "span", "name": name,
            "dur_s": (t1_ns - t0_ns) * 1e-9, **attrs, "t0_ns": t0_ns,
            "t1_ns": t1_ns, "id": i + 1,
            "parent": None if parent is None else parent + 1})
    tracer.events.append({"ts": 0.0, "kind": "note", "name": "not a span"})
    results = types.SimpleNamespace(events=lambda: events)
    prof = types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))
    tr = Trace(
        prof=prof, ranges=[("portbench." + n, (BASE + s * MS) * 1e-9,
                            (BASE + e * MS) * 1e-9) for n, s, e in ranges])
    return {"trace": tr, "counters": {}, "spans": {}}


@pytest.fixture
def tracer_reset():
    trace.reset()
    yield
    trace.reset()


def read(name, rec):
    return spec.load_reader(name)(rec)


# Two admissions, three decode blocks.  The first admission's prefill
# launches a kernel at 10 ms that runs until 14, after the prefill span
# ended at 11 on the host: it belongs to the prefill, and covers 3 ms of
# the tail span.  Blocks 1 and 2 have no admission between them: the gap
# runs from the end of block 1's graph (48) to block 2's mask upload
# (51.3), less the readback's copy (0.1 ms).  Blocks 2 and 3 have the
# second admission between them and are not a pair.  A prefill span after
# the profiled stretch is left out; so is another graph's replay.
GEN_RANGES = [("admit", 0.5, 30.5), ("decode_block", 31.5, 50.5),
              ("decode_block", 50.8, 70.5), ("admit", 71.5, 99),
              ("decode_block", 100.5, 120)]
GEN_SPANS = [
    ("engine.admit", 0, 31, None, {"rid": 1, "slot": 0, "prompt_len": 19}),
    ("slots.prefill", 1, 11, 0, {"tokens": 16}),
    ("slots.tail", 11, 29, 0, {"tokens": 3}),
    ("engine.block", 32, 34, None, {"block": 1, "active": 2}),
    ("graph.replay", 32.5, 33.5, 3, {"graph": "engine.decode_block"}),
    ("engine.block", 51, 52, None, {"block": 2, "active": 2}),
    ("graph.replay", 51.2, 51.8, 5, {"graph": "engine.decode_block"}),
    ("engine.admit", 71, 100, None, {"rid": 2, "slot": 1, "prompt_len": 24}),
    ("slots.prefill", 72, 80, 7, {"tokens": 24}),
    ("slots.tail", 80, 80.5, 7, {"tokens": 0}),
    ("engine.block", 101, 102, None, {"block": 3, "active": 2}),
    ("graph.replay", 101.2, 101.6, 10, {"graph": "engine.decode_block"}),
    ("graph.replay", 103, 113, None, {"graph": "other"}),
    ("slots.prefill", 200, 290, None, {"tokens": 16}),
]
GEN_EVENTS = [
    launch("cudaLaunchKernel", 2, 1), kernel(3, 9, 1),
    launch("cudaLaunchKernel", 10, 2), kernel(10, 14, 2),
    launch("cudaLaunchKernel", 12, 3), kernel(14, 15, 3),
    launch("cudaLaunchKernel", 20, 4), kernel(21, 22, 4),
    launch("cudaMemcpyAsync", 32.1, 5), kernel(32.2, 32.3, 5, "Memcpy HtoD"),
    launch("cudaGraphLaunch", 32.6, 6), kernel(33, 40, 6), kernel(40, 48, 6),
    launch("cudaMemcpyAsync", 48.5, 7), kernel(48.5, 48.6, 7, "Memcpy DtoH"),
    launch("cudaMemcpyAsync", 51.1, 8), kernel(51.3, 51.4, 8, "Memcpy HtoD"),
    launch("cudaGraphLaunch", 51.3, 9), kernel(52, 60, 9), kernel(60, 68, 9),
    launch("cuLaunchKernel", 73, 11), kernel(74, 79, 11, "hand_kernel"),
    launch("cudaGraphLaunch", 101.3, 10), kernel(102, 110, 10),
    kernel(111, 112, 99),                      # its launch is not held
    Event("portbench.decode_block", CUDA, 31.5, 19, 0),
    Event("aten::mm", CPU, 2, 1, 6),           # an operator, not a launch
]


def test_generation_readers_by_hand(tracer_reset, capsys):
    rec = record(GEN_RANGES, GEN_EVENTS, GEN_SPANS)
    pt = progspans.read(rec)
    assert len(pt.ops) == 14 and len(pt.launched) == 13
    assert "1 without their launch" in capsys.readouterr().err
    assert [o.start for o in pt.launched_in(pt.named("slots.prefill"))] \
        == pytest.approx([(BASE + t * MS) * 1e-9 for t in (3, 10, 74)])
    assert read("admit_prefill_ms.gen", rec) == pytest.approx(9.0)
    assert read("admit_tail_ms.gen", rec) == pytest.approx(9.25)
    # tails: 18 ms with 5 covered (3 of them by the prefill's late kernel)
    # and 0.5 ms with none
    assert read("admit_tail_idle_share.gen", rec) == pytest.approx(
        100 * (1 - 5 / 18.5), abs=1e-4)
    assert read("block_gap_ms.gen", rec) == pytest.approx(3.2, abs=1e-4)
    assert read("graph_launch_ms.gen", rec) == pytest.approx(2.0 / 3,
                                                            abs=1e-4)
    # read once a run
    assert progspans.read(rec) is pt


# One update of two microbatches.  The first forward's kernel runs past
# the span's end; so do the second backward's last one and the optimizer's
# last one, which ends after ``ppo.step`` itself; one op (the loss's
# scaling) lies in ``ppo.step`` but in no phase; the rollout's graph lies
# in no step.
PPO_RANGES = [("step", 0, 100), ("rollout", 0, 45), ("update", 50, 100)]
PPO_SPANS = [
    ("graph.replay", 10, 11, None, {"graph": "lm_rollout.step"}),
    ("ppo.step", 50, 80, None, {"microbatches": 2}),
    ("ppo.forward", 51, 55, 1, {"microbatch": 0}),
    ("ppo.backward", 55, 62, 1, {"microbatch": 0}),
    ("ppo.forward", 62, 65, 1, {"microbatch": 1}),
    ("ppo.backward", 65, 70, 1, {"microbatch": 1}),
    ("optim.update", 71, 78, 1, {}),
]
PPO_EVENTS = [
    launch("cudaGraphLaunch", 10.5, 9), kernel(11, 20, 9),
    launch("cudaLaunchKernel", 52, 1), kernel(53, 56, 1),
    launch("cudaLaunchKernel", 56, 2), kernel(56, 61, 2),
    launch("cudaLaunchKernel", 63, 3), kernel(63, 64, 3),
    launch("cudaLaunchKernel", 66, 4), kernel(66, 69, 4),
    launch("cuLaunchKernel", 69.5, 5), kernel(69.5, 72, 5, "ssd_scan"),
    launch("cudaLaunchKernel", 70.5, 6), kernel(72, 72.5, 6),
    launch("cudaLaunchKernel", 72, 7), kernel(72.5, 79, 7),
    launch("cudaLaunchKernel", 77, 8), kernel(79, 85, 8),
]


def test_update_readers_by_hand(tracer_reset, capsys):
    rec = record(PPO_RANGES, PPO_EVENTS, PPO_SPANS)
    assert read("update_forward_ms.ppo", rec) == pytest.approx(4.0, abs=1e-4)
    assert read("update_backward_ms.ppo", rec) == pytest.approx(10.5,
                                                               abs=1e-4)
    assert read("update_optim_ms.ppo", rec) == pytest.approx(12.5, abs=1e-4)
    phases = progspans.update_phases(progspans.read(rec))
    assert [len(phases[k]) for k in phases] == [2, 3, 2, 1]
    # from ppo.step's start (50) to its last op's end (85): busy 8 + 1 +
    # 3 + 15.5 of 35 ms
    assert read("update_idle_share.ppo", rec) == pytest.approx(
        100 * (1 - 27.5 / 35), abs=1e-4)
    assert "no phase 0.500 (1 ops)" in capsys.readouterr().err


def test_readers_leave_a_run_without_spans_out(tracer_reset):
    bare = record(PPO_RANGES, [], [])
    untraced = {"trace": None, "counters": {}, "spans": {}}
    names = [m["name"] for m in spec.load_benchmark()["per_layer"]
             if m["name"].startswith(("admit_prefill", "admit_tail",
                                      "block_gap", "graph_launch",
                                      "update_"))
             and m["name"] != "update_s.ppo"]
    assert len(names) == 9
    for name in names:
        assert read(name, untraced) is None
        assert read(name, bare) is None


SCRIPT = """
import json, sys, time
t = time.perf_counter()
import torch
torch.set_num_threads(1)
sys.path[:0] = [{here!r}, {src!r}]
import run
run.prepare_env()
from bench import harness, spec
from repro_torch.telemetry import trace
bench = spec.load_benchmark()
cell = spec.find_cell(bench, {cell!r})
out = {{}}
for traced in (0, 1):
    res = harness.run_cell(bench, cell, {seed}, 0.5, traced, "cpu", t,
                           model_overrides={model!r}, mix_overrides={mix!r})
    out[traced] = {{"metrics": res["metrics"], "correct": res["correct"],
                    "ring": len(trace.get_tracer().events)}}
print(json.dumps(out))
"""


def test_the_profiler_switches_the_program_spans_on():
    cell = "zamba2-7b.batchgen"
    model, mix = runs.SMOKE[cell]
    code = SCRIPT.format(here=str(runs.HERE), src=str(runs.ROOT / "src"),
                         cell=cell, seed=2**31 + 11, model=model, mix=mix)
    env = dict(os.environ, PYTHONPATH=str(runs.ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=runs.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    plain, traced = got["0"], got["1"]
    assert plain["correct"] and traced["correct"]
    assert plain["ring"] == 0
    assert traced["ring"] > 0
    for name in ("admit_prefill_ms.gen", "admit_tail_ms.gen"):
        assert traced["metrics"][name]["value"] > 0
