"""The port's ``telemetry/trace.py``: the module-level ``span`` and ``emit``
(and the ``repro_torch.telemetry`` re-exports) against JAX's, which put
events of the same kind, name and fields on the global tracer's ring and
in its JSONL file; then what the port adds: nothing recorded unless a
tracer is configured or a profiler runs, span ids and parents, times on
the profiler's clock, spans whose body raised, and a file written at
``flush`` and ``close`` and whenever a ring's worth of events waits."""
import json

import pytest

torch = pytest.importorskip("torch")

from repro.telemetry import trace as jtrace  # noqa: E402
from repro_torch import telemetry as ttel  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.telemetry import trace as ttrace  # noqa: E402

# the fields a port span adds to JAX's
NEW_SPAN_FIELDS = ("t0_ns", "t1_ns", "id", "parent")


@pytest.fixture
def default_tracer():
    """The process's default tracer, before and after the test."""
    ttrace.reset()
    yield ttrace.get_tracer()
    ttrace.reset()


def _events(mod, path, done):
    tracer = mod.configure(str(path))
    try:
        with mod.span("phase", step=3):
            mod.emit("note", "checkpoint", bytes=12)
        assert mod.get_tracer() is tracer
        ring = [dict(e) for e in tracer.events]
    finally:
        done()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    return ring, lines


def test_module_level_span_and_emit_match_jax(tmp_path):
    got, got_file = _events(ttrace, tmp_path / "port.jsonl", ttrace.reset)
    want, want_file = _events(jtrace, tmp_path / "jax.jsonl",
                              lambda: jtrace.configure(None))
    assert ttel.span is ttrace.span and ttel.reset is ttrace.reset
    for e in got + got_file:
        if e["kind"] == "span":
            new = {k: e.pop(k) for k in NEW_SPAN_FIELDS}
            assert 0 < new["t0_ns"] <= new["t1_ns"]
            assert e["dur_s"] == pytest.approx(
                (new["t1_ns"] - new["t0_ns"]) * 1e-9, abs=1e-12)
            assert e["ts"] == pytest.approx(new["t1_ns"] * 1e-9, abs=1e-6)
            assert new["parent"] is None and new["id"] == 1
    for events in (got, got_file, want, want_file):
        for e in events:
            assert e.pop("ts") > 0
            if e["kind"] == "span":
                assert e.pop("dur_s") >= 0
    assert got == want == got_file == want_file == [
        {"kind": "note", "name": "checkpoint", "bytes": 12},
        {"kind": "span", "name": "phase", "step": 3}]


def test_nothing_is_recorded_by_default(default_tracer, monkeypatch):
    entered = []
    monkeypatch.setattr(ttrace, "_profiler_range",
                        lambda name: entered.append(name))
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    first = ttrace.span("a", x=1)
    assert first is ttrace.span("b") is ttrace.NO_SPAN
    with first as sp, ttrace.span("inner"):
        sp.set(y=2)
    assert ttrace.emit("note", "n") is None
    default_tracer.memory_snapshot("tag")
    assert registry.backend_for("attention", site="default_test",
                                device="cpu") == "ref"
    assert list(default_tracer.events) == [] and entered == []
    assert default_tracer.dispatch_seen == set()


def test_spans_record_when_configured_and_under_a_profiler(default_tracer):
    tracer = ttrace.configure(None)
    with ttrace.span("configured"):
        pass
    assert [e["name"] for e in tracer.events] == ["configured"]
    tracer = ttrace.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with ttrace.span("profiled", n=1):
            ttrace.emit("note", "inside")
    with ttrace.span("after"):
        pass
    assert [(e["kind"], e["name"]) for e in tracer.events] == [
        ("note", "inside"), ("span", "profiled")]


def test_parent_and_child_ids(default_tracer):
    tracer = ttrace.configure(None)
    with ttrace.span("outer") as outer:
        with ttrace.span("first"):
            with ttrace.span("deep"):
                pass
        with ttrace.span("second") as sp:
            sp.set(tokens=5)
        outer.set(done=True)
    got = {e["name"]: e for e in tracer.events}
    assert got["outer"]["parent"] is None and got["outer"]["done"] is True
    assert got["first"]["parent"] == got["second"]["parent"] \
        == got["outer"]["id"]
    assert got["deep"]["parent"] == got["first"]["id"]
    assert got["second"]["tokens"] == 5
    assert len({e["id"] for e in tracer.events}) == 4
    assert [e["name"] for e in tracer.events] == ["deep", "first", "second",
                                                  "outer"]


def test_span_times_lie_on_the_profiler_clock(default_tracer):
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    for k in range(3):
        with ttrace.span(f"timed{k}"):
            torch.ones(64, 64).sum()
    prof.stop()
    ranges = {ev.name(): (ev.start_ns(), ev.start_ns() + ev.duration_ns())
              for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith("timed")}
    spans = {e["name"]: e for e in default_tracer.events}
    assert set(ranges) == set(spans) == {"timed0", "timed1", "timed2"}
    for name, (r0, r1) in ranges.items():
        assert abs(spans[name]["t0_ns"] - r0) < 1_000_000
        assert abs(spans[name]["t1_ns"] - r1) < 1_000_000


def test_a_span_whose_body_raises_is_recorded(default_tracer):
    tracer = ttrace.configure(None)
    with pytest.raises(KeyError):
        with ttrace.span("outer"):
            with ttrace.span("failing", k=1):
                raise KeyError("x")
    failing, outer = tracer.events
    assert failing["name"] == "failing" and failing["error"] == "KeyError"
    assert failing["k"] == 1 and failing["t1_ns"] >= failing["t0_ns"]
    assert outer["error"] == "KeyError"
    assert failing["parent"] == outer["id"]
    with ttrace.span("next"):
        pass
    assert tracer.events[-1]["parent"] is None


def test_jsonl_is_written_at_flush_and_close(default_tracer, tmp_path):
    path = tmp_path / "sub" / "trace.jsonl"
    tracer = ttrace.configure(str(path))

    def names():
        if not path.exists():
            return []
        return [json.loads(x)["name"] for x in path.read_text().splitlines()]

    with ttrace.span("one"):
        ttrace.emit("note", "two")
    assert names() == []
    tracer.flush()
    assert names() == ["two", "one"]
    tracer.flush()
    ttrace.emit("note", "three")
    assert names() == ["two", "one"]
    tracer.close()
    assert names() == ["two", "one", "three"]
    ttrace.emit("note", "four")
    tracer.flush()
    assert names() == ["two", "one", "three"]
    assert [e["name"] for e in tracer.events] == ["two", "one", "three",
                                                  "four"]


def test_a_long_run_keeps_its_file_current_without_flush(tmp_path):
    path = tmp_path / "trace.jsonl"
    tracer = ttrace.Tracer(str(path), ring_capacity=8)
    for k in range(27):
        with tracer.span("step", k=k):
            pass
        assert len(tracer._unwritten) < 8
    lines = [json.loads(x)["k"] for x in path.read_text().splitlines()]
    assert lines == list(range(24))
    tracer.close()
    lines = [json.loads(x)["k"] for x in path.read_text().splitlines()]
    assert lines == list(range(27))
