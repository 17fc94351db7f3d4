"""The module-level ``span`` and ``emit`` of the port's
``telemetry/trace.py`` (and the ``repro_torch.telemetry`` re-exports)
against JAX's: the same calls put events of the same kind, name and
fields on the global tracer's ring and in its JSONL file."""
import json

import pytest

torch = pytest.importorskip("torch")

from repro.telemetry import trace as jtrace  # noqa: E402
from repro_torch import telemetry as ttel  # noqa: E402
from repro_torch.telemetry import trace as ttrace  # noqa: E402


def _events(mod, path):
    tracer = mod.configure(str(path))
    try:
        with mod.span("phase", step=3):
            mod.emit("note", "checkpoint", bytes=12)
        assert mod.get_tracer() is tracer
        ring = [dict(e) for e in tracer.events]
    finally:
        mod.configure(None)
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    return ring, lines


def test_module_level_span_and_emit_match_jax(tmp_path):
    got, got_file = _events(ttrace, tmp_path / "port.jsonl")
    want, want_file = _events(jtrace, tmp_path / "jax.jsonl")
    assert ttel.span is ttrace.span
    for events in (got, got_file, want, want_file):
        for e in events:
            assert e.pop("ts") > 0
            if e["kind"] == "span":
                assert e.pop("dur_s") >= 0
    assert got == want == got_file == want_file == [
        {"kind": "note", "name": "checkpoint", "bytes": 12},
        {"kind": "span", "name": "phase", "step": 3}]
