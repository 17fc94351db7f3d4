"""Telemetry for the PyTorch port: host-side tracing and metric sinks.

- :mod:`repro_torch.telemetry.trace` — spans, structured JSONL events,
  device-memory snapshots;
- :mod:`repro_torch.telemetry.metrics` — ``MetricsRegistry`` fanning rows
  out to console / JSONL sinks.
"""
from .metrics import MetricsRegistry  # noqa: F401
from .trace import Tracer, configure, get_tracer  # noqa: F401
