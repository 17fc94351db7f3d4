"""Telemetry for the PyTorch port: in-program sentinels, host-side tracing
and metric sinks.

- :mod:`repro_torch.telemetry.sentinels` — health scalars threaded through
  the train window (norms, loss moments, non-finite counts, replay
  stats), with the ``nan_guard`` tripwire;
- :mod:`repro_torch.telemetry.trace` — spans, structured JSONL events,
  device-memory snapshots;
- :mod:`repro_torch.telemetry.metrics` — ``MetricsRegistry`` fanning rows
  out to console / CSV / JSONL / TensorBoard sinks.
"""
from .metrics import MetricsRegistry  # noqa: F401
from .sentinels import NonFiniteError, Sentinels  # noqa: F401
from .trace import Tracer, configure, get_tracer, reset, span  # noqa: F401
