"""Metric sinks behind one registry.

The PyTorch port of ``repro/telemetry/metrics.py``, cut to the sinks the
serving entry point uses: ``console`` (the aligned key/value table) and
``jsonl`` (one JSON object per row, the machine-readable feed).  The CSV and
TensorBoard sinks wait for the training slice.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Iterable, Optional


def _scalar(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


class Sink:
    def write(self, row: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class ConsoleSink(Sink):
    """Aligned key/value table per row."""

    def __init__(self, stream=None):
        self.stream = stream or sys.stdout

    def write(self, row: dict) -> None:
        width = max(len(k) for k in row)
        lines = [f"| {k.ljust(width)} | {self._fmt(v):>12} |"
                 for k, v in row.items()]
        bar = "-" * len(lines[0])
        print("\n".join([bar] + lines + [bar]), file=self.stream, flush=True)

    @staticmethod
    def _fmt(v):
        if isinstance(v, float):
            return f"{v:.4g}"
        return str(v)


class JSONLSink(Sink):
    def __init__(self, path: str):
        self._file = open(path, "a", buffering=1)

    def write(self, row: dict) -> None:
        self._file.write(json.dumps(row) + "\n")

    def close(self) -> None:
        self._file.close()


class MetricsRegistry:
    """Fan one ``record(step, metrics)`` call out to the configured sinks.

    The JSONL sink requires ``log_dir`` and is skipped without one, so a
    console-only registry does no file IO.
    """

    def __init__(self, log_dir: Optional[str] = None, *,
                 sinks: Iterable[str] = ("console", "jsonl"),
                 jsonl_filename: str = "progress.jsonl", stream=None):
        self.log_dir = log_dir
        self._t0 = time.time()
        self.sinks: list = []
        sinks = tuple(sinks)
        unknown = set(sinks) - {"console", "jsonl"}
        if unknown:
            raise ValueError(f"unknown sinks {sorted(unknown)}")
        if "console" in sinks:
            self.sinks.append(ConsoleSink(stream))
        if log_dir and "jsonl" in sinks:
            os.makedirs(log_dir, exist_ok=True)
            self.sinks.append(JSONLSink(os.path.join(log_dir, jsonl_filename)))

    def record(self, step: int, metrics: dict) -> None:
        row = {"step": int(step),
               "wall_time": round(time.time() - self._t0, 2),
               **{k: _scalar(v) for k, v in metrics.items()}}
        for s in self.sinks:
            s.write(row)

    def close(self) -> None:
        for s in self.sinks:
            s.close()
