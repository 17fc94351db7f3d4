"""Metric sinks behind one registry.

The PyTorch port of ``repro/telemetry/metrics.py``, cut to the sinks the
serving and training entry points use: ``console`` (the aligned key/value
table), ``csv`` (a header that grows with the field set) and ``jsonl`` (one
JSON object per row, the machine-readable feed).  The TensorBoard sink is
not ported.
"""
from __future__ import annotations

import csv
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


class CSVSink(Sink):
    """CSV with a header that grows with the field set.

    On open, an existing file's header is adopted (restart-append).  When a
    row introduces new fields, the whole file is rewritten once with the
    union header and old rows padded empty — columns never misalign and keys
    are never silently dropped.
    """

    def __init__(self, path: str):
        self.path = path
        self._fields: Optional[list] = None
        if os.path.exists(path) and os.path.getsize(path) > 0:
            with open(path, newline="") as f:
                header = next(csv.reader(f), None)
            if header:
                self._fields = list(header)

    def write(self, row: dict) -> None:
        if self._fields is None:
            self._fields = list(row)
            with open(self.path, "a", newline="") as f:
                csv.writer(f).writerow(self._fields)
        new = [k for k in row if k not in self._fields]
        if new:
            self._rewrite_with(self._fields + new)
        with open(self.path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self._fields,
                           restval="").writerow(row)

    def _rewrite_with(self, fields: list) -> None:
        rows: list = []
        if os.path.exists(self.path) and os.path.getsize(self.path) > 0:
            with open(self.path, newline="") as f:
                rows = list(csv.DictReader(f))
        tmp = self.path + ".tmp"
        with open(tmp, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields, restval="")
            w.writeheader()
            for r in rows:
                r.pop(None, None)  # stray cells from a shrunken header
                w.writerow(r)
        os.replace(tmp, self.path)
        self._fields = fields


class MetricsRegistry:
    """Fan one ``record(step, metrics)`` call out to the configured sinks.

    The file sinks (CSV, JSONL) require ``log_dir`` and are skipped without
    one, so a console-only registry does no file IO.
    """

    def __init__(self, log_dir: Optional[str] = None, *,
                 sinks: Iterable[str] = ("console", "jsonl"),
                 csv_filename: str = "progress.csv",
                 jsonl_filename: str = "progress.jsonl", stream=None):
        self.log_dir = log_dir
        self._t0 = time.time()
        self.sinks: list = []
        sinks = tuple(sinks)
        unknown = set(sinks) - {"console", "csv", "jsonl"}
        if unknown:
            raise ValueError(f"unknown sinks {sorted(unknown)}")
        if "console" in sinks:
            self.sinks.append(ConsoleSink(stream))
        if log_dir and ("csv" in sinks or "jsonl" in sinks):
            os.makedirs(log_dir, exist_ok=True)
        if log_dir and "csv" in sinks:
            self.sinks.append(CSVSink(os.path.join(log_dir, csv_filename)))
        if log_dir and "jsonl" in sinks:
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
