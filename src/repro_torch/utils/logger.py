"""Tabular logger, port of ``repro/utils/logger.py``: a preset over the
telemetry ``MetricsRegistry`` — the aligned console table, a CSV file whose
header grows with the field set, and a JSONL twin of every row."""
from __future__ import annotations

from typing import Iterable, Optional

from ..telemetry.metrics import MetricsRegistry


class Logger(MetricsRegistry):
    def __init__(self, log_dir: Optional[str] = None,
                 filename: str = "progress.csv", stream=None,
                 sinks: Iterable[str] = ("console", "csv", "jsonl")):
        super().__init__(log_dir, sinks=sinks, csv_filename=filename,
                         stream=stream)
