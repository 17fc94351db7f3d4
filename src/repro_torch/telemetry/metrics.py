"""Metric sinks behind one registry.

The PyTorch port of ``repro/telemetry/metrics.py``: ``console`` (the
aligned key/value table), ``csv`` (a header that grows with the field set),
``jsonl`` (one JSON object per row, the machine-readable feed) and ``tb``
(TensorBoard scalars written as genuine tfevents records: a hand-written
Event protobuf in TFRecord framing with masked CRC-32C, so no tensorboard
or protobuf package is needed; byte for byte the records JAX's sink writes).
"""
from __future__ import annotations

import csv
import json
import os
import socket
import struct
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


# -- TensorBoard event-file sink (no tensorboard/protobuf dependency) --------

def _crc_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_CRC_TABLE = _crc_table()


def _crc32c(data: bytes) -> int:
    """Software CRC-32C (Castagnoli), table-driven."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _tb_record(payload: bytes) -> bytes:
    """TFRecord framing: len, masked_crc(len), payload, masked_crc(payload)."""
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header)) + payload
            + struct.pack("<I", _masked_crc(payload)))


def _tb_event(wall_time: float, step: int, scalars: dict) -> bytes:
    """Event{wall_time=1, step=2, summary=5{value=1{tag=1, simple_value=2}}}."""
    values = b""
    for tag, val in scalars.items():
        t = tag.encode()
        v = (b"\x0a" + _varint(len(t)) + t           # Value.tag
             + b"\x15" + struct.pack("<f", val))     # Value.simple_value
        values += b"\x0a" + _varint(len(v)) + v      # Summary.value
    return (b"\x09" + struct.pack("<d", wall_time)   # Event.wall_time
            + b"\x10" + _varint(step)                # Event.step
            + b"\x2a" + _varint(len(values)) + values)  # Event.summary


class TBSink(Sink):
    """Scalar summaries in genuine tfevents format (loadable by TensorBoard
    and anything else that reads TFRecord'd Event protos)."""

    def __init__(self, log_dir: str):
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._file = open(os.path.join(log_dir, name), "ab")
        version = b"\x1a" + _varint(len(b"brain.Event:2")) + b"brain.Event:2"
        self._file.write(_tb_record(
            b"\x09" + struct.pack("<d", time.time()) + version))
        self._file.flush()

    def write(self, row: dict) -> None:
        step = int(row.get("step", 0))
        scalars = {k: float(v) for k, v in row.items()
                   if isinstance(v, (int, float)) and k != "step"}
        self._file.write(_tb_record(_tb_event(time.time(), step, scalars)))
        self._file.flush()

    def close(self) -> None:
        self._file.close()


class MetricsRegistry:
    """Fan one ``record(step, metrics)`` call out to the configured sinks.

    The file sinks (CSV, JSONL, TensorBoard) require ``log_dir`` and are
    skipped without one, so a console-only registry does no file IO.
    """

    def __init__(self, log_dir: Optional[str] = None, *,
                 sinks: Iterable[str] = ("console", "jsonl"),
                 csv_filename: str = "progress.csv",
                 jsonl_filename: str = "progress.jsonl", stream=None):
        self.log_dir = log_dir
        self._t0 = time.time()
        self.sinks: list = []
        sinks = tuple(sinks)
        unknown = set(sinks) - {"console", "csv", "jsonl", "tb"}
        if unknown:
            raise ValueError(f"unknown sinks {sorted(unknown)}")
        if "console" in sinks:
            self.sinks.append(ConsoleSink(stream))
        if log_dir and {"csv", "jsonl", "tb"} & set(sinks):
            os.makedirs(log_dir, exist_ok=True)
        if log_dir and "csv" in sinks:
            self.sinks.append(CSVSink(os.path.join(log_dir, csv_filename)))
        if log_dir and "jsonl" in sinks:
            self.sinks.append(JSONLSink(os.path.join(log_dir, jsonl_filename)))
        if log_dir and "tb" in sinks:
            self.sinks.append(TBSink(log_dir))

    def record(self, step: int, metrics: dict) -> None:
        row = {"step": int(step),
               "wall_time": round(time.time() - self._t0, 2),
               **{k: _scalar(v) for k, v in metrics.items()}}
        for s in self.sinks:
            s.write(row)

    def close(self) -> None:
        for s in self.sinks:
            s.close()
