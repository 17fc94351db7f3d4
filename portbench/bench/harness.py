"""One run of one cell: find its files, run its module, read its metrics,
and assemble the result line.

The module that runs a cell is chosen by the traffic mix's ``kind``: ``lm_ppo``
(``bench/ppo.py``) or ``batch_generation`` (``bench/batchgen.py``).  With
``trace`` off the result holds the cell's end-to-end metrics, which the
module measures itself; with it on, the per-layer metrics, each from its
reader in ``metrics/``, and the device's busy time, the traced window and
the breakdown.  ``checks`` comes last: each number that decided
``correct`` with its limit.
"""
from __future__ import annotations

import importlib
import subprocess
import types

import torch

from reference import compare

from . import arith, spec

RUNNERS = {"lm_ppo": "bench.ppo", "batch_generation": "bench.batchgen"}


def card(device) -> dict:
    """The card's name and power limit (nvidia-smi), beside every rate."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": "not measured"}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    name, _, limit = out.partition(",")
    return {"name": name.strip() or torch.cuda.get_device_name(device),
            "power_limit": limit.strip() or "not read"}


def context(bench, cell, seed, seconds, trace, device, t_process,
            model_overrides=None, mix_overrides=None):
    model = dict(spec.load_config(bench, cell["config"])["model"],
                 **(model_overrides or {}))
    mix = dict(spec.load_traffic(cell["traffic"]), **(mix_overrides or {}))
    return types.SimpleNamespace(
        cell=cell, model=model, mix=mix, seed=int(seed),
        seconds=float(seconds), trace=bool(trace),
        device=torch.device(device), t_process=t_process,
        limits=compare.load_limits(cell["name"]),
        token_params=arith.token_params(model))


def run_cell(bench, cell, seed, seconds, trace, device, t_process, **kw):
    ctx = context(bench, cell, seed, seconds, trace, device, t_process, **kw)
    runner = importlib.import_module(RUNNERS[ctx.mix["kind"]])
    runner.note(ctx, "imported")
    out = runner.run(ctx)
    rec = dict(out["rec"], cfg=ctx.model, mix=ctx.mix)
    metrics = {}
    for m in spec.metrics_for(bench, cell["name"], ctx.trace):
        if not ctx.trace:
            val = out["e2e"][m["name"]]
        else:
            val = spec.load_reader(m["name"])(rec)
        if val is not None:
            metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    dev = ctx.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev)
              if dev.type == "cuda" else "cpu",
              "count": 1,
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(out["correct"]),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"]),
              "metrics": metrics, "device": device}
    tr, win = rec.get("trace"), out.get("trace_window")
    if ctx.trace and tr is not None and win is not None:
        lo, hi = win
        device["busy_s"] = tr.busy(lo, hi)
        device["window_s"] = hi - lo
        result["breakdown"] = tr.breakdown(lo, hi)
    result["card"] = card(dev)
    result["checks"] = out["checks"]
    return result
