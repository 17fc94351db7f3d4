"""Finding a cell, its configuration, its traffic and its metric readers.

Everything a cell needs is found by name from ``BENCHMARK.json``:

- the configuration ``configs/<config>.json`` (its ``model`` group holds the
  program's ``ModelConfig`` fields as run);
- the traffic mix ``traffic/<traffic>.json`` (its ``kind`` names the module
  that runs it, its other keys are the generator's parameters);
- each per-layer metric's reader ``metrics/<metric>.py``, a module with
  ``read(rec)`` that returns a number or None.

Adding a configuration, a mix, a metric or a cell adds files and entries;
nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]          # portbench/
ROOT = HERE.parent                                  # the checkout


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    return json.loads(path.read_text())


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    names = ", ".join(c["name"] for c in bench["workloads"])
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({names})")


def config_entry(bench: dict, name: str) -> dict:
    for cfg in bench["configs"]:
        if cfg["name"] == name:
            return cfg
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration file of ``name``, as ``BENCHMARK.json`` names it."""
    return json.loads((root / config_entry(bench, name)["file"]).read_text())


def load_traffic(name: str) -> dict:
    path = HERE / "traffic" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"traffic mix {name!r}: {path} not found")
    return json.loads(path.read_text())


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports: the end-to-end ones
    with ``trace`` off, the per-layer ones with it on.  An entry with a
    ``workloads`` key applies to the cells it lists; one without, to every
    cell that reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    have = {m["name"] for m in e2e}

    def applies(m):
        return cell in m["workloads"] if "workloads" in m \
            else m["moves"] in have

    return [m for m in bench["per_layer"] if applies(m)]


def load_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"metric {name!r}: no reader {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
