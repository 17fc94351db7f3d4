"""Each cell end to end on the CPU at smoke size, in a process of its own:
the result line's schema, and that neither JAX nor the JAX package
(``repro``, compared by whole top-level name) was loaded.  Then the entry
point's refusals: no result without a card, none from a directory that
holds the benchmark's files alone."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

# the smoke sizes a cell runs at on the CPU (its configuration's widths and
# its mix's sizes cut down; what the cell exercises kept)
SMOKE = {
    "mamba2-1.3b.ppo": (
        {"n_layers": 2, "d_model": 64, "vocab": 256, "d_state": 16,
         "ssm_headdim": 16, "ssd_chunk": 8},
        {"batch": 4, "horizon": 16}),
    "zamba2-7b.batchgen": (
        {"n_layers": 5, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
         "d_head": 16, "d_ff": 128, "vocab": 256, "d_state": 16,
         "ssm_headdim": 16, "ssd_chunk": 8, "attn_every": 2,
         "attn_chunk_q": 16},
        {"slots": 4, "queue_per_s": 40, "max_context": 64,
         "prompt_len": {"dist": "uniform", "lo": 16, "hi": 24},
         "output_len": {"dist": "log_uniform", "lo": 8, "hi": 32},
         "buckets": [16], "trace_blocks": 3}),
}

SCRIPT = """
import json, sys, time
t = time.perf_counter()
import torch
torch.set_num_threads(1)
sys.path[:0] = [{here!r}, {src!r}]
import run
run.prepare_env()
from bench import harness, spec
bench = spec.load_benchmark()
cell = spec.find_cell(bench, {cell!r})
res = harness.run_cell(bench, cell, {seed}, 0.5, {trace}, "cpu", t,
                       model_overrides={model!r}, mix_overrides={mix!r})
print(json.dumps({{"result": res, "forbidden": run.forbidden_modules()}}))
"""


def smoke_run(cell, trace, seed=2**31 + 5):
    model, mix = SMOKE[cell]
    code = SCRIPT.format(here=str(HERE), src=str(ROOT / "src"), cell=cell,
                         seed=seed, trace=trace, model=model, mix=mix)
    # one thread: small ops on many threads crawl beside other workers
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def units(names):
    by = {m["name"]: m["unit"]
          for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    return {n: by[n] for n in names}


@pytest.mark.parametrize("cell,trace", [(c, t) for c in SMOKE
                                        for t in (0, 1)])
def test_cell_runs_end_to_end_on_the_cpu(cell, trace):
    got = smoke_run(cell, trace)
    assert got["forbidden"] == []
    res = got["result"]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    for name, m in res["metrics"].items():
        assert m["unit"] == units([name])[name]
        assert isinstance(m["value"], float)
    wanted = [m["name"] for m in (BENCH["per_layer"] if trace
                                  else BENCH["end_to_end"])
              if cell in m.get("workloads", [cell])]
    if trace:
        # the CPU has no device trace: the readers of one return nothing
        assert set(res["metrics"]) <= set(wanted)
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == set(wanted)
    dev = res["device"]
    assert dev["count"] == 1 and dev["memory_peak_bytes"] == 0
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


def test_no_result_without_a_card(tmp_path):
    cmd = BENCH["command"] + ["--workload", "mamba2-1.3b.ppo", "--seed",
                              "7", "--seconds", "1", "--trace", "0"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                         cwd=ROOT, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    # a directory with BENCHMARK.json and the benchmark's files alone
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for p in BENCH["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                         cwd=tmp_path, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, str(HERE))
    import run
    assert run.forbidden_modules(["repro_torch", "repro_torch.models",
                                  "jaxtyping", "reproducible"]) == []
    assert run.forbidden_modules(["repro.models", "jax", "jaxlib.xla",
                                  "flax"]) == ["flax", "jax", "jaxlib.xla",
                                               "repro.models"]
