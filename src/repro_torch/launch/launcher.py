"""Launching utilities (paper §6.6): build experiment variants and
stack/queue them over fixed local resources.

Port of ``repro/launch/launcher.py``.  The paper's example: an
8-GPU/40-CPU box running 30 variants 2-GPUs-each, 4 at a time.  The
launcher runs up to ``capacity`` experiments concurrently, starting the
next as slots free, recording results in a per-variant directory tree that
mirrors the variant spec (paper: "results are recorded into a file
structure which matches that of the variants generated").  As in JAX's
launcher, a slot is a process, not a device: every job sees the same
devices (``JOB_INDEX`` and ``env_extra`` are in its environment for a
script that wants to choose).

Multi-node: ``emit_pod_script`` writes the per-node launch script that
joins ``torch.distributed`` (``MASTER_ADDR`` / ``MASTER_PORT`` from the
coordinator, ``WORLD_SIZE`` the node count, ``RANK`` the node index) and
runs ``repro_torch.launch.train.main`` on that group: the script sets
``REPRO_MESH`` to ``<nodes>x1`` unless the environment sets it, so
``train --mesh`` defaults to a data axis over the nodes, and ``train.main``
joins the initialized group (``run_mesh``) rather than spawning ranks.
"""
from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Sequence


def make_variants(base: Dict, **grids) -> List[Dict]:
    """Cartesian product of grid values over a base config dict."""
    keys = list(grids)
    out = []
    for combo in itertools.product(*(grids[k] for k in keys)):
        v = dict(base)
        v.update(dict(zip(keys, combo)))
        out.append(v)
    return out


def variant_name(variant: Dict, keys: Sequence[str]) -> str:
    return "_".join(f"{k}-{variant[k]}" for k in keys)


def launch_queue(commands: List[List[str]], *, capacity: int = 2,
                 log_dir: str = "runs", env_extra: Dict = None,
                 poll_s: float = 0.5) -> List[int]:
    """Run commands with at most ``capacity`` concurrent; returns exit codes.

    Each command i logs to {log_dir}/job_{i:03d}.log.  Slots are freed as
    jobs finish and the next queued job starts in its place (paper §6.6).
    """
    os.makedirs(log_dir, exist_ok=True)
    running: Dict[int, subprocess.Popen] = {}
    codes = [None] * len(commands)
    nxt = 0
    files = {}
    try:
        while nxt < len(commands) or running:
            while nxt < len(commands) and len(running) < capacity:
                log = open(os.path.join(log_dir, f"job_{nxt:03d}.log"), "w")
                files[nxt] = log
                env = dict(os.environ)
                env.update(env_extra or {})
                env["JOB_INDEX"] = str(nxt)
                running[nxt] = subprocess.Popen(commands[nxt], stdout=log,
                                                stderr=log, env=env)
                nxt += 1
            done = [i for i, p in running.items() if p.poll() is not None]
            for i in done:
                codes[i] = running[i].returncode
                files[i].close()
                del running[i], files[i]
            if running:
                time.sleep(poll_s)
    finally:  # an interrupted queue leaves no job behind
        for i, p in running.items():
            p.kill()
            p.wait()
            files[i].close()
    return codes


def run_variants(script: str, variants: List[Dict], vary_keys: Sequence[str],
                 *, capacity: int = 2, out_root: str = "runs",
                 python: str = sys.executable) -> List[int]:
    """Launch {python} -m {script} --key value ... per variant, queued."""
    cmds, names = [], []
    for v in variants:
        name = variant_name(v, vary_keys)
        vdir = os.path.join(out_root, name)
        os.makedirs(vdir, exist_ok=True)
        with open(os.path.join(vdir, "variant.json"), "w") as f:
            json.dump(v, f, indent=1)
        cmd = [python, "-m", script]
        for k, val in v.items():
            if isinstance(val, bool):
                if val:
                    cmd.append(f"--{k.replace('_', '-')}")
            else:
                cmd += [f"--{k.replace('_', '-')}", str(val)]
        cmd += ["--log-dir", vdir]
        cmds.append(cmd)
        names.append(name)
    print(f"queueing {len(cmds)} variants, capacity {capacity}:")
    for n in names:
        print("  ", n)
    return launch_queue(cmds, capacity=capacity, log_dir=out_root)


POD_SCRIPT = """#!/bin/bash
# Auto-generated per-node launch script ({n_pods} nodes, one rank each).
# Node index comes from the cluster scheduler; the coordinator is node 0.
set -e
export POD_INDEX=${{POD_INDEX:?set by scheduler}}
export COORDINATOR={coordinator}
export MASTER_ADDR=${{COORDINATOR%:*}}
export MASTER_PORT=${{COORDINATOR##*:}}
export WORLD_SIZE={n_pods}
export RANK=$POD_INDEX
export REPRO_MESH=${{REPRO_MESH:-{n_pods}x1}}
python -c "
import torch.distributed as dist
dist.init_process_group('nccl', init_method='env://')
from repro_torch.launch import train
train.main({train_args!r})
"
"""


def emit_pod_script(path: str, *, n_pods: int = 2,
                    coordinator: str = "pod0:8476",
                    train_args: List[str] = ()):
    with open(path, "w") as f:
        f.write(POD_SCRIPT.format(n_pods=n_pods, coordinator=coordinator,
                                  train_args=list(train_args)))
    os.chmod(path, 0o755)
    return path
