"""The port's variant launcher (``repro_torch/launch/launcher.py``, paper
§6.6) against the JAX package's ``repro/launch/launcher.py``, on the CPU.

Exact throughout: variant grids, names, commands and ``variant.json`` are
equal to JAX's (the commands with only the module name swapped); the queue
holds its capacity, returns every job's exit code in order and sets
``JOB_INDEX`` / ``env_extra``; the per-node script passes ``bash -n`` and
its Python part compiles and names no JAX.
"""
import json
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.launch import launcher as jl  # noqa: E402
from repro_torch.launch import launcher as tl  # noqa: E402

GRIDS = [
    ({"arch": "gemma2-2b", "steps": 2}, {"lr": [1e-4, 3e-4], "seed": [0, 1]}),
    ({"smoke": True, "batch": 4}, {"restore": [True, False]}),
    ({}, {"fuse_window": [1, 2, 4]}),
    ({"arch": "mamba2-1.3b", "full": False}, {"layers": [2], "lr": [3e-4]}),
]


@pytest.mark.parametrize("base,grids", GRIDS)
def test_variants_and_names_match_jax(base, grids):
    got = tl.make_variants(base, **grids)
    want = jl.make_variants(base, **grids)
    assert got == want
    keys = list(grids)
    assert [tl.variant_name(v, keys) for v in got] == \
        [jl.variant_name(v, keys) for v in want]


@pytest.mark.parametrize("base,grids", GRIDS)
def test_run_variants_builds_jax_commands(base, grids, tmp_path,
                                          monkeypatch):
    seen = {}

    def fake_queue(tag):
        def queue(cmds, *, capacity, log_dir, **kw):
            seen[tag] = (cmds, capacity, log_dir)
            return [0] * len(cmds)
        return queue

    monkeypatch.setattr(jl, "launch_queue", fake_queue("jax"))
    monkeypatch.setattr(tl, "launch_queue", fake_queue("port"))
    variants = tl.make_variants(base, **grids)
    keys = list(grids)
    codes = {}
    for tag, mod, script in (("jax", jl, "repro.launch.train"),
                             ("port", tl, "repro_torch.launch.train")):
        root = tmp_path / tag
        codes[tag] = mod.run_variants(script, variants, keys, capacity=3,
                                      out_root=str(root), python="py")
    assert codes["jax"] == codes["port"] == [0] * len(variants)
    (jcmds, jcap, jlog), (tcmds, tcap, tlog) = seen["jax"], seen["port"]
    assert (jcap, tcap) == (3, 3)
    assert len(jcmds) == len(tcmds) == len(variants)
    for jc, tc in zip(jcmds, tcmds):
        assert tc[:3] == ["py", "-m", "repro_torch.launch.train"]
        assert jc[:3] == ["py", "-m", "repro.launch.train"]
        # the same flags, with the variant's directory under each root
        assert [a.replace(tlog, "ROOT") for a in tc[3:]] == \
            [a.replace(jlog, "ROOT") for a in jc[3:]]
        assert tc[-2] == "--log-dir"
    for v in variants:
        name = tl.variant_name(v, keys)
        got = (tmp_path / "port" / name / "variant.json").read_text()
        want = (tmp_path / "jax" / name / "variant.json").read_text()
        assert got == want and json.loads(got) == v


STAMP = """\
import os, sys, time
d = sys.argv[1]
i = os.environ["JOB_INDEX"]
open(os.path.join(d, f"start_{i}"), "w").write(repr(time.time()))
time.sleep(0.4)
open(os.path.join(d, f"env_{i}"), "w").write(os.environ.get("EXTRA", ""))
open(os.path.join(d, f"end_{i}"), "w").write(repr(time.time()))
sys.exit(3 if i == "2" else 0)
"""


def test_launch_queue_holds_capacity_and_codes(tmp_path):
    stamps = tmp_path / "stamps"
    stamps.mkdir()
    script = tmp_path / "stamp.py"
    script.write_text(STAMP)
    n = 5
    cmds = [[sys.executable, str(script), str(stamps)] for _ in range(n)]
    codes = tl.launch_queue(cmds, capacity=2, log_dir=str(tmp_path / "logs"),
                            env_extra={"EXTRA": "x1"}, poll_s=0.05)
    assert codes == [0, 0, 3, 0, 0]
    spans = [(float((stamps / f"start_{i}").read_text()),
              float((stamps / f"end_{i}").read_text())) for i in range(n)]
    # at most two jobs alive at any start
    for s, _ in spans:
        assert sum(a <= s < b for a, b in spans) <= 2
    # and two did overlap: the queue ran jobs side by side
    assert any(a < s < b for s, _ in spans for a, b in spans)
    for i in range(n):
        assert (stamps / f"env_{i}").read_text() == "x1"
        assert (tmp_path / "logs" / f"job_{i:03d}.log").exists()


def test_emit_pod_script_is_valid_bash_without_jax(tmp_path):
    path = tl.emit_pod_script(str(tmp_path / "pod.sh"), n_pods=4,
                              coordinator="node0:29500",
                              train_args=["--arch", "gemma2-2b", "--full"])
    assert os.access(path, os.X_OK)
    r = subprocess.run(["bash", "-n", path], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    text = open(path).read()
    body = re.search(r'python -c "\n(.*)\n"\n', text, re.S).group(1)
    compile(body, "pod.py", "exec")
    assert "jax" not in text
    assert "init_process_group('nccl'" in body
    assert "train.main(['--arch', 'gemma2-2b', '--full'])" in body
    for line in ("export WORLD_SIZE=4", "export RANK=$POD_INDEX",
                 "export COORDINATOR=node0:29500"):
        assert line in text
    # the environment the script derives from its coordinator
    r = subprocess.run(
        ["bash", "-c", text.split("python -c")[0]
         + 'echo "$MASTER_ADDR $MASTER_PORT $WORLD_SIZE $RANK"'],
        env={**os.environ, "POD_INDEX": "3"}, capture_output=True, text=True)
    assert r.stdout.split() == ["node0", "29500", "4", "3"], r.stderr
