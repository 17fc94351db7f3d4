#!/usr/bin/env python3
"""Time one checkout's sum-tree sampling kernel on one H100, the way
``chip_smoke.py`` times it (its ``st_times`` and ``st_profile``), so that
two versions of the kernel can be compared on one card in one run:

    python3 tools/time_sum_tree.py [SRC]

SRC is the ``src`` directory whose ``repro_torch`` is built and timed
(default: this checkout's), e.g. an older commit unpacked with
``git archive`` into a git-ignored directory.  Prints one line a shape,
then one JSON line of the times (ms) and the profiler's us a launch.
"""
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SRC = Path(sys.argv[1] if len(sys.argv) > 1 else REPO / "src").resolve()
sys.path.insert(0, str(SRC))
import repro_torch  # noqa: E402  (bound first: chip_smoke puts REPO/src ahead)

sys.path.insert(0, str(REPO))
import chip_smoke as cs  # noqa: E402

if Path(cs.st_ops.__file__).resolve().parents[3] != SRC:
    cs.fail(f"repro_torch came from {cs.st_ops.__file__}, not {SRC}")
print(cs.smi())
print(f"sum-tree kernel of {Path(repro_torch.__file__).parent}")
timing = cs.st_times()
dev_us = cs.st_profile()
print(json.dumps({"sum_tree_timing": [
    {"leaves": size, "batch": batch, "device": cs.torch.cuda.get_device_name(0),
     **{k: v for k, v in t.items() if k != "bound"},
     "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
     "profiler_us": dev_us.get((size, batch))}
    for (size, batch), t in timing.items()]}))
