#!/usr/bin/env python3
"""Run some phases of ``chip_smoke.py`` alone on one H100, with the
kernels they need built first:

    python3 tools/chip_phases.py PHASE [PHASE ...]

PHASE is ``ssd_f64`` (phase 3's check of the full-width SSD instances
against an f64 oracle, ``ssd_f64_check``), ``lm_mesh`` (phase 11c, the
LM mesh's data axis on two gloo ranks sharing the card,
``lm_mesh_phase``), ``lm_tp`` (phase 11d, the 'model' axis on gloo ranks
sharing the card, ``lm_tp_phase``) or ``lm_tp4`` (the four-card proof:
qwen2-moe-a2.7b at full width and depth on 1 x 4 and gemma2-2b on 2 x 2
--compress, NCCL ranks a card each, ``lm_tp4_phase``; raises unless the
machine has 4 cards), ``nccl_capture`` (phase 11e, NCCL collectives
captured in a CUDA graph by one rank, ``capture_phase``) or ``mesh4``
(the fused mesh's four-card proof, ``mesh4_phase``: ``TrainLoop(mesh=,
fuse=True)`` fused against unfused for A2C, PPO and prioritized DQN, a
restore and the Catch bar; ``train --mesh`` with the graphed model-axis
rollout for mamba2-1.3b and qwen2-moe-a2.7b on 1 x 4 at full depth and
gemma2-2b on 2 x 2 --compress; NCCL ranks a card each; raises unless the
machine has 4 cards).  Prints each phase's lines as ``chip_smoke.py`` does
and the wall of each; exits non-zero where a check fails.

    python3 tools/chip_phases.py lm_tp        # one card
    python3 tools/chip_phases.py nccl_capture # one card
    python3 tools/chip_phases.py lm_tp4       # a machine with four cards
    python3 tools/chip_phases.py mesh4        # a machine with four cards
"""
import sys
import time
from pathlib import Path

PHASES = {"ssd_f64": (["ssd_scan"], "ssd_f64_check"),
          "lm_mesh": (None, "lm_mesh_phase"),
          "lm_tp": (None, "lm_tp_phase"),
          "lm_tp4": (["flash_attention"], "lm_tp4_phase"),
          "nccl_capture": ([], "capture_phase"),
          "mesh4": (None, "mesh4_phase")}

if __name__ == "__main__":
    names = sys.argv[1:]
    unknown = [n for n in names if n not in PHASES]
    if not names or unknown:
        sys.exit(f"usage: chip_phases.py PHASE [PHASE ...] with PHASE in "
                 f"{sorted(PHASES)} (unknown: {unknown})")
    sys.argv = sys.argv[:1]
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs  # noqa: E402  (spawned ranks import it too)
    print(cs.smi())
    sources = set()
    for n in names:
        srcs = PHASES[n][0]
        sources.update(srcs if srcs is not None else cs.build.SOURCES)
    t0 = time.perf_counter()
    cs.build.build(sorted(sources))
    print(f"build {time.perf_counter() - t0:.1f} s")
    for n in names:
        t0 = time.perf_counter()
        out = getattr(cs, PHASES[n][1])()
        print(f"{n}: {time.perf_counter() - t0:.1f} s; returned {out}")
