"""End-to-end LM-policy RL: PPO over the token MDP where batched action
selection IS LM decoding — the port of ``examples/lm_ppo_end2end.py``, a
thin wrapper over ``repro_torch.launch.train`` with the JAX example's
settings: the 4-layer smoke gemma2 (``--arch gemma2-2b``, the smoke
config), 150 steps, batch 32, horizon 32, lr 1e-3.  Any flag of
``launch.train`` given on the command line overrides them.

It runs on the card (``--device cuda``, train's default; the smoke
gemma2's attention at d_head 16 has its kernel instances), or with
``--device cpu`` on the plain versions; ``--full`` trains the full-width
model.

  PYTHONPATH=src python -m repro_torch.examples.lm_ppo_end2end --device cpu
  PYTHONPATH=src python -m repro_torch.examples.lm_ppo_end2end \\
      --arch mamba2-1.3b --device cpu --steps 60
"""
from __future__ import annotations

import sys

from ..launch import train

DEFAULTS = ["--arch", "gemma2-2b", "--steps", "150", "--batch", "32",
            "--horizon", "32", "--lr", "1e-3"]


def main(argv=None):
    """Train with the example's settings, ``argv`` (default the command
    line) overriding any of them; returns the trained ``LM``."""
    argv = sys.argv[1:] if argv is None else argv
    return train.main(DEFAULTS + list(argv))


if __name__ == "__main__":
    main()
