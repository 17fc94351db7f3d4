"""Batched serving (paper Fig 1 right, at LM scale): prefill + decode over
request batches, every ported backbone family selectable -- the port of
``examples/serve_decode.py``, a thin wrapper over
``repro_torch.launch.serve``.  With no arguments it serves the JAX
example's default: the smoke mixtral-8x7b (``--arch mixtral-8x7b``, the
smoke config: a mixture of 4 experts, top-2, a 16-key window), batch 8,
prompt 64, gen 32, on the card (``--device cuda``, serve's default).  Any
argument replaces that default argv, as in the JAX example.

  PYTHONPATH=src python -m repro_torch.examples.serve_decode
  PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
      --arch qwen2-moe-a2.7b --gen 64 --device cpu
"""
from __future__ import annotations

import sys

from ..launch import serve

DEFAULTS = ["--arch", "mixtral-8x7b", "--batch", "8", "--prompt-len", "64",
            "--gen", "32"]


def main(argv=None):
    """Serve with ``argv`` (default the command line), or with the
    example's default argv when it is empty; returns what ``serve.main``
    returns (the last round's tokens)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    return serve.main(argv or DEFAULTS)


if __name__ == "__main__":
    main()
