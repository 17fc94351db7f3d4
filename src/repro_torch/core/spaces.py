"""Observation/action spaces, port of ``repro/core/spaces.py``.

Only ``Discrete``'s size, dtype and shape are ported so far (what the token
environment uses); sampling, ``Box`` and the namedarraytuple-backed
``Composite`` follow with the RL slice.
"""
from __future__ import annotations

import torch


class Discrete:
    def __init__(self, n: int, dtype=torch.int32):
        self.n = int(n)
        self.dtype = dtype

    @property
    def shape(self):
        return ()

    def __repr__(self):
        return f"Discrete({self.n})"
