"""Observation/action spaces, port of ``repro/core/spaces.py`` (paper §6.1,
§6.5).

``Discrete`` and ``Box`` with their ``null_value`` (a numpy zero of one
example, which the samplers and the replay use to shape their buffers) and
``sample(generator, batch_shape)``, drawn on the generator's device, and
``Composite``, a named collection of sub-spaces whose samples and null
values are namedarraytuples.
"""
from __future__ import annotations

import numpy as np
import torch

from .narrtup import namedarraytuple


class Space:
    def sample(self, generator, batch_shape=()):
        raise NotImplementedError

    def null_value(self):
        raise NotImplementedError

    @property
    def shape(self):
        raise NotImplementedError


class Discrete(Space):
    def __init__(self, n: int, dtype=torch.int32):
        self.n = int(n)
        self.dtype = dtype

    @property
    def shape(self):
        return ()

    def sample(self, generator, batch_shape=()):
        return torch.randint(0, self.n, tuple(batch_shape), generator=generator,
                             device=generator.device, dtype=self.dtype)

    def null_value(self):
        return np.zeros((), dtype=np.int32)

    def __repr__(self):
        return f"Discrete({self.n})"


class Box(Space):
    def __init__(self, low, high, shape=None, dtype=torch.float32):
        low = np.asarray(low, dtype=np.float32)
        high = np.asarray(high, dtype=np.float32)
        if shape is not None:
            low = np.broadcast_to(low, shape)
            high = np.broadcast_to(high, shape)
        self.low, self.high = low, high
        self.dtype = dtype
        self._on = {}

    @property
    def shape(self):
        return self.low.shape

    def _bounds(self, device):
        """(low, high) as tensors on ``device``, made once per device so a
        sample makes no copy from the host (a CUDA graph refuses one)."""
        key = str(device)
        if key not in self._on:
            self._on[key] = (torch.tensor(self.low, device=device),
                             torch.tensor(self.high, device=device))
        return self._on[key]

    def sample(self, generator, batch_shape=()):
        dev = generator.device
        u = torch.rand(tuple(batch_shape) + self.shape, generator=generator,
                       device=dev, dtype=self.dtype)
        low, high = self._bounds(dev)
        return u * (high - low) + low

    def null_value(self):
        return np.zeros(self.shape, dtype=np.float32)

    def __repr__(self):
        return f"Box(shape={self.shape})"


class Composite(Space):
    """Named collection of sub-spaces; samples are namedarraytuples (each
    sub-space drawn from the one generator, in order)."""

    def __init__(self, typename: str, **subspaces):
        self._cls = namedarraytuple(typename, tuple(subspaces.keys()))
        self.subspaces = subspaces

    @property
    def shape(self):
        return {k: s.shape for k, s in self.subspaces.items()}

    def sample(self, generator, batch_shape=()):
        return self._cls(*(s.sample(generator, batch_shape)
                           for s in self.subspaces.values()))

    def null_value(self):
        return self._cls(*(s.null_value() for s in self.subspaces.values()))

    def __repr__(self):
        return f"Composite({list(self.subspaces)})"
