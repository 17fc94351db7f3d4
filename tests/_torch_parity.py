"""Shared helpers for the JAX <-> PyTorch-port parity tests: numpy goes in,
both sides compute, numpy comes out.  Imported only by tests/test_torch_*.py
(after their ``pytest.importorskip("torch")``)."""
import dataclasses

import jax
import numpy as np
import torch

from repro.models.config import ModelConfig as JaxConfig
from repro_torch.models.config import ModelConfig as TorchConfig
from repro_torch.models.convert import params_from_jax


def torch_cfg(jax_cfg: JaxConfig) -> TorchConfig:
    """The port's ModelConfig with every field of the JAX one."""
    return TorchConfig(**dataclasses.asdict(jax_cfg))


def to_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def port_lm(jax_params, jax_cfg: JaxConfig, dtype=torch.float32,
            requires_grad: bool = False):
    """The port's LM holding the JAX ``init_lm`` params, on the CPU."""
    return params_from_jax(to_numpy(jax_params), torch_cfg(jax_cfg),
                           device="cpu", dtype=dtype,
                           requires_grad=requires_grad)


def t2n(x) -> np.ndarray:
    return x.detach().float().cpu().numpy().copy()


def j2n(x) -> np.ndarray:
    return np.asarray(x, np.float32)
