"""Shared helpers for the JAX <-> PyTorch-port parity tests: numpy goes in,
both sides compute, numpy comes out.  Imported only by tests/test_torch_*.py
(after their ``pytest.importorskip("torch")``)."""
import dataclasses
from contextlib import contextmanager

import jax
import jax.numpy as jnp
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


def jax_moe_routing(p, x, cfg, groups=1, no_drop=False, capacity_factor=None):
    """The routing of JAX's ``repro.models.layers.moe`` (its first half,
    in jnp): the chosen experts and the kept mask, each (B, T, K)."""
    B, T, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    G = groups if (B * T) % groups == 0 else 1
    S_g = B * T // G
    cf = capacity_factor if capacity_factor is not None else \
        cfg.capacity_factor
    C = min(max(int(np.ceil(S_g * K / E * cf)), 1), S_g * K)
    if no_drop:
        C = S_g * K
    logits = jnp.einsum("gsd,de->gse", x.reshape(G, S_g, -1),
                        p["router"].astype(x.dtype)).astype(jnp.float32)
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    onehot = jax.nn.one_hot(top_e, E, dtype=jnp.int32)
    ordered = onehot.transpose(0, 2, 1, 3).reshape(G, K * S_g, E)
    pos = jnp.sum((jnp.cumsum(ordered, axis=1) - 1) * ordered, axis=-1)
    keep = pos.reshape(G, K, S_g).transpose(0, 2, 1) < C
    return top_e.reshape(B, T, K), keep.reshape(B, T, K)


@contextmanager
def jax_routing_probe():
    """Within the block, every call of the JAX backbones' ``moe`` (jitted or
    not) appends its (experts, kept) routing, as numpy, to the yielded list
    -- the counterpart of the port's ``layers.record_routing``."""
    from repro.models import backbones as jbb

    calls = []
    orig = jbb.moe

    def probed(params, x, cfg, groups=1, no_drop=False, capacity_factor=None):
        e, keep = jax_moe_routing(params, x, cfg, groups, no_drop,
                                  capacity_factor)
        jax.debug.callback(
            lambda a, b: calls.append((np.asarray(a), np.asarray(b))),
            e, keep)
        return orig(params, x, cfg, groups=groups, no_drop=no_drop,
                    capacity_factor=capacity_factor)

    jbb.moe = probed
    try:
        yield calls
    finally:
        jbb.moe = orig


def routing_agrees(got, want) -> np.ndarray:
    """(B,) bool: the rows whose experts and kept mask agree in every moe
    call of two routing records (``record_routing`` / ``jax_routing_probe``,
    the same calls in the same order)."""
    assert len(got) == len(want) > 0
    agree = None
    for (ge, gk), (we, wk) in zip(got, want):
        ge, gk = np.asarray(ge), np.asarray(gk)
        row = ((ge == we) & (gk == wk)).reshape(ge.shape[0], -1).all(-1)
        agree = row if agree is None else agree & row
    return agree
