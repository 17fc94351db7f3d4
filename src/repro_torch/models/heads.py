"""Heads attached to a trunk's hidden states, port of
``repro/models/heads.py`` (paper §6.1 'Model' outputs): DQN, policy-gradient
and continuous-control (DDPG / TD3 / SAC) heads.

Pure functions over small param dicts of tensors — ``{"w": (d_in, d_out),
"b": (d_out,)}`` per linear layer, the JAX layout — so the JAX parameter
pytrees carry over leaf for leaf (``models/convert.py``).
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def dense_init(shape, in_axis_size: int, generator):
    """N(0, 1/in_axis_size) f32 on the generator's device: the scale of the
    JAX ``_dense_init``."""
    w = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=F32)
    return w.mul_(1.0 / math.sqrt(max(in_axis_size, 1)))


def init_linear(generator, d_in, d_out):
    return {"w": dense_init((d_in, d_out), d_in, generator),
            "b": torch.zeros((d_out,), dtype=F32, device=generator.device)}


def linear(p, x):
    return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


# ---------------------------------------------------------------------------
# DQN heads
# ---------------------------------------------------------------------------

def init_q_head(generator, d_in, n_actions, *, dueling=False, n_atoms=0):
    out = n_actions * max(n_atoms, 1)
    p = {"adv": init_linear(generator, d_in, out)}
    if dueling:
        p["val"] = init_linear(generator, d_in, max(n_atoms, 1))
    return p


def q_head(p, h, n_actions, *, dueling=False, n_atoms=0):
    """h: (..., d) -> q (..., A) or logits (..., A, atoms) (categorical)."""
    a = linear(p["adv"], h)
    if n_atoms:
        a = a.reshape(a.shape[:-1] + (n_actions, n_atoms))
    if dueling:
        v = linear(p["val"], h)
        if n_atoms:
            v = v[..., None, :]
            a = a - torch.mean(a, dim=-2, keepdim=True)
        else:
            a = a - torch.mean(a, dim=-1, keepdim=True)
        return v + a
    return a


# ---------------------------------------------------------------------------
# Policy-gradient heads
# ---------------------------------------------------------------------------

def init_pg_head(generator, d_in, n_actions):
    return {"pi": init_linear(generator, d_in, n_actions),
            "v": init_linear(generator, d_in, 1)}


def pg_head(p, h):
    """h: (..., d) -> (policy logits (..., A), value (...,) in f32)."""
    return linear(p["pi"], h), linear(p["v"], h.to(F32))[..., 0]


# ---------------------------------------------------------------------------
# Continuous-control heads (DDPG / TD3 / SAC)
# ---------------------------------------------------------------------------

def init_mu_head(generator, d_in, act_dim):
    return {"mu": init_linear(generator, d_in, act_dim)}


def mu_head(p, h):
    return torch.tanh(linear(p["mu"], h))


def init_gaussian_head(generator, d_in, act_dim):
    return {"mean": init_linear(generator, d_in, act_dim),
            "log_std": init_linear(generator, d_in, act_dim)}


def gaussian_head(p, h, log_std_min=-20.0, log_std_max=2.0):
    mean = linear(p["mean"], h)
    log_std = torch.clamp(linear(p["log_std"], h), log_std_min, log_std_max)
    return mean, log_std
