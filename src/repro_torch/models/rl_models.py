"""Small RL models, port of the feed-forward part of
``repro/models/rl_models.py``: an MLP trunk (state observations) and a conv
trunk (vision), each under a policy/value head or a Q head with optional
dueling and C51 atoms, and the continuous-control actors and twin Q critic
of DDPG / TD3 / SAC — the paper's original model scale.

Models are built by *factories* that close over static config and return
``Model(init, apply)``: ``init(generator)`` draws a params pytree (nested
dicts and lists of f32 tensors, the JAX pytree's layout) on the generator's
device, and ``apply(params, observation, prev_action=None,
prev_reward=None)`` follows the leading-dims protocol (paper §6.4): [], [B]
or [T, B] leading dims.

The conv trunk keeps the JAX layouts at its interface — NHWC observations,
HWIO kernels — and permutes to NCHW / OIHW for ``F.conv2d`` inside, so
converted JAX weights compute the same function.  The critic keeps JAX's
stacked layout (its ``init`` is a ``vmap``): every leaf has a leading
``n_critics`` axis, and ``apply`` runs all critics with one batched product
a layer.  The recurrent factories wait for their slice.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from ..core.leading_dims import infer_leading_dims, restore_leading_dims
from .heads import (dense_init, gaussian_head, init_gaussian_head, init_linear,
                    init_mu_head, init_pg_head, init_q_head, linear, mu_head,
                    pg_head, q_head)


class Model(NamedTuple):
    init: Callable
    apply: Callable
    initial_state: Callable = lambda batch, **kw: None


# ---------------------------------------------------------------------------
# Trunks
# ---------------------------------------------------------------------------

def init_mlp_trunk(generator, d_in: int, hidden: Sequence[int]):
    layers, d = [], d_in
    for h in hidden:
        layers.append(init_linear(generator, d, h))
        d = h
    return layers


def mlp_trunk(layers, x, act=torch.tanh):
    for lp in layers:
        x = act(linear(lp, x))
    return x


def conv_out_hw(img_hw, kernels=(8, 4, 3), strides=(4, 2, 1)):
    h, w = img_hw
    for kz, st in zip(kernels, strides):
        h = (h - kz) // st + 1
        w = (w - kz) // st + 1
    return h, w


def init_conv_trunk(generator, in_ch: int, img_hw=(84, 84),
                    channels=(32, 64, 64), kernels=(8, 4, 3), strides=(4, 2, 1),
                    d_out: int = 512):
    convs, c = [], in_ch
    for ch, kz in zip(channels, kernels):
        convs.append({"w": dense_init((kz, kz, c, ch), kz * kz * c, generator)})
        c = ch
    h, w = conv_out_hw(img_hw, kernels, strides)
    return {"convs": convs, "proj": init_linear(generator, h * w * c, d_out)}


def conv_trunk(p, x, strides=(4, 2, 1)):
    """x: (B, H, W, C) float in [0,1]; VALID convolutions with HWIO kernels."""
    x = x.permute(0, 3, 1, 2)
    for cp, st in zip(p["convs"], strides):
        w = cp["w"].permute(3, 2, 0, 1).to(x.dtype)  # HWIO -> OIHW
        x = F.relu(F.conv2d(x, w, stride=st))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten as NHWC
    return F.relu(linear(p["proj"], x))


# ---------------------------------------------------------------------------
# Model factories
# ---------------------------------------------------------------------------

def make_pg_mlp(obs_dim: int, n_actions: int, hidden=(64, 64)) -> Model:
    def init(generator):
        return {"trunk": init_mlp_trunk(generator, obs_dim, hidden),
                "head": init_pg_head(generator, hidden[-1], n_actions)}

    def apply(params, observation, prev_action=None, prev_reward=None):
        lead, T, B, obs = infer_leading_dims(observation, 1)
        h = mlp_trunk(params["trunk"], obs)
        logits, value = pg_head(params["head"], h)
        return restore_leading_dims((logits, value), lead, T, B)

    return Model(init, apply)


def make_pg_conv(in_ch: int, n_actions: int, img_hw=(84, 84),
                 channels=(32, 64, 64), kernels=(8, 4, 3), strides=(4, 2, 1),
                 d_out=512) -> Model:
    def init(generator):
        return {"trunk": init_conv_trunk(generator, in_ch, img_hw, channels,
                                         kernels, strides, d_out),
                "head": init_pg_head(generator, d_out, n_actions)}

    def apply(params, observation, prev_action=None, prev_reward=None):
        lead, T, B, obs = infer_leading_dims(observation, 3)
        h = conv_trunk(params["trunk"], obs.to(torch.float32), strides)
        logits, value = pg_head(params["head"], h)
        return restore_leading_dims((logits, value), lead, T, B)

    return Model(init, apply)


def make_q_mlp(obs_dim: int, n_actions: int, hidden=(64, 64), *,
               dueling=False, n_atoms=0) -> Model:
    def init(generator):
        return {"trunk": init_mlp_trunk(generator, obs_dim, hidden),
                "head": init_q_head(generator, hidden[-1], n_actions,
                                    dueling=dueling, n_atoms=n_atoms)}

    def apply(params, observation, prev_action=None, prev_reward=None):
        lead, T, B, obs = infer_leading_dims(observation, 1)
        h = mlp_trunk(params["trunk"], obs, act=F.relu)
        q = q_head(params["head"], h, n_actions, dueling=dueling,
                   n_atoms=n_atoms)
        return restore_leading_dims(q, lead, T, B)

    return Model(init, apply)


def make_q_conv(in_ch: int, n_actions: int, img_hw=(84, 84), *,
                dueling=False, n_atoms=0,
                channels=(32, 64, 64), kernels=(8, 4, 3), strides=(4, 2, 1),
                d_out=512) -> Model:
    def init(generator):
        return {"trunk": init_conv_trunk(generator, in_ch, img_hw, channels,
                                         kernels, strides, d_out),
                "head": init_q_head(generator, d_out, n_actions,
                                    dueling=dueling, n_atoms=n_atoms)}

    def apply(params, observation, prev_action=None, prev_reward=None):
        lead, T, B, obs = infer_leading_dims(observation, 3)
        h = conv_trunk(params["trunk"], obs.to(torch.float32), strides)
        q = q_head(params["head"], h, n_actions, dueling=dueling,
                   n_atoms=n_atoms)
        return restore_leading_dims(q, lead, T, B)

    return Model(init, apply)


# ---------------------------------------------------------------------------
# Continuous control (DDPG/TD3/SAC): separate actor + critic factories
# ---------------------------------------------------------------------------

def make_ddpg_actor(obs_dim: int, act_dim: int, hidden=(256, 256)) -> Model:
    def init(generator):
        return {"trunk": init_mlp_trunk(generator, obs_dim, hidden),
                "head": init_mu_head(generator, hidden[-1], act_dim)}

    def apply(params, observation, prev_action=None, prev_reward=None):
        lead, T, B, obs = infer_leading_dims(observation, 1)
        h = mlp_trunk(params["trunk"], obs, act=F.relu)
        return restore_leading_dims(mu_head(params["head"], h), lead, T, B)

    return Model(init, apply)


def make_sac_actor(obs_dim: int, act_dim: int, hidden=(256, 256)) -> Model:
    def init(generator):
        return {"trunk": init_mlp_trunk(generator, obs_dim, hidden),
                "head": init_gaussian_head(generator, hidden[-1], act_dim)}

    def apply(params, observation, prev_action=None, prev_reward=None):
        lead, T, B, obs = infer_leading_dims(observation, 1)
        h = mlp_trunk(params["trunk"], obs, act=F.relu)
        mean, log_std = gaussian_head(params["head"], h)
        return restore_leading_dims((mean, log_std), lead, T, B)

    return Model(init, apply)


def make_q_critic(obs_dim: int, act_dim: int, hidden=(256, 256),
                  n_critics=2) -> Model:
    """Twin Q critics (TD3/SAC); q(s, a) -> (n_critics, *lead) stacked."""
    def init_one(generator):
        return {"trunk": init_mlp_trunk(generator, obs_dim + act_dim, hidden),
                "head": init_linear(generator, hidden[-1], 1)}

    def init(generator):
        return pytree.tree_map(lambda *xs: torch.stack(xs),
                               *[init_one(generator) for _ in range(n_critics)])

    def stacked_linear(p, x):
        """x (n_critics, N, d) -> (n_critics, N, k): every critic's layer in
        one batched product."""
        return torch.baddbmm(p["b"][:, None, :].to(x.dtype), x,
                             p["w"].to(x.dtype))

    def apply(params, observation, action):
        lead, T, B, obs = infer_leading_dims(observation, 1)
        _, _, _, act = infer_leading_dims(action, 1)
        sa = torch.cat([obs, act.to(obs.dtype)], dim=-1)
        x = sa.expand((params["head"]["w"].shape[0],) + tuple(sa.shape))
        for lp in params["trunk"]:
            x = F.relu(stacked_linear(lp, x))
        qs = stacked_linear(params["head"], x)[..., 0]   # (n_critics, T*B)
        qs = restore_leading_dims(qs.transpose(0, 1), lead, T, B)
        return torch.movedim(qs, -1, 0)                   # (n_critics, *lead)

    return Model(init, apply)
