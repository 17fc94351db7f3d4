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
a layer.

The LSTM of the recurrent agents (paper §6.3) keeps JAX's layout and
arithmetic: ``wx`` (d_in, 4H) used as ``x @ wx``, ``wh`` (H, 4H), one
bias, gates i, f, g, o in that order, and +1 inside the forget sigmoid.  It
runs as plain tensor ops one step at a time, as JAX's ``lax.scan`` does;
``nn.LSTM`` / cuDNN keep another weight layout and no forget offset.
``make_recurrent_q`` (R2D1) feeds it ``[trunk h, one_hot(prev_action),
prev_reward]``; its ``apply`` is time-major and returns ``(q, state)``.
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


F32 = torch.float32


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
# LSTM cell (recurrent agents, paper §6.3) — plain tensor ops, cuDNN-free
# ---------------------------------------------------------------------------

def init_lstm(generator, d_in: int, d_hidden: int):
    return {
        "wx": dense_init((d_in, 4 * d_hidden), d_in, generator),
        "wh": dense_init((d_hidden, 4 * d_hidden), d_hidden, generator),
        "b": torch.zeros((4 * d_hidden,), dtype=F32, device=generator.device),
    }


def lstm_step(p, x, state):
    """x: (B, d_in); state: (h, c) each (B, d_hidden)."""
    h, c = state
    gates = x @ p["wx"].to(x.dtype) + h @ p["wh"].to(x.dtype) + \
        p["b"].to(x.dtype)
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, (h, c)


def lstm_seq(p, xs, state):
    """xs: (T, B, d_in) -> (T, B, H), final state; a loop over time."""
    hs = []
    for x in xs:
        h, state = lstm_step(p, x, state)
        hs.append(h)
    return torch.stack(hs), state


def lstm_zero_state(d_hidden: int, batch: int, dtype=F32, *, device="cpu"):
    return (torch.zeros((batch, d_hidden), dtype=dtype, device=device),
            torch.zeros((batch, d_hidden), dtype=dtype, device=device))


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


def make_recurrent_q(obs_dim_or_ch, n_actions: int, *, conv=False, d_lstm=256,
                     img_hw=(84, 84), dueling=True, trunk_hidden=(256,),
                     channels=(32, 64, 64), kernels=(8, 4, 3),
                     strides=(4, 2, 1), d_conv_out=512) -> Model:
    """R2D1-style recurrent Q model: trunk -> [h, prev_a_onehot, prev_r] ->
    LSTM -> Q.

    apply() is time-major: (T, B, ...) observation, returns (q (T,B,A),
    state)."""
    def init(generator):
        trunk = (init_conv_trunk(generator, obs_dim_or_ch, img_hw, channels,
                                 kernels, strides, d_conv_out) if conv
                 else init_mlp_trunk(generator, obs_dim_or_ch, trunk_hidden))
        d_trunk = d_conv_out if conv else trunk_hidden[-1]
        return {"trunk": trunk,
                "lstm": init_lstm(generator, d_trunk + n_actions + 1, d_lstm),
                "head": init_q_head(generator, d_lstm, n_actions,
                                    dueling=dueling)}

    def apply(params, observation, prev_action, prev_reward, state):
        T, B = observation.shape[:2]
        obs = observation.reshape((T * B,) + tuple(observation.shape[2:]))
        h = (conv_trunk(params["trunk"], obs.to(torch.float32), strides)
             if conv else mlp_trunk(params["trunk"], obs, act=F.relu))
        h = h.reshape(T, B, -1)
        pa = F.one_hot(prev_action.long(), n_actions).to(h.dtype)
        xs = torch.cat([h, pa, prev_reward[..., None].to(h.dtype)], dim=-1)
        hs, state = lstm_seq(params["lstm"], xs, state)
        return q_head(params["head"], hs, n_actions, dueling=dueling), state

    def initial_state(batch, *, device="cpu"):
        return lstm_zero_state(d_lstm, batch, device=device)

    return Model(init, apply, initial_state=initial_state)


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
