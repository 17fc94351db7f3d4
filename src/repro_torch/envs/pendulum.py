"""Pendulum-v1 dynamics (continuous control, the MuJoCo-section stand-in:
same reward shape, bounded torque, 200-step time limit), port of
``repro/envs/pendulum.py``.

The port's env is batched like its CartPole: state is ``{"th": (B,) f32,
"thdot": (B,) f32, "t": (B,) int32}``, ``obs`` is (B, 3) ``[cos th, sin th,
thdot]`` and the action (B, 1) is a torque, clipped to [-2, 2].  Every
episode ends at the time limit, with ``timeout`` set (rlpyt bootstraps
there, paper footnote 3), and ``terminal_obs`` is the observation before the
reset.  The only randomness is the initial (th, thdot) of the episode that
starts where one ends: ``step`` draws (B, 2) of them from the generator (th
uniform in [-pi, pi), thdot in [-1, 1)) and passes them to
``step_with_noise``, which applies JAX's ``step`` (auto-reset included) to
the whole batch given them, so a test can hand both frameworks the same
draws.
"""
from __future__ import annotations

import math

import torch

from ..core.spaces import Box
from .base import EnvInfo, EnvSpec

F32 = torch.float32

MAX_SPEED = 8.0
MAX_TORQUE = 2.0
DT = 0.05
G = 10.0
M = 1.0
L = 1.0


def _angle_normalize(x):
    # a floor modulo, as JAX's ``%``: torch.remainder has its sign rule
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


def _obs(th, thdot):
    return torch.stack([torch.cos(th), torch.sin(th), thdot], dim=-1)


def _fresh(batch: int, generator):
    u = torch.rand((batch, 2), generator=generator, device=generator.device,
                   dtype=F32)
    return torch.stack([u[:, 0] * (2 * math.pi) - math.pi, u[:, 1] * 2 - 1],
                       dim=-1)


def step_with_noise(state, action, fresh, *, max_episode_steps: int = 200):
    """One step of every env, with ``fresh`` (B, 2) the (th, thdot) of the
    episode that starts where an episode ends."""
    th, thdot = state["th"], state["thdot"]
    u = torch.clamp(action.reshape(th.shape[0], -1)[:, 0].to(F32),
                    -MAX_TORQUE, MAX_TORQUE)
    cost = _angle_normalize(th) ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
    thdot = thdot + (3 * G / (2 * L) * torch.sin(th)
                     + 3.0 / (M * L ** 2) * u) * DT
    thdot = torch.clamp(thdot, -MAX_SPEED, MAX_SPEED)
    th = th + thdot * DT
    t = state["t"] + 1

    timeout = t >= max_episode_steps
    done = timeout
    obs_raw = _obs(th, thdot)
    fresh = fresh.to(F32)
    th = torch.where(done, fresh[:, 0], th)
    thdot = torch.where(done, fresh[:, 1], thdot)
    t = torch.where(done, torch.zeros_like(t), t)
    info = EnvInfo(timeout=timeout, episode_step=t, terminal_obs=obs_raw)
    return ({"th": th, "thdot": thdot, "t": t}, _obs(th, thdot), -cost,
            done, info)


def make_pendulum(max_episode_steps: int = 200) -> EnvSpec:
    def reset(batch: int, generator):
        fresh = _fresh(batch, generator)
        th, thdot = fresh[:, 0], fresh[:, 1]
        t = torch.zeros((batch,), dtype=torch.int32, device=fresh.device)
        return {"th": th, "thdot": thdot, "t": t}, _obs(th, thdot)

    def step(state, action, generator):
        return step_with_noise(state, action,
                               _fresh(state["t"].shape[0], generator),
                               max_episode_steps=max_episode_steps)

    return EnvSpec(
        name="pendulum",
        reset=reset,
        step=step,
        observation_space=Box(low=[-1.0, -1.0, -MAX_SPEED],
                              high=[1.0, 1.0, MAX_SPEED]),
        action_space=Box(low=-MAX_TORQUE, high=MAX_TORQUE, shape=(1,)),
        max_episode_steps=max_episode_steps,
    )
