"""CartPole-v1 dynamics (discrete control, reward 1/step), port of
``repro/envs/cartpole.py``.

The port's env is batched like its Catch: state is ``{"phys": (B, 4) f32,
"t": (B,) int32}`` and ``obs`` is the (B, 4) physical state.  The only
randomness is the initial state of the episode that starts where one ends:
``step`` draws (B, 4) uniforms in [-0.05, 0.05] from the generator and
passes them to ``step_with_noise``, which applies JAX's ``step`` (auto-reset
included) to the whole batch given that noise, so a test can hand both
frameworks the same draws.

The limits are rounded to f32 once, here: JAX compares the f32 state with
its weakly typed Python-float limits in f32, so a pole at the f32 value of
12 degrees must end its episode on the same step in both.
"""
from __future__ import annotations

import math

import torch

from ..core.spaces import Box, Discrete
from .base import EnvInfo, EnvSpec

F32 = torch.float32

GRAVITY = 9.8
CART_MASS = 1.0
POLE_MASS = 0.1
TOTAL_MASS = CART_MASS + POLE_MASS
LENGTH = 0.5
POLEMASS_LENGTH = POLE_MASS * LENGTH
FORCE_MAG = 10.0
TAU = 0.02
THETA_LIMIT = torch.tensor(12 * 2 * math.pi / 360, dtype=F32).item()
X_LIMIT = torch.tensor(2.4, dtype=F32).item()


def _fresh(batch: int, generator):
    u = torch.rand((batch, 4), generator=generator, device=generator.device,
                   dtype=F32)
    return u * 0.1 - 0.05


def step_with_noise(state, action, fresh, *, max_episode_steps: int = 500):
    """One step of every env, with ``fresh`` (B, 4) the initial state of the
    episode that starts where an episode ends."""
    x, x_dot, theta, theta_dot = state["phys"].unbind(-1)
    force = torch.where(action == 1, FORCE_MAG, -FORCE_MAG).to(F32)
    costh, sinth = torch.cos(theta), torch.sin(theta)
    temp = (force + POLEMASS_LENGTH * torch.square(theta_dot) * sinth) / TOTAL_MASS
    thetaacc = (GRAVITY * sinth - costh * temp) / (
        LENGTH * (4.0 / 3.0 - POLE_MASS * torch.square(costh) / TOTAL_MASS))
    xacc = temp - POLEMASS_LENGTH * thetaacc * costh / TOTAL_MASS
    x = x + TAU * x_dot
    x_dot = x_dot + TAU * xacc
    theta = theta + TAU * theta_dot
    theta_dot = theta_dot + TAU * thetaacc
    phys = torch.stack([x, x_dot, theta, theta_dot], dim=-1)
    t = state["t"] + 1

    fell = (torch.abs(x) > X_LIMIT) | (torch.abs(theta) > THETA_LIMIT)
    timeout = t >= max_episode_steps
    done = fell | timeout
    reward = torch.ones_like(x)

    obs_raw = phys
    phys = torch.where(done[:, None], fresh.to(F32), phys)
    t = torch.where(done, torch.zeros_like(t), t)
    info = EnvInfo(timeout=timeout & ~fell, episode_step=t,
                   terminal_obs=obs_raw)
    return {"phys": phys, "t": t}, phys, reward, done, info


def make_cartpole(max_episode_steps: int = 500) -> EnvSpec:
    def reset(batch: int, generator):
        phys = _fresh(batch, generator)
        t = torch.zeros((batch,), dtype=torch.int32, device=phys.device)
        return {"phys": phys, "t": t}, phys

    def step(state, action, generator):
        return step_with_noise(state, action,
                               _fresh(action.shape[0], generator),
                               max_episode_steps=max_episode_steps)

    return EnvSpec(
        name="cartpole",
        reset=reset,
        step=step,
        observation_space=Box(low=-math.inf, high=math.inf, shape=(4,)),
        action_space=Discrete(2),
        max_episode_steps=max_episode_steps,
    )
