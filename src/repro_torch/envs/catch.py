"""Catch: discrete control from vision (bsuite-style), the Atari stand-in.

Port of ``repro/envs/catch.py``.  A ball falls from a random column of a
rows x cols board; the agent moves a paddle on the bottom row {left, stay,
right}; reward +1 on catch, -1 on miss.  Observation is the (rows, cols, 1)
float image.

The port's env is batched: state is a dict of (B,) int32 tensors and
``obs`` is (B, rows, cols, 1) f32.  The only randomness is the column of the
next ball: ``step`` draws one per env from the generator and passes it to
``step_with_noise``, which applies JAX's ``step`` (auto-reset included) to
the whole batch given that noise, so a test can hand both frameworks the
same columns.
"""
from __future__ import annotations

import torch

from ..core.spaces import Box, Discrete
from .base import EnvInfo, EnvSpec

I32 = torch.int32


def _obs(ball_r, ball_c, paddle_c, rows, cols):
    """(B, rows, cols, 1): 1 at the ball and at the paddle, built by
    comparison (no scalar written through an index, which would copy the
    scalar from the host)."""
    dev = ball_r.device
    r = torch.arange(rows, device=dev)[None, :, None]
    c = torch.arange(cols, device=dev)[None, None, :]
    ball = (r == ball_r[:, None, None]) & (c == ball_c[:, None, None])
    paddle = (r == rows - 1) & (c == paddle_c[:, None, None])
    return (ball | paddle).to(torch.float32)[..., None]


def _fresh(ball_c, cols):
    return {"ball_r": torch.zeros_like(ball_c), "ball_c": ball_c,
            "paddle_c": torch.full_like(ball_c, cols // 2)}


def step_with_noise(state, action, fresh_c, *, rows: int = 10, cols: int = 5):
    """One step of every env, with ``fresh_c`` (B,) the ball column of the
    episode that starts where an episode ends."""
    move = action.to(I32) - 1  # {0,1,2} -> {-1,0,+1}
    paddle_c = torch.clamp(state["paddle_c"] + move, 0, cols - 1)
    ball_r = state["ball_r"] + 1
    done = ball_r >= rows - 1
    caught = done & (paddle_c == state["ball_c"])
    reward = torch.where(done, torch.where(caught, 1.0, -1.0), 0.0).to(
        torch.float32)

    fresh = _fresh(fresh_c.to(I32), cols)
    obs_raw = _obs(ball_r, state["ball_c"], paddle_c, rows, cols)
    ns = {
        "ball_r": torch.where(done, fresh["ball_r"], ball_r),
        "ball_c": torch.where(done, fresh["ball_c"], state["ball_c"]),
        "paddle_c": torch.where(done, fresh["paddle_c"], paddle_c),
    }
    info = EnvInfo(timeout=torch.zeros_like(done), episode_step=ns["ball_r"],
                   terminal_obs=obs_raw)
    obs = _obs(ns["ball_r"], ns["ball_c"], ns["paddle_c"], rows, cols)
    return ns, obs, reward, done, info


def make_catch(rows: int = 10, cols: int = 5) -> EnvSpec:
    def columns(batch, generator):
        return torch.randint(0, cols, (batch,), generator=generator,
                             device=generator.device, dtype=I32)

    def reset(batch: int, generator):
        s = _fresh(columns(batch, generator), cols)
        return s, _obs(s["ball_r"], s["ball_c"], s["paddle_c"], rows, cols)

    def step(state, action, generator):
        return step_with_noise(state, action,
                               columns(action.shape[0], generator),
                               rows=rows, cols=cols)

    return EnvSpec(
        name="catch",
        reset=reset,
        step=step,
        observation_space=Box(low=0.0, high=1.0, shape=(rows, cols, 1)),
        action_space=Discrete(3),
        max_episode_steps=rows,
    )
