"""Continuous control from state (paper §3.1 / Fig 4): SAC on Pendulum with
the async runner + host replay — entropy auto-tuning, twin critics, no
state-value function, and TIME-LIMIT BOOTSTRAPPING via terminal_obs (the
paper's footnote-3 fix); the port of ``examples/mujoco_style_sac.py`` with
its settings unchanged.

Hidden 64 x 64, 8 envs x horizon 32 through ``SerialSampler``, a host
``UniformReplayBuffer`` of 8192 x 8 storing the pre-reset next obs, batch
128, warm-up 1024, one row every 15 iterations; actor and learner run in
threads, the learner throttled to ``--replay-ratio``.  No hand-written
kernel runs on this path (uniform host replay).

  PYTHONPATH=src python -m repro_torch.examples.mujoco_style_sac
  PYTHONPATH=src python -m repro_torch.examples.mujoco_style_sac \\
      --device cpu --iters 20
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..agents import make_sac_agent
from ..algos import SAC
from ..envs import make_env
from ..models.rl_models import make_q_critic, make_sac_actor
from ..replay.host import TransitionSamples, UniformReplayBuffer
from ..runners import AsyncRunner
from ..samplers import SerialSampler
from ..telemetry import trace
from ..train.optim import adam
from ..utils.logger import Logger


def make_runner(n_iterations: int = 150, replay_ratio: float = 8.0, *,
                threaded: bool = True, log_interval: int = 15, logger=None):
    """The example's sampler, ``AsyncRunner`` and params init (``generator
    -> {"actor", "critic"}``), at the settings of
    examples/mujoco_style_sac.py."""
    env = make_env("pendulum")
    actor = make_sac_actor(3, 1, hidden=(64, 64))
    critic = make_q_critic(3, 1, hidden=(64, 64))
    agent = make_sac_agent(actor, 1)
    algo = SAC(actor.apply, critic.apply, adam(1e-3), adam(1e-3), act_dim=1)
    sampler = SerialSampler(env, agent, n_envs=8, horizon=32)
    example = TransitionSamples(
        observation=np.zeros(3, np.float32), action=np.zeros(1, np.float32),
        reward=np.float32(0), done=False, timeout=False)
    # store_next_obs=True: keeps the pre-reset obs so timeout bootstrapping
    # uses the true terminal state (footnote 3)
    buffer = UniformReplayBuffer(example, T_size=8192, B=8, n_step=1,
                                 store_next_obs=True)
    runner = AsyncRunner(sampler, algo, buffer, batch_size=128,
                         replay_ratio=replay_ratio, min_replay=1024,
                         n_iterations=n_iterations, log_interval=log_interval,
                         logger=logger, threaded=threaded)

    def init(generator):
        return {"actor": actor.init(generator),
                "critic": critic.init(generator)}

    return sampler, runner, init


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--replay-ratio", type=float, default=8.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs on the host")
    ap.add_argument("--log-dir", default=None,
                    help="progress.csv / progress.jsonl / trace.jsonl here")
    return ap


def main(argv=None) -> dict:
    """Train for ``--iters`` iterations from seed 0; returns the runner's
    ``stats``."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           "pass --device cpu to run on the host")
    trace.configure(os.path.join(args.log_dir, "trace.jsonl")
                    if args.log_dir else None)
    _, runner, init = make_runner(args.iters, args.replay_ratio,
                                  logger=Logger(args.log_dir))
    params = init(torch.Generator(device=device).manual_seed(0))
    runner.run(0, params=params, device=device)
    print("done;", runner.stats)
    return runner.stats


if __name__ == "__main__":
    main()
