"""Quickstart: PPO on CartPole, the port of ``examples/quickstart.py``
(rlpyt's own quickstart; the paper's serial-mode workflow, §2.4).

The on-policy path of the port: env -> agent -> ``SerialSampler`` ->
``PPO`` (via its ``BatchSpec``) -> ``TrainLoop`` / ``OnPolicyRunner``, fused
as JAX's runner is by default (on the card each iteration is one replay of
a CUDA graph), with an ``EvalSampler`` (dedicated envs, greedy
agent, ``eval_*`` in every log row) and sentinels (``sent_*``: grad /
param / update norms, non-finite counts, env steps).  It runs no
hand-written kernel: its products are ``torch.matmul``.

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu \\
      --iters 10

``learning_bar`` trains and scores the two CartPole bars of
tests/test_learning.py (PPO > 100 after 60 iterations, A2C > 50 after 80).
"""
from __future__ import annotations

import argparse
import os

import torch

from ..agents import make_categorical_pg_agent
from ..algos import A2C, PPO
from ..core.distributions import Categorical
from ..envs import make_env
from ..models.rl_models import make_pg_mlp
from ..runners import OnPolicyRunner
from ..samplers import EvalSampler, SerialSampler
from ..telemetry import trace
from ..train.optim import adam
from ..utils.logger import Logger

# tests/test_learning.py's CartPole bars: Adam 7e-4 with grad clip 1.0,
# entropy 0.01, 16 envs; scored by ``eval_return``
BARS = {"ppo": dict(iters=60, horizon=64, threshold=100.0),
        "a2c": dict(iters=80, horizon=32, threshold=50.0)}


def make_runner(n_iterations: int, *, log_interval: int = 10, logger=None):
    """The quickstart's sampler and runner: PPO (Adam 7e-4, grad clip 0.5,
    4 epochs x 4 minibatches) over 16 envs x horizon 64, evaluated by 8
    greedy envs (2000 steps, at most 8 episodes) at every log boundary,
    with sentinels."""
    env = make_env("cartpole")
    model = make_pg_mlp(obs_dim=4, n_actions=2)
    agent = make_categorical_pg_agent(model)
    algo = PPO(model.apply, adam(7e-4, grad_clip=0.5),
               distribution=Categorical(2), epochs=4, minibatches=4)
    sampler = SerialSampler(env, agent, n_envs=16, horizon=64)
    evaluator = EvalSampler(env, agent, n_envs=8, max_steps=2000,
                            max_episodes=8)
    runner = OnPolicyRunner(sampler, algo, n_iterations=n_iterations,
                            log_interval=log_interval, eval_sampler=evaluator,
                            sentinels=True, logger=logger)
    return sampler, runner


def eval_return(sampler, params, state, collects: int = 8) -> float:
    """Average return of the episodes that end in ``collects`` stochastic
    collects of the training sampler (tests/test_learning.py's
    ``_eval_return``)."""
    state = sampler.reset_stats(state)
    for _ in range(collects):
        state, _ = sampler.collect(params, state)
    return float(sampler.traj_stats(state)["avg_return"])


def learning_bar(name: str, seed: int = 0, device="cuda") -> float:
    """Train ``name`` ("ppo" or "a2c") at its bar's settings from ``seed``
    and return ``eval_return`` of the result (compare with
    ``BARS[name]["threshold"]``)."""
    bar = BARS[name]
    env = make_env("cartpole")
    model = make_pg_mlp(4, 2)
    agent = make_categorical_pg_agent(model)
    opt = adam(7e-4, grad_clip=1.0)
    if name == "ppo":
        algo = PPO(model.apply, opt, distribution=Categorical(2), epochs=4,
                   minibatches=4, entropy_coeff=0.01)
    else:
        algo = A2C(model.apply, opt, distribution=Categorical(2),
                   gae_lambda=0.95, entropy_coeff=0.01)
    sampler = SerialSampler(env, agent, n_envs=16, horizon=bar["horizon"])
    runner = OnPolicyRunner(sampler, algo, n_iterations=bar["iters"],
                            log_interval=bar["iters"],
                            logger=Logger(sinks=()))
    ts, ss, _ = runner.run(seed, device=device)
    return eval_return(sampler, ts.params, ss)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs on the host")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-dir", default=None,
                    help="progress.csv / progress.jsonl / trace.jsonl here")
    return ap


def main(argv=None) -> dict:
    """Train PPO on CartPole for ``--iters`` iterations (one log row every
    10); returns the sampler's final trajectory stats."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           "pass --device cpu to run on the host")
    trace.configure(os.path.join(args.log_dir, "trace.jsonl")
                    if args.log_dir else None)
    sampler, runner = make_runner(args.iters, logger=Logger(args.log_dir))
    _, ss, _ = runner.run(args.seed, device=device)
    stats = {k: float(v) for k, v in sampler.traj_stats(ss).items()}
    print("final stats:", stats)
    return stats


if __name__ == "__main__":
    main()
