"""Continuous control from state (paper §3.1): the Q-value policy-gradient
family — DDPG, TD3 and SAC — on Pendulum through the synchronous
``OffPolicyRunner`` and ``DeviceReplay``, fused as JAX's runner is by
default: on the card each iteration (a collect and its updates) is one
replay of a CUDA graph (TD3: one graph for each pattern of delayed actor
steps an iteration takes).

The off-policy path of the port with time-limit bootstrapping: every
Pendulum episode ends at its 200-step limit, the replay stores the
pre-reset ``terminal_obs`` as ``next_observation`` and bootstraps there
(paper footnote 3).  With ``--prioritized`` every replay sample goes through
the hand-written CUDA sum-tree kernel on the card (``td_abs`` priorities).
JAX's ``examples/mujoco_style_sac.py`` runs SAC through the async runner
and a host replay; its twin is ``repro_torch.examples.mujoco_style_sac``.

  PYTHONPATH=src python -m repro_torch.examples.pendulum_qpg --algo sac
  PYTHONPATH=src python -m repro_torch.examples.pendulum_qpg --algo td3 \\
      --device cpu --hidden 64 --iters 20

``learning_bar`` trains and scores the SAC Pendulum bar of
tests/test_learning.py (``after > before + 100`` with ``before < -500``).
"""
from __future__ import annotations

import argparse
import os

import torch

from ..agents import make_ddpg_agent, make_sac_agent
from ..algos import DDPG, SAC, TD3
from ..envs import make_env
from ..models.rl_models import make_ddpg_actor, make_q_critic, make_sac_actor
from ..runners import OffPolicyRunner
from ..samplers import SerialSampler
from ..telemetry import trace
from ..train.optim import adam
from ..utils.logger import Logger
from .quickstart import eval_return

ALGOS = ("sac", "td3", "ddpg")
# tests/test_learning.py::test_sac_improves_pendulum, its settings
BAR = dict(hidden=(64, 64), n_envs=8, horizon=32, replay_capacity=16384,
           batch_size=128, iters=160, updates_per_collect=32,
           min_replay=1024, init_alpha=0.2, gain=100.0, before_max=-500.0)


def make_runner(name: str, n_iterations: int, *, hidden=(256, 256),
                n_envs: int = 8, horizon: int = 32,
                replay_capacity: int = 2 ** 20, batch_size: int = 256,
                updates_per_collect: int = 8, min_replay: int = 1024,
                prioritized: bool = False, init_alpha: float = 1.0,
                log_interval: int = 10, logger=None, ckpt_dir=None,
                ckpt_interval: int = 0):
    """``name``'s sampler, runner and params init (``generator ->
    {"actor", "critic"}``): the JAX factories' actor and twin critic at
    ``hidden``, Adam 1e-3 with grad clip 1.0 for both, gamma 0.99, tau
    0.005, DDPG / TD3 exploration noise 0.1."""
    env = make_env("pendulum")
    actor = (make_sac_actor if name == "sac" else make_ddpg_actor)(
        3, 1, hidden=hidden)
    critic = make_q_critic(3, 1, hidden=hidden)
    opts = (adam(1e-3, grad_clip=1.0), adam(1e-3, grad_clip=1.0))
    if name == "sac":
        agent = make_sac_agent(actor, 1)
        algo = SAC(actor.apply, critic.apply, *opts, act_dim=1,
                   init_alpha=init_alpha)
    else:
        agent = make_ddpg_agent(actor, 1, expl_noise=0.1)
        algo = {"td3": TD3, "ddpg": DDPG}[name](actor.apply, critic.apply,
                                               *opts)
    sampler = SerialSampler(env, agent, n_envs=n_envs, horizon=horizon)
    runner = OffPolicyRunner(sampler, algo, replay_capacity=replay_capacity,
                             batch_size=batch_size, n_iterations=n_iterations,
                             updates_per_collect=updates_per_collect,
                             min_replay=min_replay, prioritized=prioritized,
                             log_interval=log_interval, logger=logger,
                             ckpt_dir=ckpt_dir, ckpt_interval=ckpt_interval)

    def init(generator):
        return {"actor": actor.init(generator),
                "critic": critic.init(generator)}

    return sampler, runner, init


def learning_bar(seed: int = 0, device="cuda"):
    """Train SAC at the bar's settings from ``seed``; returns (before,
    after): the return of the initial policy over 8 collects of a fresh
    sampler, and ``eval_return`` of the trained one (the bar:
    ``before < BAR["before_max"]`` and ``after > before + BAR["gain"]``)."""
    keys = ("hidden", "n_envs", "horizon", "replay_capacity", "batch_size",
            "updates_per_collect", "min_replay", "init_alpha")
    sampler, runner, init = make_runner(
        "sac", BAR["iters"], log_interval=BAR["iters"],
        logger=Logger(sinks=()), **{k: BAR[k] for k in keys})
    params = init(torch.Generator(device=device).manual_seed(seed))
    # the initial policy's return, over full 200-step episodes
    ss0 = sampler.init(torch.Generator(device=device).manual_seed(seed + 1))
    before = eval_return(sampler, params, ss0)
    ts, ss, _ = runner.run(seed, params=params, device=device)
    return before, eval_return(sampler, ts.params, ss)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", choices=ALGOS, default="sac")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--hidden", type=int, default=256,
                    help="width of the two hidden layers")
    ap.add_argument("--prioritized", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs on the host")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-dir", default=None,
                    help="progress.csv / progress.jsonl / trace.jsonl here")
    return ap


def main(argv=None) -> dict:
    """Train ``--algo`` on Pendulum for ``--iters`` iterations (8 envs x
    horizon 32, 8 updates of batch 256 a collect, one log row every 10);
    returns the sampler's final trajectory stats."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           "pass --device cpu to run on the host")
    trace.configure(os.path.join(args.log_dir, "trace.jsonl")
                    if args.log_dir else None)
    sampler, runner, init = make_runner(
        args.algo, args.iters, hidden=(args.hidden, args.hidden),
        prioritized=args.prioritized, logger=Logger(args.log_dir))
    params = init(torch.Generator(device=device).manual_seed(args.seed))
    _, ss, _ = runner.run(args.seed, params=params, device=device)
    stats = {k: float(v) for k, v in sampler.traj_stats(ss).items()}
    print("final stats:", stats)
    return stats


if __name__ == "__main__":
    main()
