"""Discrete control from vision (paper §3.2 / Fig 6): DQN and its variants
(Double, Dueling, Categorical/C51, prioritized) on Catch — the port of
``examples/catch_dqn_variants.py``.

The RL main path of the port: env -> agent -> ``SerialSampler`` ->
``DeviceReplay`` -> ``DQN`` -> ``TrainLoop`` / ``OffPolicyRunner``, fused
as JAX's runner is by default: on the card each iteration is one replay of
a CUDA graph (one graph for the iterations that copy the target network,
one for the others).  On ``--device cuda`` (the default) every
prioritized sample goes through the hand-written CUDA sum-tree kernel
(``csrc/sum_tree.cu``) unless ``--kernels sum_tree=ref`` asks for the
pointer-walk tree; ``--device cpu`` runs the plain versions.  After
training, a greedy evaluation (epsilon 0) of four collects prints its
trajectory stats.

  PYTHONPATH=src python -m repro_torch.examples.catch_dqn_variants \\
      --variant rainbow --device cuda
  PYTHONPATH=src python -m repro_torch.examples.catch_dqn_variants \\
      --device cpu --iters 6
"""
from __future__ import annotations

import argparse
import os

import torch

from ..agents import make_dqn_agent
from ..algos import DQN
from ..envs import make_env
from ..kernels import registry as kernel_registry
from ..models.rl_models import make_q_conv
from ..runners import OffPolicyRunner
from ..samplers import SerialSampler
from ..telemetry import trace
from ..train.optim import adam
from ..utils.logger import Logger

VARIANTS = {
    "dqn": dict(double=False, dueling=False, n_atoms=0, prioritized=False),
    "double": dict(double=True, dueling=False, n_atoms=0, prioritized=False),
    "dueling": dict(double=True, dueling=True, n_atoms=0, prioritized=True),
    "c51": dict(double=False, dueling=False, n_atoms=21, prioritized=False),
    # rainbow-minus-noisy = double + dueling + C51 + prioritized (paper §1.1)
    "rainbow": dict(double=True, dueling=True, n_atoms=21, prioritized=True),
}
N_ENVS = 16


def make_runner(variant: str, n_iterations: int, *, replay_capacity=8192,
                updates_per_collect=2, min_replay=512, log_interval=25,
                logger=None):
    """The example's sampler and runner for ``variant`` (its settings: 16
    envs x horizon 16, batch 64, epsilon 0.2, Adam 5e-4, gamma 0.99, target
    copy every 100 updates)."""
    v = VARIANTS[variant]
    env = make_env("catch")
    model = make_q_conv(1, 3, img_hw=(10, 5), channels=(16, 32),
                        kernels=(3, 3), strides=(1, 1), d_out=128,
                        dueling=v["dueling"], n_atoms=v["n_atoms"])
    agent = make_dqn_agent(model, 3, n_atoms=v["n_atoms"], v_min=-1, v_max=1)
    algo = DQN(model.apply, adam(5e-4), gamma=0.99, double=v["double"],
               n_atoms=v["n_atoms"], v_min=-1, v_max=1,
               target_update_interval=100)
    sampler = SerialSampler(env, agent, n_envs=N_ENVS, horizon=16)
    runner = OffPolicyRunner(sampler, algo, replay_capacity=replay_capacity,
                             batch_size=64, n_iterations=n_iterations,
                             updates_per_collect=updates_per_collect,
                             min_replay=min_replay,
                             prioritized=v["prioritized"],
                             log_interval=log_interval, logger=logger,
                             agent_state_kwargs={"epsilon": 0.2})
    return sampler, runner


def greedy_eval(sampler, params, sampler_state, collects: int = 4) -> dict:
    """Trajectory stats of ``collects`` greedy (epsilon 0) collects, as
    Python numbers."""
    dev = sampler_state.obs.device
    ss = sampler.reset_stats(sampler_state)._replace(
        agent_state={"epsilon": torch.zeros(sampler.n_envs, device=dev)})
    for _ in range(collects):
        ss, _ = sampler.collect(params, ss)
    return {k: float(x) for k, x in sampler.traj_stats(ss).items()}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", choices=sorted(VARIANTS), default="rainbow")
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CUDA kernel runs on 'cuda', "
                         "'cpu' runs the plain PyTorch versions")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--kernels", default=None,
                    help="kernel backend spec (REPRO_TORCH_KERNELS syntax: "
                         "'ref', 'sum_tree=ref', ...)")
    return ap


def main(argv=None) -> dict:
    """Train ``--variant`` for ``--iters`` iterations, then evaluate
    greedily; returns the greedy trajectory stats."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           "pass --device cpu to run the plain versions")
    trace.configure(os.path.join(args.log_dir, "trace.jsonl")
                    if args.log_dir else None)
    if args.kernels:
        kernel_registry.set_env(args.kernels)
    print(f"kernel backends: {kernel_registry.describe(device)}")
    sampler, runner = make_runner(args.variant, args.iters,
                                  logger=Logger(args.log_dir))
    ts, ss, _ = runner.run(args.seed, device=device)
    stats = greedy_eval(sampler, ts.params, ss)
    print(f"[{args.variant}] greedy eval:", stats)
    return stats


if __name__ == "__main__":
    main()
