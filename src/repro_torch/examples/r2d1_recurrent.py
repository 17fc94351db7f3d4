"""R2D1 (paper §3.2, Figs 7-8): recurrent agent + ASYNC runner + ALTERNATING
sampler + prioritized SEQUENCE replay with periodic recurrent-state storage
and burn-in — the paper's headline pipeline, end to end; the port of
``examples/r2d1_recurrent.py`` with its settings unchanged.

Catch, 16 envs x horizon 8 in two alternating groups, a conv trunk (16, 32)
under an LSTM of 64, ``SequenceReplayBuffer`` of 2048 x 16 (sequences of 16
after a burn-in of 4, the recurrent state stored every 8 steps), batch 32
sequences, warm-up 512, epsilon 0.2, one row every 20 iterations.  The path
launches no hand-written kernel: the host replay samples with the numpy sum
tree, and the LSTM is plain tensor ops.

  PYTHONPATH=src python -m repro_torch.examples.r2d1_recurrent
  PYTHONPATH=src python -m repro_torch.examples.r2d1_recurrent \\
      --device cpu --iters 30
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..agents import make_r2d1_agent
from ..algos import R2D1
from ..envs import make_env
from ..models.rl_models import make_recurrent_q
from ..replay.host import SequenceReplayBuffer, SequenceSamples
from ..runners import AsyncR2D1Runner
from ..samplers import AlternatingSampler
from ..telemetry import trace
from ..train.optim import adam
from ..utils.logger import Logger

D_LSTM = 64


def make_runner(n_iterations: int = 120, replay_ratio: float = 2.0, *,
                threaded: bool = True, log_interval: int = 20, logger=None,
                ckpt_dir=None, ckpt_interval: int = 0,
                target_update_interval: int = 200):
    """The example's sampler and ``AsyncR2D1Runner`` (settings of
    examples/r2d1_recurrent.py; ``threaded=False`` runs the lockstep
    schedule; a shorter ``target_update_interval`` lets a short run cross
    target refreshes)."""
    env = make_env("catch")
    model = make_recurrent_q(1, 3, conv=True, img_hw=(10, 5), d_lstm=D_LSTM,
                             channels=(16, 32), kernels=(3, 3),
                             strides=(1, 1), d_conv_out=128, dueling=True)
    agent = make_r2d1_agent(model, 3)
    algo = R2D1(model.apply, adam(5e-4), burn_in=4, n_step=2, gamma=0.99,
                target_update_interval=target_update_interval)
    # horizon == state_interval: recurrent state stored once per block
    sampler = AlternatingSampler(env, agent, n_envs=16, horizon=8)
    obs0 = np.zeros((10, 5, 1), np.float32)
    st0 = (np.zeros((D_LSTM,), np.float32), np.zeros((D_LSTM,), np.float32))
    example = SequenceSamples(observation=obs0, prev_action=np.int32(0),
                              prev_reward=np.float32(0), action=np.int32(0),
                              reward=np.float32(0), done=False,
                              init_state=st0)
    buffer = SequenceReplayBuffer(example, T_size=2048, B=16, seq_len=16,
                                  burn_in=4, state_interval=8)
    runner = AsyncR2D1Runner(sampler, algo, buffer, batch_size=32,
                             replay_ratio=replay_ratio, min_replay=512,
                             n_iterations=n_iterations,
                             log_interval=log_interval, logger=logger,
                             agent_state_kwargs={"epsilon": 0.2},
                             threaded=threaded, ckpt_dir=ckpt_dir,
                             ckpt_interval=ckpt_interval)
    return sampler, runner


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=120)
    ap.add_argument("--replay-ratio", type=float, default=2.0)
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
    _, runner = make_runner(args.iters, args.replay_ratio,
                            logger=Logger(args.log_dir))
    runner.run(0, device=device)
    print("done; final loss logged above;", runner.stats)
    return runner.stats


if __name__ == "__main__":
    main()
