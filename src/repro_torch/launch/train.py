"""LM-policy PPO training entry point of the PyTorch port.

Port of the single-device path of ``repro/launch/train.py``.  The policy IS a language model over the
token-MDP environment: each iteration runs

- a rollout: ``horizon`` batched ``decode_step``s with the KV / SSM cache,
  one sampled token per sequence per step (the serving path), replayed on
  the card from one CUDA graph of the step, as JAX scans it;
- GAE over the (T, B) trajectory, advantages normalised over the batch;
- one PPO update through ``forward_train``, ``lm_logits``, ``value_out`` and
  Adam (lr ``--lr``, global-norm clip 1.0, entropy coefficient 0.003).

``--arch`` defaults to ``gemma2-2b``, as in JAX; the other models are
mamba2-1.3b, the dense glm4-9b, phi3-mini-3.8b and granite-34b, the moe
qwen2-moe-a2.7b and mixtral-8x7b (whose load-balance loss enters the PPO
loss at ``aux_coeff`` 0.01, as in JAX), the hybrid zamba2-7b and the vlm
llama-3.2-vision-90b.  As JAX's launcher, this one passes no image tokens
and no encoder frames: the rollout's cache holds one zero source slot, and
the vlm cross layers train as non-causal self-attention over the text;
whisper-medium (encdec), whose forward needs frames, is refused before any
weight is drawn (JAX's train fails in its encoder on ``enc_frames=None``).
Entry points run on ``--device cuda`` (the default), where every attention
call (``flash_attn_fwd`` in the update's forward and its recompute,
``flash_attn_decode`` in the rollout) and every SSD scan of the update
(mamba2, zamba2) goes through its hand-written CUDA kernel unless
``--kernels ref`` asks for the plain PyTorch math; ``--device cpu`` runs
the plain versions.  ``--smoke`` (the default config) and ``--full`` both
run on the card for every arch.  Every
iteration logs one row (console, CSV, JSONL under ``--log-dir``) with the
PPO metrics, ``samples_per_sec`` and the rollout and update wall times.
``--ckpt-dir`` / ``--ckpt-interval`` save ``(params, opt_state)`` in JAX's
layout every N steps and ``--restore`` resumes from the latest one (either
package's); ``--profile[=DIR]`` writes a ``torch.profiler`` Chrome trace
with the telemetry spans as ranges.  ``--layers N`` (the port's own flag,
as serve's) cuts the config to its first N layers.  ``--fuse-window N``
(JAX's scanned window of N steps) runs N steps with no read of the device
between them and logs one row at the window's end, with JAX's keys
(avg_reward, loss, entropy of the last step, samples_per_sec); the update
stays eager (ROADMAP Queue 1 item 14).

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-moe-a2.7b \\
      --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --full --batch 8 \\
      --horizon 256 --steps 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
      --full --batch 8 --horizon 512 --steps 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \\
      --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \\
      --full --layers 15 --batch 8 --horizon 256 --steps 2
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch
import torch.nn.functional as F

from ..algos.pg.gae import gae_associative
from ..algos.pg.ppo import make_lm_ppo_train_step
from ..configs import get_config, get_smoke_config
from ..core.graphs import StepGraph
from ..envs.token_lm import make_token_lm
from ..kernels import registry as kernel_registry
from ..models import backbones as bb
from ..models.config import ModelConfig
from ..serving.engine import sample, sync
from ..telemetry import trace
from ..train.checkpoint import (latest_step, restore_lm_checkpoint,
                                save_lm_checkpoint)
from ..train.optim import adam
from ..utils.logger import Logger

F32 = torch.float32


def make_lm_rollout(cfg: ModelConfig, env, batch: int, horizon: int,
                    temperature: float = 1.0, *, device, graph: bool = True):
    """Batched action selection with the serving path: one decode_step per
    env step.

    rollout(params, generator) -> (traj, v_last); traj holds (T, B) tensors
    tokens, actions, logp, value, reward, done.  Runs under
    ``torch.no_grad()`` (not ``inference_mode``: the update's backward
    saves the tokens).  The logp is over the first ``V`` logits, as in JAX
    (the update's is over the padded vocabulary).

    Each env step is one call of ``step`` on fixed state: the KV / SSM
    cache, the env state, the obs, the (T, B) output buffers and the step
    index ``t``, a device scalar at which the step writes its outputs.  On
    a CUDA device with ``graph`` (the default) ``step`` is captured once in
    a CUDA graph (core/graphs.py) and replayed ``horizon`` times a rollout,
    the counterpart of JAX's ``lax.scan`` over the horizon; ``graph=False``
    calls it eagerly, with the same results bit for bit.  The reset, the
    cache's zeroing and the bootstrap value stay eager.  ``traj`` and
    ``v_last`` are this function's buffers: the next rollout overwrites
    them."""
    V = env.action_space.n
    device = torch.device(device)
    cache = bb.init_cache(cfg, batch, horizon + 1, device=device)
    traj = {k: torch.zeros((horizon, batch), dtype=dt, device=device)
            for k, dt in (("tokens", torch.int32), ("actions", torch.int32),
                          ("logp", F32), ("value", F32), ("reward", F32),
                          ("done", torch.bool))}
    t = torch.zeros((1,), dtype=torch.int64, device=device)

    @torch.no_grad()
    def step(params, cache, env_state, obs, t, traj, generator):
        hidden, cache = bb.decode_step(params, cache, obs, cfg)
        logits = bb.lm_logits(params, hidden, cfg)[:, 0, :V].to(F32)
        value = bb.value_out(params, hidden)[:, 0]
        action = sample(logits, temperature, generator).to(torch.int32)
        logp = torch.gather(F.log_softmax(logits, dim=-1), 1,
                            action.long()[:, None])[:, 0]
        env_state, obs2, reward, done, _ = env.step(env_state, action,
                                                    generator)
        for k, v in (("tokens", obs), ("actions", action), ("logp", logp),
                     ("value", value), ("reward", reward), ("done", done)):
            traj[k].index_copy_(0, t, v[None])
        return (params, cache, env_state, obs2, t + 1, traj, generator), None

    stepper = StepGraph(step, device=device, name="lm_rollout.step") \
        if graph else step

    held = [(cache, t, traj)]   # the state's cache, t and buffers

    @torch.no_grad()
    def rollout(params, generator):
        env_state, obs = env.reset(batch, generator)
        c, i, out = held[0]
        for x in c.values():
            x.zero_()
        i.zero_()
        state = (params, c, env_state, obs, i, out, generator)
        for _ in range(horizon):
            state, _ = stepper(*state)
        held[0] = (state[1], state[4], state[5])
        # bootstrap value of the last obs
        hidden, _ = bb.decode_step(params, state[1], state[3], cfg)
        v_last = bb.value_out(params, hidden)[:, 0]
        return state[5], v_last

    return rollout


def build_batch(traj, v_last):
    """Time-major (T, B) -> GAE -> batch-major (B, T) for the train step."""
    adv, ret = gae_associative(traj["reward"], traj["value"], v_last,
                               traj["done"], gamma=0.99, lam=0.95)
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)

    def tm(x):
        return x.transpose(0, 1).contiguous()

    return {"tokens": tm(traj["tokens"]), "actions": tm(traj["actions"]),
            "logp_old": tm(traj["logp"]), "advantage": tm(adv),
            "return_": tm(ret)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CUDA kernels run on 'cuda', "
                         "'cpu' runs the plain PyTorch versions")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--horizon", type=int, default=32)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to its first N layers (the port's "
                         "own flag, for archs whose training state exceeds "
                         "one card at full depth; default: the config's)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=0)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--fuse-window", type=int, default=1,
                    help="run this many (rollout + update) steps with no "
                         "read of the device between them (JAX's scanned "
                         "window); logs and checkpoints land on window "
                         "boundaries")
    ap.add_argument("--kernels", default=None,
                    help="kernel backend spec (REPRO_TORCH_KERNELS syntax: "
                         "'ref', 'cuda', 'attention=ref', 'ssd=ref', ...)")
    ap.add_argument("--profile", nargs="?", const="", default=None,
                    metavar="DIR",
                    help="write a torch.profiler Chrome trace of the run "
                         "into DIR (default <log-dir>/profile); the host "
                         "phases appear as the telemetry spans")
    return ap


def _checkpoint_due(args, step: int) -> bool:
    return bool(args.ckpt_dir and args.ckpt_interval
                and step % args.ckpt_interval == 0)


def _run_steps(args, rollout, train_step, params, opt_state, gen, start,
               logger, tracer, cfg, device):
    """One step at a time, each timed and logged with every metric."""
    for step in range(start, args.steps):
        sync(device)
        t0 = time.perf_counter()
        with tracer.span("rollout", step=step):
            traj, v_last = rollout(params, gen)
            sync(device)
        t1 = time.perf_counter()
        with tracer.span("update", step=step):
            batch = build_batch(traj, v_last)
            params, opt_state, metrics = train_step(params, opt_state, batch)
            sync(device)
        t2 = time.perf_counter()
        with tracer.span("log", step=step + 1):
            logger.record(step + 1, {
                "avg_reward": float(torch.mean(traj["reward"])),
                **{k: float(v) for k, v in metrics.items()},
                "samples_per_sec": args.batch * args.horizon / (t2 - t0),
                "rollout_s": t1 - t0,
                "update_s": t2 - t1,
            })
        tracer.memory_snapshot(f"step_{step + 1}")
        if _checkpoint_due(args, step + 1):
            with tracer.span("checkpoint", step=step + 1):
                save_lm_checkpoint(args.ckpt_dir, step + 1, params,
                                   opt_state, cfg)


def _run_windows(args, rollout, train_step, params, opt_state, gen, start,
                 logger, tracer, cfg, device):
    """``--fuse-window`` steps at a time, as JAX's scanned window: nothing
    in a window reads the device; at its end one row logs the last step's
    avg_reward, loss and entropy and the window's samples_per_sec.  A
    window also ends at every checkpoint boundary."""
    t0 = time.perf_counter()
    step = start
    while step < args.steps:
        chunk = min(args.fuse_window, args.steps - step)
        if args.ckpt_dir and args.ckpt_interval:
            nxt = step + args.ckpt_interval - (step % args.ckpt_interval)
            chunk = min(chunk, nxt - step)
        with tracer.span("fused_window", step=step, iters=chunk):
            for _ in range(chunk):
                traj, v_last = rollout(params, gen)
                batch = build_batch(traj, v_last)
                params, opt_state, metrics = train_step(params, opt_state,
                                                        batch)
                avg_reward = torch.mean(traj["reward"])
        step += chunk
        sync(device)
        sps = args.batch * args.horizon * chunk / max(
            time.perf_counter() - t0, 1e-9)
        with tracer.span("log", step=step):
            logger.record(step, {"avg_reward": float(avg_reward),
                                 "loss": float(metrics["loss"]),
                                 "entropy": float(metrics["entropy"]),
                                 "samples_per_sec": sps})
        tracer.memory_snapshot(f"window_{step}")
        if _checkpoint_due(args, step):
            with tracer.span("checkpoint", step=step):
                save_lm_checkpoint(args.ckpt_dir, step, params, opt_state,
                                   cfg)
        t0 = time.perf_counter()


def main(argv=None):
    """Run ``--steps`` iterations; returns the trained ``LM``."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           "pass --device cpu to run the plain versions")
    tracer = trace.configure(os.path.join(args.log_dir, "trace.jsonl")
                             if args.log_dir else None)
    if args.kernels:
        kernel_registry.set_env(args.kernels)
    print(f"kernel backends: {kernel_registry.describe(device)}")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if cfg.family == "encdec":
        # JAX's launcher builds its train step without enc_len and its
        # batch without frames, so JAX's train fails in encoder_forward on
        # enc_frames=None; the port refuses before drawing any weight
        raise ValueError(
            f"train --arch {args.arch}: the encdec family's forward needs "
            "encoder frames, and this launcher (as the JAX package's) "
            "passes none to its train step (enc_len 0); JAX's train fails "
            "in encoder_forward on enc_frames=None")
    env = make_token_lm(vocab=cfg.vocab, episode_len=args.horizon,
                        device=device)
    logger = Logger(args.log_dir)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = bb.init_lm(cfg, device=device, generator=gen, dtype=F32,
                        requires_grad=True)
    opt = adam(args.lr, grad_clip=1.0)
    opt_state = opt.init(params.parameters())
    rollout = make_lm_rollout(cfg, env, args.batch, args.horizon,
                              device=device)
    train_step = make_lm_ppo_train_step(cfg, opt, entropy_coeff=0.003)
    start = 0
    if args.restore and args.ckpt_dir and \
            latest_step(args.ckpt_dir) is not None:
        opt_state, manifest = restore_lm_checkpoint(args.ckpt_dir, params,
                                                    opt_state, cfg)
        start = manifest["step"]
        print(f"restored step {start}")
    try:
        with trace.chrome_trace(args.profile, args.log_dir, device,
                                "train_trace.json"):
            if args.fuse_window > 1:
                _run_windows(args, rollout, train_step, params, opt_state,
                             gen, start, logger, tracer, cfg, device)
            else:
                _run_steps(args, rollout, train_step, params, opt_state,
                           gen, start, logger, tracer, cfg, device)
    finally:
        logger.close()
    return params


if __name__ == "__main__":
    main()
