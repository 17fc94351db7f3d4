"""LM-policy PPO training entry point of the PyTorch port.

Port of ``repro/launch/train.py``.  The policy IS a language model over the
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
stays eager, as the port's LM update does everywhere (its graph waits for
the performance work).

``--mesh DATAxMODEL`` (default ``$REPRO_MESH``, as JAX's) trains on a
2-D mesh of D x M ranks (``run_mesh``, JAX's 2-D mesh loop).
``train.main`` spawns the ranks itself (``launch.mesh.spawn_ranks``:
NCCL where each rank has a card of its own, else gloo, ``cuda:(rank %
cards)``, so ranks may share a card) or, where ``torch.distributed`` is
already initialized (the pod script, a test), joins that group and spawns
nothing.  The 'model' axis (M > 1) is tensor parallelism by
``param_pspecs``' rules (``models/sharding.py``): a rank holds its block
of every leaf they split and computes its heads and hidden widths, and
the M ranks of a model group hold the same batch, sample the same actions
from the same gathered logits and keep their replicated leaves equal.
Each data rank runs its own rollout on ``batch / D`` sequences and
normalises its advantages over that slice (JAX's documented difference
from the global batch); the gradients are averaged over the data axis by
``cross_replica``, in int8 with error feedback under ``--compress``
(which needs ``--mesh``), before one Adam step whose clip reads the
logical tensors' norm.  Rank 0 logs JAX's keys averaged over the data
axis (plus ``compress_err_norm`` and ``grad_norm_shard_max`` when
compressed) and this rank's ``rollout_s``, ``update_s`` and
``allreduce_s`` (the time of the update's data-axis all-reduces, inside
``update_s``), with ``tp_allreduce_s`` (the time of the model axis's
collectives in the rollout and the update) at M > 1, over the window
(``mesh.CollectiveTime``: host time on gloo, CUDA events under NCCL, the
replayed rollout's by the event nodes its capture recorded), and writes
the checkpoints; rank r > 0 logs its own rows under
``<log-dir>/rank_<r>``.  The rollout replays its CUDA graph wherever the
model axis' collectives can be captured (NCCL, or no model axis); a model
axis of gloo ranks (ranks sharing a card, the CPU) rolls out eagerly, and
rank 0's first line says which.

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
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --mesh 2x1 --compress --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --full --layers 4 \\
      --mesh 2x1 --compress --batch 8 --horizon 64 --steps 2
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --mesh 1x2 --steps 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-moe-a2.7b \\
      --full --mesh 1x4 --batch 8 --horizon 64 --steps 2
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import os
import sys
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..algos.pg.gae import gae_associative
from ..algos.pg.ppo import make_lm_ppo_train_step
from ..configs import get_config, get_smoke_config
from ..core.graphs import StepGraph
from ..envs.token_lm import make_token_lm
from ..kernels import registry as kernel_registry
from ..kernels.flash_attention.flash_attention import DECODE_INSTANCES
from ..models import backbones as bb
from ..models import sharding as shd
from ..models.config import ModelConfig
from ..models.convert import jax_leaf_groups
from ..models.layers import kv_layout
from ..samplers.eval import fold_seed
from ..serving.engine import sample, sync
from ..telemetry import trace
from ..train.checkpoint import (latest_step, restore_lm_checkpoint,
                                save_lm_checkpoint)
from ..train.compress import wire_bytes
from ..train.optim import adam, cross_replica
from ..utils.logger import Logger
from . import mesh as mesh_lib

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
    ap.add_argument("--mesh", default=os.environ.get("REPRO_MESH", ""),
                    help="mesh spec 'DATAxMODEL' (e.g. '2x1', '1x4'); "
                         "'1x1' / '' runs the single-device path.  "
                         "Defaults to $REPRO_MESH.  DATA x MODEL ranks, "
                         "cuda:(rank %% cards); MODEL > 1 is tensor "
                         "parallelism by the sharding rules")
    ap.add_argument("--compress", nargs="?", const="int8_ef", default=None,
                    choices=["int8_ef"],
                    help="compress the data-axis gradient all-reduce "
                         "(int8 + error feedback); requires --mesh")
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
        tracer.flush()
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
        tracer.flush()
        if _checkpoint_due(args, step):
            with tracer.span("checkpoint", step=step):
                save_lm_checkpoint(args.ckpt_dir, step, params, opt_state,
                                   cfg)
        t0 = time.perf_counter()


# a mesh rank blocked this long in a collective raises: rank 0 writes a
# full-width checkpoint while the others wait at its barrier
MESH_COLLECTIVE_TIMEOUT_S = 1800.0


def run_mesh(args, cfg, logger, tracer, mesh_shape, device):
    """The (data x model) mesh driver on this rank (JAX's ``run_mesh``;
    see the module docstring); returns this rank's ``LM``.

    Every rank draws the same weights from ``--seed`` and keeps its block
    of each (``bb.init_lm`` on the installed model axis).  Step t's
    rollout on data rank r draws from ``fold_seed(fold_seed(seed, t),
    r)``, the port's ``fold_in(ks[i], me)`` with the step's key a
    function of the step, so a restored run continues the unbroken run's
    streams (JAX's restarts its key stream); every rank of a model group
    draws the same stream.  A window of ``--fuse-window`` steps ends in
    one all-reduce of its last step's metrics (JAX's ``pmean`` over
    'data').  The rollout step is a CUDA graph, its model-axis collectives
    captured, where the model axis is ``capturable`` (NCCL ranks, a card
    each, or M = 1), and eager on gloo; the update stays eager."""
    n_data, n_model = mesh_shape
    mesh = mesh_lib.install_2d(mesh_lib.make_2d_mesh(n_data, n_model,
                                                     device=device))
    try:
        return _mesh_steps(args, cfg, logger, tracer, mesh)
    finally:
        mesh_lib.install_2d(None)


def check_instances(cfg, n_model: int, device) -> None:
    """Raise, before any weight is drawn, where a model rank's attention
    would need a decode kernel instance that is not built: its local
    (head dim, query heads a KV head) on the kernel route."""
    if not cfg.n_heads or kernel_registry.backend_for(
            "attention", site="attention_decode",
            device=torch.device(device)) == "ref":
        return
    Hl, _, nk = kv_layout(cfg, n_model)
    need = (cfg.d_head, Hl // nk)
    if need not in DECODE_INSTANCES:
        raise ValueError(
            f"{cfg.name} on a model axis of {n_model}: a rank's decode "
            f"attention needs flash_attn_decode instance (dh, G) = {need}, "
            f"not built (csrc/flash_attention.cu: {sorted(DECODE_INSTANCES)})")


def _mesh_steps(args, cfg, logger, tracer, mesh):
    data, model = mesh.data, mesh.model
    if not data.distributed and mesh.size > 1:
        raise ValueError(f"run_mesh: a mesh of {mesh.size} ranks needs its "
                         "ranks (train.main spawns them)")
    if args.batch % data.size:
        raise SystemExit(f"--batch {args.batch} must divide by the data "
                         f"axis ({data.size})")
    local_batch = args.batch // data.size
    dev, lead = data.device, mesh.lead
    tp = model.size > 1
    # the rollout's only collectives are the model axis'
    graph = model.capturable
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if lead:
        how = ("CUDA graph" if dev.type == "cuda" else "eager (CPU)") \
            if graph else f"eager ({model.backend})"
        print(f"kernel backends: {kernel_registry.describe(dev)}; mesh "
              f"collectives: {data.backend}; rollout: {how}")
        print(f"mesh {data.size}x{model.size} over ('data', 'model'), "
              f"local batch {local_batch}, compress={args.compress or 'off'}")
    check_instances(cfg, model.size, dev)
    env = make_token_lm(vocab=cfg.vocab, episode_len=args.horizon,
                        device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = bb.init_lm(cfg, device=dev, generator=gen, dtype=F32,
                        requires_grad=True)
    pspecs = shd.param_pspecs(params, cfg)
    split = shd.model_split(params, cfg)
    # one int8 scale a JAX leaf, as JAX's compressor (its layers stacked)
    groups = jax_leaf_groups(list(pspecs), cfg)
    if args.compress and lead:
        wb = wire_bytes(list(params.parameters()), groups)
        print(f"int8 all-reduce payload: {wb['int8_bytes']:,} B/step "
              f"(fp32 {wb['fp32_bytes']:,} B, {wb['ratio']:.2f}x reduction)"
              + (" a model rank" if tp else ""))
    opt = cross_replica(adam(args.lr, grad_clip=1.0), data,
                        compress=args.compress, ef_shards=data.size,
                        scale_groups=groups, model=split)
    opt_state = opt.init(params.parameters())
    rollout = make_lm_rollout(cfg, env, local_batch, args.horizon,
                              device=dev, graph=graph)
    train_step = make_lm_ppo_train_step(cfg, opt, entropy_coeff=0.003,
                                        param_pspecs=pspecs)
    start = 0
    if args.restore and args.ckpt_dir and \
            latest_step(args.ckpt_dir) is not None:
        opt_state, manifest = restore_lm_checkpoint(
            args.ckpt_dir, params, opt_state, cfg, mesh=mesh)
        start = manifest["step"]
        if lead:
            print(f"restored step {start}")

    t0 = time.perf_counter()
    step = start
    while step < args.steps:
        chunk = min(args.fuse_window, args.steps - step)
        if args.ckpt_dir and args.ckpt_interval:
            nxt = step + args.ckpt_interval - (step % args.ckpt_interval)
            chunk = min(chunk, nxt - step)
        walls = {"rollout_s": 0.0, "update_s": 0.0, "allreduce_s": 0.0}
        if tp:
            walls["tp_allreduce_s"] = 0.0
        with tracer.span("mesh_window", step=step, iters=chunk):
            for t in range(step, step + chunk):
                gen.manual_seed(fold_seed(fold_seed(args.seed, t),
                                          data.index))
                with contextlib.ExitStack() as stack:
                    tp_wire = stack.enter_context(
                        mesh_lib.time_collectives(model.axis)) if tp else None
                    ta = time.perf_counter()
                    traj, v_last = rollout(params, gen)
                    sync(dev)
                    tb = time.perf_counter()
                    batch = build_batch(traj, v_last)
                    with mesh_lib.time_collectives(data.axis) as wire:
                        params, opt_state, metrics = train_step(
                            params, opt_state, batch)
                        sync(dev)
                walls["allreduce_s"] += wire.seconds()
                if tp:
                    walls["tp_allreduce_s"] += tp_wire.seconds()
                walls["rollout_s"] += tb - ta
                walls["update_s"] += time.perf_counter() - tb
            metrics = dict(metrics, avg_reward=torch.mean(traj["reward"]))
            names = list(metrics)
            means = data.pmean_all([metrics[k].reshape(()) for k in names])
        step += chunk
        sps = args.batch * args.horizon * chunk / max(
            time.perf_counter() - t0, 1e-9)
        mean = {k: float(v) for k, v in zip(names, means)}
        row = {"avg_reward": mean["avg_reward"], "loss": mean["loss"],
               "entropy": mean["entropy"], "samples_per_sec": sps}
        if "compress_err_norm" in mean:
            row["compress_err_norm"] = mean["compress_err_norm"]
            row["grad_norm_shard_max"] = mean["grad_norm_shard_max"]
        row.update(walls)
        with tracer.span("log", step=step):
            logger.record(step, row)
        tracer.memory_snapshot(f"window_{step}")
        tracer.flush()
        if _checkpoint_due(args, step):
            with tracer.span("checkpoint", step=step):
                save_lm_checkpoint(args.ckpt_dir, step, params, opt_state,
                                   cfg, mesh=mesh)
        t0 = time.perf_counter()
    return params


def _mesh_rank(mesh, argv):
    """One rank of a ``--mesh`` run that ``main`` spawned: ``main`` on
    the group ``spawn_ranks`` initialized."""
    main(argv)


def _spawn_mesh(args, argv, mesh_shape):
    """Check the mesh and the batch as ``run_mesh`` will, then run
    ``main(argv)`` on ``D x M`` spawned ranks; a rank that fails fails
    the run."""
    n_data, n_model = mesh_shape
    mesh = mesh_lib.make_2d_mesh(n_data, n_model, device=args.device)
    if args.batch % mesh.data.size:
        raise SystemExit(f"--batch {args.batch} must divide by the data "
                         f"axis ({mesh.data.size})")
    mesh_lib.spawn_ranks(_mesh_rank, mesh.size, (list(argv),),
                         device=args.device, timeout=math.inf,
                         collective_timeout=MESH_COLLECTIVE_TIMEOUT_S)


def _rank_log_dir(log_dir, rank: int):
    if log_dir is None or rank == 0:
        return log_dir
    return os.path.join(log_dir, f"rank_{rank}")


def main(argv=None):
    """Run ``--steps`` iterations; returns the trained ``LM`` (this rank's
    on a mesh; None where ``main`` spawned the ranks)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = build_parser()
    args = ap.parse_args(argv)
    mesh_shape = mesh_lib.parse_mesh_arg(args.mesh)
    if args.compress and mesh_shape is None:
        ap.error("--compress requires --mesh DATAxMODEL (e.g. --mesh 2x1)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           "pass --device cpu to run the plain versions")
    joined = dist.is_available() and dist.is_initialized()
    if mesh_shape is not None and not joined:
        return _spawn_mesh(args, argv, mesh_shape)
    rank = dist.get_rank() if mesh_shape is not None else 0
    log_dir = _rank_log_dir(args.log_dir, rank)
    tracer = trace.configure(os.path.join(log_dir, "trace.jsonl")
                             if log_dir else None)
    if args.kernels:
        kernel_registry.set_env(args.kernels)
    if mesh_shape is None:
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
    logger = Logger(log_dir, sinks=("console", "csv", "jsonl") if rank == 0
                    else ("csv", "jsonl"))
    try:
        with trace.chrome_trace(args.profile, log_dir, device,
                                "train_trace.json"):
            if mesh_shape is not None:
                return run_mesh(args, cfg, logger, tracer, mesh_shape,
                                device)
            return _run_single(args, cfg, logger, tracer, device)
    finally:
        logger.close()
        tracer.flush()


def _run_single(args, cfg, logger, tracer, device):
    """The single-device path: ``--steps`` iterations on ``device``."""
    env = make_token_lm(vocab=cfg.vocab, episode_len=args.horizon,
                        device=device)
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
    run = _run_windows if args.fuse_window > 1 else _run_steps
    run(args, rollout, train_step, params, opt_state, gen, start, logger,
        tracer, cfg, device)
    return params


if __name__ == "__main__":
    main()
