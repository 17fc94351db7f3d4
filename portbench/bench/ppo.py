"""The LM-PPO cell: the single-device iteration of the program's
``launch/train.py`` (``make_lm_rollout`` -> ``build_batch`` ->
``make_lm_ppo_train_step``), driven by the benchmark.

Set-up builds one training object (weights and environment table from the
seed, Adam's state, the rollout with its graphed decode step, the train
step) and drives it through ``check_steps`` iterations, recording what the
reference follows: each rollout's tokens, actions, log-probabilities,
values, rewards and episode ends, each step's loss, the first gradient a
leaf as Adam's first moment holds it, and each leaf's change over the
steps.  The same object then runs the window: whole iterations until
``--seconds`` have passed.  With ``--trace 1`` one more iteration runs
under the profiler.  Then the program's state is freed and the reference
follows the check steps from the same weights.
"""
from __future__ import annotations

import gc
import math
import sys
import time
import types

import torch

from reference import compare, ppo as ref_ppo

from . import weights as W
from .devtrace import DeviceTrace

F32 = torch.float32
ROLL_KEYS = ("tokens", "actions", "logp", "value", "reward", "done")
# the train step's readings of each check step (its ``metrics``)
LOSS_KEYS = ("loss", "pi_loss", "v_loss", "grad_norm")


def program_pieces(cfg, env, mix, dev):
    """(rollout, train_step, optimizer) as ``launch/train.py`` builds them
    for one device."""
    from repro_torch.algos.pg.ppo import make_lm_ppo_train_step
    from repro_torch.launch.train import make_lm_rollout
    from repro_torch.train.optim import adam
    opt = adam(mix["lr"], b1=mix["adam_b1"], b2=mix["adam_b2"],
               eps=mix["adam_eps"], grad_clip=mix["grad_clip"])
    rollout = make_lm_rollout(cfg, env, mix["batch"], mix["horizon"],
                              mix["temperature"], device=dev)
    step = make_lm_ppo_train_step(cfg, opt, clip_eps=mix["clip_eps"],
                                  value_coeff=mix["value_coeff"],
                                  entropy_coeff=mix["entropy_coeff"])
    return rollout, step, opt


def note(ctx, what):
    print(f"portbench: {what} at {time.perf_counter() - ctx.t_process:.2f} s",
          file=sys.stderr, flush=True)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build(ctx):
    """The training object, made from the seed."""
    from repro_torch.envs.token_lm import make_token_lm
    from repro_torch.models import backbones as bb
    from repro_torch.models.config import ModelConfig

    mix, dev = ctx.mix, ctx.device
    cfg = ModelConfig(**ctx.model)
    s = types.SimpleNamespace(cfg=cfg)
    s.shapes = W.leaf_shapes(bb.LM(cfg, device="meta", dtype=F32))
    s.lm = bb.LM(cfg, device="meta", dtype=F32)
    W.install(s.lm, W.make_weights(s.shapes, ctx.model, ctx.seed, dev), True)
    note(ctx, "weights made")
    s.chain = W.chain_logp(ctx.seed, cfg.vocab, dev)
    s.env = make_token_lm(vocab=cfg.vocab, episode_len=mix["horizon"],
                          device=dev, chain_logp=s.chain)
    s.gen = torch.Generator(device=dev).manual_seed(W.sub_seed(ctx.seed, 2))
    s.rollout, s.train_step, s.opt = program_pieces(cfg, s.env, mix, dev)
    s.opt_state = s.opt.init(s.lm.parameters())
    return s


def step(s):
    """One iteration through the window's own calls; returns (traj,
    metrics, rollout seconds, update seconds)."""
    from repro_torch.launch.train import build_batch
    dev = s.gen.device
    ta = time.perf_counter()
    traj, v_last = s.rollout(s.lm, s.gen)
    sync(dev)
    tb = time.perf_counter()
    batch = build_batch(traj, v_last)
    s.lm, s.opt_state, met = s.train_step(s.lm, s.opt_state, batch)
    sync(dev)
    return traj, met, tb - ta, time.perf_counter() - tb


def check_steps(ctx, s):
    """The first ``check_steps`` iterations, with what the reference
    follows and judges."""
    names = [n for n, _ in s.lm.named_parameters()]
    read = {k: [] for k in ROLL_KEYS + LOSS_KEYS}
    for k in range(ctx.mix["check_steps"]):
        traj, met, _, _ = step(s)
        for key in ROLL_KEYS:
            read[key].append(traj[key].clone())
        for key in LOSS_KEYS:
            read[key].append(float(met[key]))
        if k == 0:
            read["grad1"] = {n: float(mu.norm()) / (1 - ctx.mix["adam_b1"])
                             for n, mu in zip(names, s.opt_state.mu)}
    with torch.no_grad():
        w0 = W.make_weights(s.shapes, ctx.model, ctx.seed, ctx.device)
        read["change"] = {n: float((p.detach() - w0[n]).norm())
                          for n, p in s.lm.named_parameters()}
        del w0
    gc.collect()
    return read


def reference(ctx, s, read, prec):
    """The reference's readings of the check steps, from the seed's
    weights and the program's sampled tokens and actions."""
    w0 = W.make_weights(s.shapes, ctx.model, ctx.seed, ctx.device)
    rollouts = [{"tokens": t, "actions": a, "done": d}
                for t, a, d in zip(read["tokens"], read["actions"],
                                   read["done"])]
    ref = ref_ppo.steps(ctx.model, w0, rollouts, s.chain, ctx.mix, prec)
    del w0
    for key in ("tokens", "actions", "done"):
        ref[key] = read[key]
    return ref


def episode_starts(done):
    """(T, B) True at the first position of each episode: t = 0 and the
    step after an episode ended."""
    starts = torch.zeros_like(done, dtype=torch.bool)
    starts[0] = True
    starts[1:] = done[:-1].bool()
    return starts


def rollout_gaps(read, ref, k=0):
    """(|logp gap|, |value gap| over the reference's std) of rollout ``k``
    at every position but an episode's first: a gated norm there divides
    a tiny dt.C.B.x, so rounding moves it by up to a unit in sound runs
    and in the control alike."""
    keep = ~episode_starts(ref["done"][k])
    v = ref["value"][k]
    return ((read["logp"][k] - ref["logp"][k]).abs()[keep],
            (read["value"][k] - v).abs()[keep] / max(float(v.std()), 1e-30))


def _q(t, q):
    return float(torch.quantile(t.flatten().float(), q))


def numbers(read, ref):
    """The gaps between one side's readings and the reference's: every
    step's loss (relative) and its policy part (absolute: it is near 0,
    since a step's loss is taken at the weights that sampled, and it moves
    most when the update reads other rows than the batch's); the first
    rollout's log-probabilities and values (the 99th percentile over every
    position but an episode's first); the median leaf's first gradient;
    the worst moving leaf's change over the steps; the environment's
    rewards, token hand-over and episode ends, exactly."""
    env_faults = 0
    for tok, act, rew, done, want in zip(read["tokens"], read["actions"],
                                         read["reward"], read["done"],
                                         ref["reward"]):
        env_faults += int((rew != want).sum())
        cont = ~done[:-1]
        env_faults += int((tok[1:][cont] != act[:-1][cont]).sum())
        ends = torch.zeros_like(done)
        ends[-1] = True
        env_faults += int((done != ends).sum())
    lp, val = rollout_gaps(read, ref)
    return {
        "loss_gap": max(compare.rel_gap(p, r)
                        for p, r in zip(read["loss"], ref["loss"])),
        "pi_loss_gap": max(abs(p - r) for p, r in zip(read["pi_loss"],
                                                      ref["pi_loss"])),
        "grad_gap": compare.leaf_gap(read["grad1"], ref["grad1"],
                                     worst=False),
        "change_gap": compare.leaf_gap(
            read["change"], ref["change"],
            compare.moving_leaves(ref["grad1"])),
        "logp_gap": _q(lp, 0.99),
        "value_gap": _q(val, 0.99),
        "env_mismatches": float(env_faults),
    }


def diagnostics(read, ref):
    """What the numbers leave out, for the readings that set limits: the
    first positions' gaps, the widest gaps and the 99.9th percentiles past
    them, the value loss and the gradient's global norm, the worst leaf's
    first gradient, the later rollouts."""
    lp, val = rollout_gaps(read, ref)
    v0 = ref["value"][0]
    starts = episode_starts(ref["done"][0])
    return {
        "logp_start_max": float((read["logp"][0] - ref["logp"][0])
                                .abs()[starts].max()),
        "value_start_max": float((read["value"][0] - v0).abs()[starts].max()
                                 / v0.std()),
        "logp_max": float(lp.max()), "logp_q999": _q(lp, 0.999),
        "value_max": float(val.max()), "value_q999": _q(val, 0.999),
        "v_loss_gap": max(compare.rel_gap(p, r) for p, r in
                          zip(read["v_loss"], ref["v_loss"])),
        "grad_norm_gap": max(compare.rel_gap(p, r) for p, r in
                             zip(read["grad_norm"], ref["grad_norm"])),
        "grad_worst": compare.leaf_gap(read["grad1"], ref["grad1"]),
        "logp_q99_later": [_q(rollout_gaps(read, ref, k)[0], 0.99)
                           for k in range(1, len(ref["logp"]))],
    }


def free(s):
    """Drop the program's state; the seed's environment table stays."""
    for k in ("lm", "opt", "opt_state", "rollout", "train_step", "env"):
        setattr(s, k, None)
    gc.collect()
    if s.gen.device.type == "cuda":
        torch.cuda.empty_cache()


def run(ctx):
    mix, dev = ctx.mix, ctx.device
    B, T = mix["batch"], mix["horizon"]
    s = build(ctx)
    note(ctx, "built")
    read = check_steps(ctx, s)
    note(ctx, f"{mix['check_steps']} check steps done")

    # set-up's objects out of the collector's way: no pass over them
    # inside the window
    gc.collect()
    gc.freeze()
    sync(dev)
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_process
    roll_s, upd_s = [], []
    while True:
        _, met, tr, tu = step(s)
        roll_s.append(tr)
        upd_s.append(tu)
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    wall = time.perf_counter() - t0
    failed = int(not math.isfinite(float(met["loss"])))

    trace = None
    if ctx.trace:
        from repro_torch.launch.train import build_batch
        trace = DeviceTrace(dev)
        trace.start()
        with trace.span("step"):
            with trace.span("rollout"):
                traj, v_last = s.rollout(s.lm, s.gen)
            with trace.span("gae"):
                batch = build_batch(traj, v_last)
            with trace.span("update"):
                s.lm, s.opt_state, _ = s.train_step(s.lm, s.opt_state,
                                                    batch)
        trace.stop()
        del traj, v_last, batch
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    note(ctx, f"window of {len(roll_s)} steps done: steps "
              f"{[round(a + b, 4) for a, b in zip(roll_s, upd_s)]} s")
    gc.unfreeze()
    free(s)
    values = numbers(read, reference(ctx, s, read, "f32"))
    note(ctx, "reference done")
    s.chain = None
    ok, checks = compare.judge(values, ctx.limits)
    n = len(roll_s)
    return {
        "e2e": {"ppo_samples_per_s": B * T * n / wall, "setup_s": setup_s},
        "rec": {
            "spans": {"rollout_s": roll_s, "update_s": upd_s},
            "counters": {"steps": n, "wall_s": wall, "batch": B,
                         "horizon": T,
                         "model_flops": 8 * ctx.token_params * B * T * n},
            "trace": trace,
        },
        "attempted": n, "failed": failed, "correct": ok and failed == 0,
        "checks": checks, "memory_peak_bytes": peak,
        "trace_window": trace.window("step") if trace else None,
    }
