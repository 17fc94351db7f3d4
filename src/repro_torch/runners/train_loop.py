"""Synchronous training loop, port of ``repro/runners/train_loop.py`` in its
per-iteration form (JAX's ``fuse=False``).

On-policy (spec.mode == "rollout"): collect -> bootstrap value ->
``make_algo_batch`` -> update.  Replayed (spec.mode == "transition"):
collect -> insert -> k x (sample -> update -> priority update).  Each
iteration runs eagerly on the device of the sampler's generator.  The loop
is algorithm-agnostic: it consumes the algorithm's declarative
``BatchSpec`` (core/batch_spec.py) through ``make_algo_batch`` and, for
replayed algorithms, a ``ReplayLike`` backend (replay/interface.py).

The host reads device values only at window ends: a window runs to the
next log boundary.  With ``sentinels`` each iteration's Sentinels stay on
the device and the window's stack is read once at its end; with
``nan_guard`` that read names the first iteration whose params went
non-finite (``NonFiniteError`` and a ``nan_guard`` trace event).  No
iteration waits for the device.  ``drive``'s ``eval_sampler`` evaluates at
every log boundary on a generator forked from the training one, and the
log row gains its ``eval_*`` and the sentinels' ``sent_*`` columns.
With ``ckpt_dir`` and ``ckpt_interval`` a window also ends at every
checkpoint boundary, where ``drive`` saves the train state (or
``ckpt_payload(train_state, replay_state)``) in JAX's checkpoint format.

Not ported yet, each raising ``NotImplementedError`` that names its ROADMAP
Queue 1 item when asked for: the scan-fused window (``fuse=True``; CUDA
graphs over the iteration are its counterpart, item 14), and the SPMD mesh
and the compressed all-reduce (``mesh=``, ``compress=``; item 12).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from ..core.batch_spec import make_algo_batch
from ..core.tree import tree_stack
from ..replay.interface import ReplayLike
from ..samplers.eval import fold_seed
from ..telemetry import sentinels as sentinels_mod
from ..telemetry import trace
from ..telemetry.sentinels import NonFiniteError
from ..train.checkpoint import save_checkpoint
from ..utils.logger import Logger

EVAL_FORK = 0xE7A1  # the eval stream's fold-in constant, as in JAX


def _not_ported(what: str, item: str):
    return NotImplementedError(f"TrainLoop: {what} is not ported to "
                               f"repro_torch yet (ROADMAP Queue 1, {item})")


class TrainLoop:
    """Synchronous loop over sampler + algo (+ device replay)."""

    def __init__(self, sampler, algo, *, replay: Optional[ReplayLike] = None,
                 batch_size: Optional[int] = None,
                 updates_per_collect: int = 1, fuse: bool = False,
                 mesh=None, compress: Optional[str] = None,
                 sentinels: bool = False, nan_guard: bool = False):
        spec = algo.batch_spec
        if spec is None:
            raise ValueError(f"{type(algo).__name__} declares no BatchSpec")
        if fuse:
            raise _not_ported("the scan-fused window (fuse=True)",
                              "item 14, CUDA graphs over the iteration")
        if mesh is not None or compress:
            raise _not_ported("the SPMD mesh and compressed all-reduce",
                              "item 12")
        if spec.mode == "sequence":
            raise ValueError("sequence-mode algorithms (R2D1) need the host "
                             "sequence replay — use AsyncR2D1Runner")
        if spec.replayed:
            if replay is None or not replay.device_resident:
                raise ValueError("replayed algorithms need a device-resident "
                                 "ReplayLike")
            if batch_size is None:
                raise ValueError("replayed algorithms need batch_size")
        self.sampler, self.algo, self.spec = sampler, algo, spec
        self.replay = replay
        self.batch_size = batch_size
        self.k = updates_per_collect
        # nan_guard implies sentinels (the guard reads the nonfinite channel)
        self.nan_guard = nan_guard
        self.sentinels_on = sentinels or nan_guard
        self.tracer = trace.get_tracer()

    # -- one iteration -------------------------------------------------------
    def collect_insert(self, params, sampler_state, replay_state):
        sampler_state, batch = self.sampler.collect(params, sampler_state)
        replay_state = self.replay.insert(replay_state, batch)
        return sampler_state, replay_state

    def update_step(self, train_state, replay_state, generator, *, draws=None):
        """sample -> algo batch (with the IS weights) -> update -> priority
        update.  ``draws`` replaces the replay's random numbers (tests)."""
        mb, idx, w = self.replay.sample(replay_state, generator,
                                        self.batch_size, draws=draws)
        algo_batch = make_algo_batch(self.spec, mb, {"is_weights": w})
        train_state, info = self.algo.update(train_state, algo_batch, generator)
        replay_state = self.replay.update_priorities(
            replay_state, idx, *(info.extra[k] for k in self.spec.priority_keys))
        return train_state, replay_state, info

    def on_policy_update(self, train_state, sampler_state, batch, generator,
                         *, draws=None):
        """bootstrap value at the batch boundary -> algo batch -> update.
        ``draws`` replaces the algorithm's permutations (PPO; tests)."""
        bootstrap = self.sampler.bootstrap_value(train_state.params,
                                                 sampler_state)
        algo_batch = make_algo_batch(self.spec, batch,
                                     {"bootstrap_value": bootstrap})
        kw = {} if draws is None else {"perms": draws}
        return self.algo.update(train_state, algo_batch, generator, **kw)

    def iteration(self, train_state, sampler_state, replay_state, generator):
        """One iteration; returns (ts, ss, rs, info, sentinels-or-None)."""
        prev = None
        if self.sentinels_on:
            # the optimizer updates the params in place: keep a copy for
            # the update norm
            prev = pytree.tree_map(lambda p: p.detach().clone(),
                                   train_state.params)
        if self.spec.on_policy:
            sampler_state, batch = self.sampler.collect(train_state.params,
                                                        sampler_state)
            train_state, info = self.on_policy_update(
                train_state, sampler_state, batch, generator)
        else:
            sampler_state, replay_state = self.collect_insert(
                train_state.params, sampler_state, replay_state)
            info = None
            for _ in range(self.k):
                train_state, replay_state, info = self.update_step(
                    train_state, replay_state, generator)
        sent = None
        if self.sentinels_on:
            sent = sentinels_mod.compute(
                prev, train_state.params, info.loss, info.grad_norm,
                replay_state,
                self.sampler.horizon * self.sampler.n_envs)
        return train_state, sampler_state, replay_state, info, sent

    def run_window(self, train_state, sampler_state, replay_state, generator,
                   n: int):
        """``n`` iterations; returns (ts, ss, rs, last info, stacked
        sentinels or None).  Reads nothing on the host."""
        info, sents = None, []
        for _ in range(n):
            train_state, sampler_state, replay_state, info, sent = \
                self.iteration(train_state, sampler_state, replay_state,
                               generator)
            sents.append(sent)
        stacked = tree_stack(sents) if self.sentinels_on else None
        return train_state, sampler_state, replay_state, info, stacked

    # -- host driver -----------------------------------------------------------
    def drive(self, generator, train_state, sampler_state, replay_state, *,
              n_iterations: int, log_interval: int, logger: Logger,
              start_iter: int = 0, ckpt_dir: Optional[str] = None,
              ckpt_interval: int = 0,
              ckpt_payload: Optional[Callable] = None, eval_sampler=None):
        """Run windows to ``n_iterations``, logging one row every
        ``log_interval`` and saving a checkpoint every ``ckpt_interval``
        (with ``ckpt_dir``; its manifest's ``extra`` holds the iteration).
        Returns (ts, ss, rs, last_info).

        ``eval_sampler`` (samplers/eval.py) evaluates at every log
        boundary on a generator seeded ``fold_seed(fold_seed(s, 0xE7A1),
        it)`` from the training generator's seed ``s``: no training draw
        moves.  Its metrics land in the row under an ``eval_`` prefix."""
        steps_per_iter = self.sampler.horizon * self.sampler.n_envs
        eval_seed = fold_seed(generator.initial_seed(), EVAL_FORK)
        tracer = self.tracer
        t0 = time.time()
        since_log = 0
        last_info = None
        it = start_iter
        while it < n_iterations:
            boundary = it + log_interval - (it % log_interval)
            if ckpt_dir and ckpt_interval:
                boundary = min(boundary,
                               it + ckpt_interval - (it % ckpt_interval))
            boundary = min(boundary, n_iterations)
            with tracer.span("collect_train_window", iter_start=it,
                             iters=boundary - it):
                (train_state, sampler_state, replay_state, last_info,
                 sents) = self.run_window(train_state, sampler_state,
                                          replay_state, generator,
                                          boundary - it)
            if sents is not None and self.nan_guard:
                # the ONLY in-window read: one small stacked channel
                hit = sentinels_mod.first_nonfinite_iter(sents)
                if hit is not None:
                    bad_iter, n_bad = it + hit[0], hit[1]
                    tracer.emit("nan_guard", "train_loop",
                                iteration=bad_iter, n_bad=n_bad)
                    raise NonFiniteError(bad_iter, n_bad)
            since_log += boundary - it
            it = boundary
            if it % log_interval == 0:
                with tracer.span("log_boundary", iteration=it):
                    stats = self.sampler.traj_stats(sampler_state)
                    sampler_state = self.sampler.reset_stats(sampler_state)
                    if sampler_state.obs.is_cuda:
                        torch.cuda.synchronize(sampler_state.obs.device)
                    sps = steps_per_iter * since_log / max(
                        time.time() - t0, 1e-9)
                    extra = {k: v for k, v in last_info.extra.items()
                             if v.dim() == 0}
                    row = {"iter": it, "loss": last_info.loss,
                           "grad_norm": last_info.grad_norm,
                           "samples_per_sec": sps, **stats, **extra}
                    if sents is not None:
                        row.update(sentinels_mod.summarize(sents))
                    if eval_sampler is not None:
                        with tracer.span("eval", iteration=it):
                            gen = torch.Generator(
                                device=generator.device).manual_seed(
                                    fold_seed(eval_seed, it))
                            em = eval_sampler.run(train_state.params, gen)
                        row.update({f"eval_{k}": v for k, v in em.items()})
                    logger.record(it * steps_per_iter, row)
                tracer.memory_snapshot(f"log_boundary_{it}")
                t0, since_log = time.time(), 0
            if ckpt_dir and ckpt_interval and it % ckpt_interval == 0:
                with tracer.span("checkpoint", iteration=it):
                    payload = (train_state if ckpt_payload is None
                               else ckpt_payload(train_state, replay_state))
                    save_checkpoint(ckpt_dir, it, payload,
                                    extra={"iteration": it})
        return train_state, sampler_state, replay_state, last_info
