"""Synchronous training loop, port of ``repro/runners/train_loop.py`` in its
per-iteration form (JAX's ``fuse=False``).

One iteration is collect -> insert -> k x (sample -> update -> priority
update), eager, on the device of the sampler's generator; the host reads
device values only at log boundaries.  The loop is algorithm-agnostic over
replayed algorithms: it consumes the algorithm's declarative ``BatchSpec``
(core/batch_spec.py) through ``make_algo_batch`` and a ``ReplayLike``
backend (replay/interface.py).

Not ported yet, each raising ``NotImplementedError`` that names its ROADMAP
Queue 1 item when asked for: the scan-fused window (``fuse=True``; CUDA
graphs over the iteration are its counterpart, item 14), the SPMD mesh and
the compressed all-reduce (``mesh=``, ``compress=``; item 12), and from
slice 3 part 2 the on-policy iteration (A2C, PPO), periodic evaluation, the
sentinels and NaN guard, and checkpoints.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from ..core.batch_spec import make_algo_batch
from ..replay.interface import ReplayLike
from ..telemetry import trace
from ..utils.logger import Logger


def _not_ported(what: str, item: str):
    return NotImplementedError(f"TrainLoop: {what} is not ported to "
                               f"repro_torch yet (ROADMAP Queue 1, {item})")


class TrainLoop:
    """Synchronous loop over sampler + replayed algo + device replay."""

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
        if sentinels or nan_guard:
            raise _not_ported("sentinels and the NaN guard",
                              "slice 3 part 2, item 6")
        if spec.on_policy:
            raise _not_ported("the on-policy iteration (A2C, PPO)",
                              "slice 3 part 2, item 4")
        if spec.mode == "sequence":
            raise ValueError("sequence-mode algorithms (R2D1) need the host "
                             "sequence replay")
        if replay is None or not replay.device_resident:
            raise ValueError("replayed algorithms need a device-resident "
                             "ReplayLike")
        if batch_size is None:
            raise ValueError("replayed algorithms need batch_size")
        self.sampler, self.algo, self.spec = sampler, algo, spec
        self.replay = replay
        self.batch_size = batch_size
        self.k = updates_per_collect
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

    def iteration(self, train_state, sampler_state, replay_state, generator):
        sampler_state, replay_state = self.collect_insert(
            train_state.params, sampler_state, replay_state)
        info = None
        for _ in range(self.k):
            train_state, replay_state, info = self.update_step(
                train_state, replay_state, generator)
        return train_state, sampler_state, replay_state, info

    # -- host driver -----------------------------------------------------------
    def drive(self, generator, train_state, sampler_state, replay_state, *,
              n_iterations: int, log_interval: int, logger: Logger,
              start_iter: int = 0, ckpt_dir: Optional[str] = None,
              ckpt_interval: int = 0, eval_sampler=None):
        """Run iterations to ``n_iterations``, logging one row every
        ``log_interval``.  Returns (ts, ss, rs, last_info)."""
        if ckpt_dir or ckpt_interval:
            raise _not_ported("checkpointing", "slice 3 part 2, item 8")
        if eval_sampler is not None:
            raise _not_ported("periodic evaluation (samplers/eval.py)",
                              "slice 3 part 2, item 5")
        steps_per_iter = self.sampler.horizon * self.sampler.n_envs
        tracer = self.tracer
        t0 = time.time()
        since_log = 0
        last_info = None
        it = start_iter
        while it < n_iterations:
            boundary = min(it + log_interval - (it % log_interval), n_iterations)
            with tracer.span("collect_train_window", iter_start=it,
                             iters=boundary - it):
                for _ in range(boundary - it):
                    train_state, sampler_state, replay_state, last_info = \
                        self.iteration(train_state, sampler_state,
                                       replay_state, generator)
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
                    logger.record(it * steps_per_iter, row)
                tracer.memory_snapshot(f"log_boundary_{it}")
                t0, since_log = time.time(), 0
        return train_state, sampler_state, replay_state, last_info
