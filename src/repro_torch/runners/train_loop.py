"""Synchronous training loop, port of ``repro/runners/train_loop.py``.

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

``fuse=True`` (the default, as JAX's) is the counterpart of JAX's
scan-fused window.  JAX compiles ``log_interval`` iterations into one
``lax.scan``; the port captures ONE iteration (collect, then the on-policy
update, or insert plus k x (sample, update, priority update), sentinels
included) into a CUDA graph (core/graphs.py) and ``run_window`` replays it
once per iteration, so an iteration costs one launch from the host.  The
state (params, optimizer moments and counts, replay ring, sampler state)
stays at fixed addresses; every generator the iteration draws from is
registered with the graph, so a fused run draws the numbers an unfused run
draws and gives the same iterates bit for bit.  An algorithm whose update
branches on the host-side step (DQN's target copy, TD3's policy delay)
names the branch in ``update_variant(step)``; the loop keeps one graph per
tuple of branches an iteration takes and picks it on the host, which knows
the step without a sync.  The first iteration of each graph runs eagerly
(its warm-up), the second captures it.  The graph holds the generators of
its first iteration; a later run's (a runner run again) lend it their
state (``StepGraph.call_adopting``), so a second run from the same seed
repeats its draws fused as unfused.  On the CPU, which has no graphs,
the same body runs eagerly.  ``fuse=False`` runs ``iteration`` eagerly.

Data parallelism (paper §2.4 synchronous multi-GPU RL)
------------------------------------------------------
``mesh=`` / ``axis=`` run the same iteration on every rank of a
``launch.mesh.DataMesh`` (one process a rank, ``launch.mesh.spawn_ranks``):
each rank steps its env shard (``ShardedSampler.local_collect``), inserts
into and samples from its OWN ring of the device replay
(``DeviceReplay.init_sharded``; ``batch_size / n_shards`` a rank, drawn
from a generator that folds in the rank), and computes gradients on its
local batch.  The only traffic between ranks is the all-reduce of the
gradients (``train.optim.cross_replica`` wraps every Optimizer the
algorithm holds, on a copy of the algorithm), the summed episode stats,
the replicated metrics (``_replicate_info``) and sentinels
(``sentinels.replicate``).  Params and optimizer state stay replicated, so
the update IS the serial update on the concatenated batch: rlpyt's
"replicated model, all-reduced gradients".  ``compress="int8_ef"`` sends
the gradients in int8 with error feedback; the train state must then come
from the loop's wrapped algorithm (``loop.algo.init_train_state``).
``fuse=True`` on a mesh is JAX's default ``shard_map``'d window: on NCCL
ranks (a card each) one iteration's graph holds every collective above,
replayed as off the mesh, one graph a branch tuple; the rank's replay
generator is one per loop, a leaf of the graph's state re-seeded in
place.  The window's ends stay eager between replays (the log row's
reads, checkpoints behind rank 0's barrier, a restore copied into the
graph's state).  A gloo all-reduce cannot sit inside a CUDA graph, so a
mesh of gloo ranks on the card (ranks sharing a card) refuses
``fuse=True``; on the CPU, ``fuse=True`` is the same eager body.
"""
from __future__ import annotations

import copy
import time
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from ..core.batch_spec import make_algo_batch
from ..core.graphs import StepGraph
from ..core.tree import tree_stack
from ..replay.device import ReplayState
from ..replay.interface import ReplayLike
from ..samplers.eval import fold_seed
from ..telemetry import sentinels as sentinels_mod
from ..telemetry import trace
from ..telemetry.sentinels import NonFiniteError
from ..train.checkpoint import save_checkpoint
from ..train.optim import (CrossReplicaState, Optimizer, compress_metrics,
                           cross_replica, cross_replica_specs,
                           cross_replica_states)
from ..utils.logger import Logger

EVAL_FORK = 0xE7A1  # the eval stream's fold-in constant, as in JAX


class TrainLoop:
    """Synchronous loop over sampler + algo (+ device replay).

    With ``mesh`` / ``axis`` the loop runs on each rank of the mesh (see the
    module docstring); the sampler must then be a ShardedSampler (or expose
    ``local_collect`` / ``local_bootstrap``) on the same axis, and replayed
    algorithms shard both the replay state and the sample batch (each rank
    draws batch_size / n_shards).
    """

    def __init__(self, sampler, algo, *, replay: Optional[ReplayLike] = None,
                 batch_size: Optional[int] = None,
                 updates_per_collect: int = 1, fuse: bool = True,
                 mesh=None, axis: str = "data",
                 compress: Optional[str] = None,
                 sentinels: bool = False, nan_guard: bool = False):
        spec = algo.batch_spec
        if spec is None:
            raise ValueError(f"{type(algo).__name__} declares no BatchSpec")
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
        self.fuse = fuse
        self.mesh, self.axis = mesh, axis
        self.compress = compress
        if compress and mesh is None:
            raise ValueError("compress= needs a mesh (the compressed stage "
                             "is the data-axis gradient all-reduce)")
        # one StepGraph per tuple of update branches (see the docstring)
        self.graphs = {}
        # nan_guard implies sentinels (the guard reads the nonfinite channel)
        self.nan_guard = nan_guard
        self.sentinels_on = sentinels or nan_guard
        self.tracer = trace.get_tracer()
        self.n_shards = 1
        self._local_batch = batch_size
        self._shard_gen = None   # the rank's replay generator (a mesh)
        self._shard_key = None   # the (generator, seed) it was seeded for
        if mesh is not None:
            self._init_mesh(sampler, spec, batch_size)

    def _init_mesh(self, sampler, spec, batch_size):
        mesh, axis = self.mesh, self.axis
        if not hasattr(sampler, "local_collect"):
            raise ValueError("mesh mode needs a sharded sampler exposing "
                             "local_collect / local_bootstrap "
                             "(ShardedSampler)")
        if getattr(sampler, "axis", axis) != axis:
            raise ValueError(f"sampler shards over {sampler.axis!r} but "
                             f"TrainLoop was given axis={axis!r}")
        if mesh.axis != axis:
            raise ValueError(f"the mesh's axis is {mesh.axis!r}, TrainLoop "
                             f"was given axis={axis!r}")
        if self.fuse and mesh.device.type == "cuda" and not mesh.capturable:
            raise ValueError(
                "TrainLoop(mesh=..., fuse=True) on the card needs NCCL "
                "collectives (a card a rank), which a CUDA graph can hold; "
                f"this mesh's are {mesh.backend}'s, which run on the host "
                "(ranks sharing a card get gloo: NCCL refuses two ranks on "
                "one GPU); pass fuse=False")
        self.n_shards = mesh.shape[axis]
        if spec.replayed:
            if batch_size % self.n_shards:
                raise ValueError(f"batch_size {batch_size} not divisible "
                                 f"by {self.n_shards} shards")
            self._local_batch = batch_size // self.n_shards
        # the psum seam: every Optimizer the algorithm holds all-reduces its
        # grads over the mesh before stepping, so params / opt state stay
        # replicated and the update equals the global-batch update; no
        # algorithm changes its ``update``.  On a shallow copy: the
        # caller's algo must stay usable outside this mesh.
        self.algo = algo = copy.copy(self.algo)
        for name, val in list(vars(algo).items()):
            if isinstance(val, Optimizer):
                setattr(algo, name, cross_replica(
                    val, mesh, compress=self.compress,
                    ef_shards=self.n_shards))

    # -- one iteration -------------------------------------------------------
    def _collect(self, params, sampler_state):
        if self.mesh is None:
            return self.sampler.collect(params, sampler_state)
        return self.sampler.local_collect(params, sampler_state)

    def collect_insert(self, params, sampler_state, replay_state):
        """collect -> insert; on a mesh, into this rank's ring (the state
        as ``init_sharded`` gives it)."""
        if self.mesh is None:
            sampler_state, batch = self.sampler.collect(params, sampler_state)
            return sampler_state, self.replay.insert(replay_state, batch)
        sampler_state, batch = self.sampler.local_collect(params,
                                                          sampler_state)
        rs = self.replay.insert(self.replay.local_view(replay_state), batch)
        return sampler_state, self.replay.merge_view(rs)

    def _seed_shard(self, generator):
        """On a mesh, the rank's replay generator, seeded ``fold_seed(seed,
        rank)`` from the training generator's seed (JAX's ``fold_in(k_s,
        shard)``: draws decorrelate across ranks while the update's
        generator stays replicated); None off the mesh.  One generator a
        loop, so a graph holds it as a leaf of its state; it is seeded
        again, in place, for each training generator (a new ``run``) and
        each re-seed of one, so the same seed gives the same draws however
        often the loop is run.  Called on the host, outside the body."""
        if self.mesh is None or generator is None:
            return None
        key = (generator, generator.initial_seed())
        if self._shard_key != key:
            if self._shard_gen is None:
                self._shard_gen = torch.Generator(device=generator.device)
            self._shard_gen.manual_seed(fold_seed(key[1], self.mesh.index))
            self._shard_key = key
        return self._shard_gen

    def _sample_generator(self, generator):
        """The replay's generator: ``generator`` off the mesh, the rank's
        own on it (``_seed_shard``)."""
        if self.mesh is None:
            return generator
        if self._shard_gen is None:
            return self._seed_shard(generator)
        return self._shard_gen

    def update_step(self, train_state, replay_state, generator, *, draws=None):
        """sample -> algo batch (with the IS weights) -> update -> priority
        update.  ``draws`` replaces the replay's random numbers (tests)."""
        mb, idx, w = self.replay.sample(
            replay_state, self._sample_generator(generator),
            self._local_batch, draws=draws)
        algo_batch = make_algo_batch(self.spec, mb, {"is_weights": w})
        train_state, info = self.algo.update(train_state, algo_batch, generator)
        replay_state = self.replay.update_priorities(
            replay_state, idx, *(info.extra[k] for k in self.spec.priority_keys))
        return train_state, replay_state, info

    def on_policy_update(self, train_state, sampler_state, batch, generator,
                         *, draws=None):
        """bootstrap value at the batch boundary -> algo batch -> update.
        ``draws`` replaces the algorithm's permutations (PPO; tests)."""
        bootstrap = (self.sampler.bootstrap_value if self.mesh is None else
                     self.sampler.local_bootstrap)(train_state.params,
                                                   sampler_state)
        algo_batch = make_algo_batch(self.spec, batch,
                                     {"bootstrap_value": bootstrap})
        kw = {} if draws is None else {"perms": draws}
        return self.algo.update(train_state, algo_batch, generator, **kw)

    def iteration(self, train_state, sampler_state, replay_state, generator):
        """One iteration; returns (ts, ss, rs, info, sentinels-or-None)."""
        self._seed_shard(generator)
        return self._iteration(train_state, sampler_state, replay_state,
                               generator)

    def _iteration(self, train_state, sampler_state, replay_state,
                   generator):
        prev = None
        if self.sentinels_on:
            # the optimizer updates the params in place: keep a copy for
            # the update norm
            prev = pytree.tree_map(lambda p: p.detach().clone(),
                                   train_state.params)
        # on a mesh the replay state is this rank's block; its local view
        # shares the block's memory, so the in-place writes reach it
        local_rs = replay_state
        if self.mesh is not None and replay_state is not None:
            local_rs = self.replay.local_view(replay_state)
        sampler_state, batch = self._collect(train_state.params,
                                             sampler_state)
        if self.spec.on_policy:
            train_state, info = self.on_policy_update(
                train_state, sampler_state, batch, generator)
        else:
            local_rs = self.replay.insert(local_rs, batch)
            for _ in range(self.k):
                train_state, local_rs, info = self.update_step(
                    train_state, local_rs, generator)
        replay_state = local_rs
        if self.mesh is not None:
            info = self._replicate_info(info)
            if local_rs is not None:
                replay_state = self.replay.merge_view(local_rs)
        sent = None
        if self.sentinels_on:
            cm = compress_metrics(train_state.opt_state)
            sent = sentinels_mod.compute(
                prev, train_state.params, info.loss, info.grad_norm,
                local_rs,
                self.sampler.horizon * self.sampler.n_envs // self.n_shards,
                compress_err_norm=cm.get("compress_err_norm"),
                grad_norm_shard_max=cm.get("grad_norm_shard_max"))
            if self.mesh is not None:
                sent = sentinels_mod.replicate(sent, self.mesh)
        return train_state, sampler_state, replay_state, info, sent

    # -- the mesh's replicated values -----------------------------------------
    def _replicate_info(self, info):
        """Make the OptInfo replicated: scalar leaves (losses, means over the
        local batch) pmean to their global-batch value; batch-leading
        leaves (per-sample td_abs) gather to global width."""
        leaves, spec = pytree.tree_flatten(info)
        scalars = [i for i, x in enumerate(leaves) if x.dim() == 0]
        out = list(leaves)
        for i, x in zip(scalars, self.mesh.pmean_all(
                [leaves[i] for i in scalars])):
            out[i] = x
        for i, x in enumerate(leaves):
            if x.dim() > 0:
                out[i] = self.mesh.all_gather(x, dim=0)
        return pytree.tree_unflatten(out, spec)

    def _check_train_state(self, train_state):
        """A compressed loop's train state must carry the EF residual."""
        if not self.compress:
            return
        if not cross_replica_states(train_state.opt_state):
            raise ValueError(
                "compress= is set but the train state carries no error-"
                "feedback residual: initialize it through the loop's "
                "wrapped algo: loop.algo.init_train_state(...)")

    def checkpoint_specs(self, tree):
        """Which leaves of ``tree`` (a train state, a (train, replay) pair)
        are per rank on this loop's mesh, as the prefix tree
        ``train.checkpoint`` takes in ``shardings=``: the EF residuals and
        the replay rings; everything else replicated (None).  None without
        a mesh."""
        if self.mesh is None:
            return None
        node = lambda x: isinstance(x, (CrossReplicaState, ReplayState))
        return pytree.tree_map(
            lambda x: cross_replica_specs(self.mesh)
            if isinstance(x, CrossReplicaState) else
            self.replay.shard_spec(self.mesh) if isinstance(x, ReplayState)
            else None, tree, is_leaf=node)

    def _fused_body(self, train_state, sampler_state, replay_state,
                    generator, shard_generator):
        """``iteration``'s body; the rank's replay generator
        (``shard_generator``, None off the mesh) comes in as a leaf, so the
        graph registers it."""
        ts, ss, rs, info, sent = self._iteration(train_state, sampler_state,
                                                 replay_state, generator)
        return (ts, ss, rs, generator, shard_generator), (info, sent)

    def fused_iteration(self, train_state, sampler_state, replay_state,
                        generator):
        """One iteration through its graph (the same results as
        ``iteration``); returns (ts, ss, rs, info, sentinels-or-None).  The
        info and sentinels of a replay live in the graph's memory until the
        next call."""
        n_updates = 1 if self.spec.on_policy else self.k
        variant = getattr(self.algo, "update_variant", None)
        key = None if variant is None else tuple(
            variant(train_state.step + j + 1) for j in range(n_updates))
        graph = self.graphs.get(key)
        if graph is None:
            pools = [g.pool for g in self.graphs.values() if g.pool is not None]
            graph = self.graphs[key] = StepGraph(
                self._fused_body, device=generator.device,
                pool=pools[0] if pools else None,
                name=f"train_loop.iteration{'' if key is None else key}")
        step = train_state.step + n_updates
        (ts, ss, rs, *_), (info, sent) = graph.call_adopting(
            train_state, sampler_state, replay_state, generator,
            self._seed_shard(generator))
        if graph.graph is None and ts.step != step:
            raise RuntimeError(f"TrainLoop(fuse=True): {n_updates} updates "
                               f"moved the train step from "
                               f"{train_state.step} to {ts.step}")
        return ts._replace(step=step), ss, rs, info, sent

    def run_window(self, train_state, sampler_state, replay_state, generator,
                   n: int):
        """``n`` iterations; returns (ts, ss, rs, last info, stacked
        sentinels or None).  Reads nothing on the host (on a mesh, the
        collectives do).  Fused, each iteration is one graph replay; its
        sentinels are copied out before the next, and the last info once at
        the end."""
        if self.mesh is not None:
            self._check_train_state(train_state)
        step = self.fused_iteration if self.fuse else self.iteration
        info, sents = None, []
        for _ in range(n):
            train_state, sampler_state, replay_state, info, sent = step(
                train_state, sampler_state, replay_state, generator)
            if self.fuse and sent is not None:
                sent = pytree.tree_map(torch.clone, sent)
            sents.append(sent)
        if self.fuse and info is not None:
            info = pytree.tree_map(torch.clone, info)
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
                tracer.flush()
                t0, since_log = time.time(), 0
            if ckpt_dir and ckpt_interval and it % ckpt_interval == 0:
                with tracer.span("checkpoint", iteration=it):
                    payload = (train_state if ckpt_payload is None
                               else ckpt_payload(train_state, replay_state))
                    save_checkpoint(ckpt_dir, it, payload,
                                    extra={"iteration": it},
                                    shardings=self.checkpoint_specs(payload),
                                    mesh=self.mesh)
        return train_state, sampler_state, replay_state, last_info
