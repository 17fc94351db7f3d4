"""Decoupled asynchronous sampling/optimization (paper §2.3, Fig. 3), port of
``repro/runners/async_rl.py``.

rlpyt's asynchronous mode runs sampler and optimizer concurrently around a
double-buffered shared-memory replay with a memory-copier and a read/write
lock.  This runner reproduces that topology with threads:

- **actor thread**: the sampler free-runs against the most recently
  PUBLISHED parameters, copies each batch to host memory (the memory-copier
  role) and hands it into a ``_DoubleBuffer`` — an explicit N-slot
  (default 2) write/read ping-pong with back-pressure.
- **copier thread** (replayed modes): drains the double buffer into the host
  ``ReplayLike`` backend behind a ``LockedReplay`` view, so inserts and the
  learner's sampling interleave safely.
- **learner** (the calling thread): consumes batches continuously,
  throttled so consumption/generation never exceeds ``replay_ratio``, and
  publishes parameters every ``publish_interval`` updates through a
  versioned ``_ParamBus`` — so ``param_staleness`` (learner updates behind
  the batch's behavior policy) is measurable, not implicit.

Devices and streams.  ``devices`` (default: the ``device`` given to
``run``) go through ``launch.mesh.split_actor_learner``: actor on the last,
learner on the first, both on the one device when there is one.  On a CUDA
device the actor and the learner each issue their work on a
``torch.cuda.Stream`` of their own (the default stream is shared by every
thread).  Every tensor that crosses between them is ordered: batches, the
stored recurrent state and trajectory stats cross as host copies, and a
published snapshot carries an event that the actor's stream waits on (and
``record_stream`` marks the snapshot as used there).

Publication.  JAX publishes a host copy because its update donates its
input buffers.  The port's optimizers write the params IN PLACE, so a
published reference would change under the actor in the middle of a
collect.  The bus therefore holds a snapshot: a clone of the params made
on the learner's stream right after the publishing update, never a
reference.

Each thread owns its generator: the sampler state's (seed + 1) is the
actor's, the learner draws from its own (seed + 2); params and train state
come from a third (seed), as in the synchronous runners.  An actor or
copier error is re-raised in the learner.

Off-policy correction: with a publication cadence the actor's rollouts come
from stale parameters, which breaks the on-policy families.  For
rollout-mode algorithms (A2C/PPO) the learner applies V-trace
(train/vtrace.py) through the BatchSpec extras seam — the corrected targets
enter as a rewritten ``reward`` series, so no algorithm's update signature
changes.  DQN/QPG/R2D1 are off-policy already and reuse their replay
semantics.

``threaded=False`` degrades to a deterministic lockstep schedule (collect ->
insert -> throttled updates per iteration) used by the staleness-0
equivalence tests; both schedules share ONE run loop, including
checkpoint/restore (which rehydrates the host buffer from the
``replay_*.npz`` sidecar, or re-enforces ``min_replay`` warmup with a
warning when the sidecar is missing).  Checkpoints (JAX's format and
layout, train/checkpoint.py) and sidecars cross between the packages.
``stats`` has JAX's keys but
``recompile_events``: eager PyTorch compiles nothing
(telemetry/trace.py).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
import warnings
from collections import deque
from typing import Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core.batch_spec import make_algo_batch
from ..launch.mesh import split_actor_learner
from ..replay.host import SequenceReplayBuffer
from ..replay.interface import (HostSequenceReplay, HostTransitionReplay,
                                LockedReplay, host_tree)
from ..telemetry import trace
from ..train import vtrace as vtrace_lib
from ..train.checkpoint import (latest_step, restore_checkpoint,
                                save_checkpoint)
from ..utils.logger import Logger


def _device_tree(x, device):
    """Host tree -> tensors on ``device`` (``None`` stays)."""
    return pytree.tree_map(
        lambda leaf: None if leaf is None else
        torch.as_tensor(leaf).to(device), x)


def _side_stream(device):
    """A stream of its own on a CUDA ``device`` (ordered after the work
    already queued on the current one), None elsewhere."""
    if device.type != "cuda":
        return None
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    return stream


def _on(stream):
    return contextlib.nullcontext() if stream is None else \
        torch.cuda.stream(stream)


class _DoubleBuffer:
    """N-slot host hand-off between actor and consumer (paper's double
    buffer).  ``put`` blocks when all slots are written (back-pressure on the
    actor); ``get`` returns the oldest slot.  Wait times and depth are
    tracked for the idle-fraction/occupancy telemetry."""

    def __init__(self, n_slots: int = 2):
        self.n_slots = n_slots
        self._slots = deque()
        self._cv = threading.Condition()
        self._closed = False
        self.put_wait_s = 0.0
        self.get_wait_s = 0.0
        self.puts = 0
        self.gets = 0
        self._depth_sum = 0
        self._depth_obs = 0

    def put(self, item) -> bool:
        t0 = time.perf_counter()
        with self._cv:
            while len(self._slots) >= self.n_slots and not self._closed:
                self._cv.wait(0.05)
            if self._closed:
                return False
            self._slots.append(item)
            self.puts += 1
            self._depth_sum += len(self._slots)
            self._depth_obs += 1
            self._cv.notify_all()
        self.put_wait_s += time.perf_counter() - t0
        return True

    def get(self, timeout: float = 0.05):
        t0 = time.perf_counter()
        with self._cv:
            if not self._slots and not self._closed:
                self._cv.wait(timeout)
            item = self._slots.popleft() if self._slots else None
            if item is not None:
                self.gets += 1
                self._cv.notify_all()
        self.get_wait_s += time.perf_counter() - t0
        return item

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def depth(self) -> int:
        return len(self._slots)

    def occupancy(self) -> float:
        """Mean fraction of slots written, observed at each put."""
        return self._depth_sum / max(self._depth_obs, 1) / self.n_slots


class _ParamBus:
    """Versioned parameter publication from learner to actor.  ``version``
    counts publishes; ``updates`` stamps the learner-update count at publish
    time so staleness is measured in optimizer updates.  ``event`` (CUDA)
    marks the end of the snapshot's copy on the learner's stream."""

    def __init__(self, params, event=None):
        self._lock = threading.Lock()
        self._params, self._event = params, event
        self.version = 0
        self.updates = 0

    def publish(self, params, event, updates: int):
        with self._lock:
            self._params, self._event = params, event
            self.updates = updates
            self.version += 1

    def read(self):
        with self._lock:
            return self.version, self.updates, self._params, self._event


class AsyncRunner:
    """Transition-mode (DQN/QPG) and rollout-mode (A2C/PPO via V-trace)
    decoupled actor/learner; mode follows ``algo.batch_spec.mode``."""

    def __init__(self, sampler, algo, buffer=None, *, batch_size: int = None,
                 replay_ratio: float = 1.0, min_replay: int = 1000,
                 n_iterations: int = 100, log_interval: int = 10,
                 logger: Optional[Logger] = None,
                 ckpt_dir: Optional[str] = None, ckpt_interval: int = 0,
                 agent_state_kwargs: Optional[dict] = None,
                 threaded: bool = True, publish_interval: int = 1,
                 use_vtrace: Optional[bool] = None,
                 rho_bar: float = 1.0, c_bar: float = 1.0,
                 devices=None, db_slots: int = 2, drain: bool = False):
        self.sampler, self.algo, self.buffer = sampler, algo, buffer
        self.mode = algo.batch_spec.mode
        if self.mode == "rollout":
            if buffer is not None:
                raise ValueError("rollout mode consumes the double buffer: "
                                 "pass no replay buffer")
            self.replay = None
        else:
            if buffer is None or batch_size is None:
                raise ValueError("replayed modes need a host buffer and "
                                 "batch_size")
            self.replay = LockedReplay(self._make_replay(buffer))
        self.batch_size = batch_size
        self.replay_ratio = replay_ratio
        self.min_replay = min_replay
        self.n_iterations = n_iterations
        self.log_interval = log_interval
        self.logger = logger or Logger()
        self.ckpt_dir, self.ckpt_interval = ckpt_dir, ckpt_interval
        self.agent_state_kwargs = agent_state_kwargs or {}
        self.threaded = threaded
        self.publish_interval = max(int(publish_interval), 1)
        self.use_vtrace = (self.mode == "rollout") if use_vtrace is None \
            else use_vtrace
        self.rho_bar, self.c_bar = rho_bar, c_bar
        self.devices = devices
        self.db_slots = db_slots
        self.drain = drain
        self.steps_per_iter = sampler.horizon * sampler.n_envs
        self._samples_per_update = (self.steps_per_iter if self.mode ==
                                    "rollout" else self._consumed_per_update())
        self._rng_np = np.random.default_rng(0)
        self.tracer = trace.get_tracer()
        self.stats = {}               # filled at end of run()

    # -- mode hooks (overridden by AsyncR2D1Runner) ------------------------
    @staticmethod
    def _make_replay(buffer):
        return HostTransitionReplay(buffer)

    def _consumed_per_update(self) -> int:
        return self.batch_size

    def _collect_extras(self) -> dict:
        """Per-collect side data captured BEFORE the rollout (e.g. the R2D1
        stored recurrent state), as host copies; inserted alongside the
        batch."""
        return {}

    def _replay_ready(self) -> bool:
        return len(self.buffer) >= self.min_replay

    # -- learner programs ----------------------------------------------------
    def _rollout_update(self, train_state, rollout, boot, generator):
        """On-policy-family update on a (possibly stale) actor rollout:
        bootstrap + V-trace correction under CURRENT learner params, then the
        algorithm's unmodified update through its BatchSpec."""
        obs, prev_action, prev_reward, agent_state = boot
        with torch.no_grad():
            bootstrap_value = self.sampler.agent.value(
                train_state.params, obs, prev_action, prev_reward,
                agent_state)
        extras = {"bootstrap_value": bootstrap_value}
        if self.use_vtrace:
            extras.update(vtrace_lib.vtrace_extras(
                self.algo, train_state.params, rollout, bootstrap_value,
                rho_bar=self.rho_bar, c_bar=self.c_bar))
        batch = make_algo_batch(self.algo.batch_spec, rollout, extras)
        return self.algo.update(train_state, batch, generator)

    def _optimize(self, train_state, replay_state, generator):
        """One throttled optimizer turn: sample -> BatchSpec adapter ->
        update -> priority feedback.  Shared by both replay modes."""
        spec = self.algo.batch_spec
        hb, idx, w = self.replay.sample(replay_state, self._rng_np,
                                        self.batch_size)
        # only the fields the algorithm consumes cross to the device
        batch = _device_tree(make_algo_batch(spec, hb, {"is_weights": w}),
                             self.learner_device)
        train_state, info = self.algo.update(train_state, batch, generator)
        # priorities to the host first: no device wait under the lock
        priorities = host_tree([info.extra[k] for k in spec.priority_keys])
        self.replay.update_priorities(replay_state, idx, *priorities)
        return train_state, info

    def _snapshot(self, params):
        """A copy of ``params`` made on the learner's stream (the publisher
        is the learner) and, on CUDA, the event that marks its end."""
        snap = pytree.tree_map(lambda p: p.detach().clone(), params)
        if self._learner_stream is None:
            return snap, None
        event = torch.cuda.Event()
        event.record(self._learner_stream)
        return snap, event

    # -- actor side --------------------------------------------------------
    def _published_params(self):
        """The latest snapshot, usable on the actor's stream and device."""
        version, behavior_updates, params, event = self._bus.read()
        if event is not None:
            self._actor_stream.wait_event(event)
            for p in pytree.tree_leaves(params):
                p.record_stream(self._actor_stream)
        if self.actor_device != self.learner_device:
            params = pytree.tree_map(lambda p: p.to(self.actor_device),
                                     params)
        return version, behavior_updates, params

    def _actor_step(self, it: int):
        """One collect against published params; returns the host item for
        the double buffer and the wall time spent actively producing it."""
        with _on(self._actor_stream):
            version, behavior_updates, params = self._published_params()
            extras = self._collect_extras()
            t0 = time.perf_counter()
            with self.tracer.span("async.collect", iteration=it):
                state, batch = self.sampler.collect(params,
                                                    self._sampler_state)
                item = {"it": it, "version": version,
                        "behavior_updates": behavior_updates,
                        "batch": host_tree(batch), "extras": extras}
                if self.mode == "rollout":
                    item["boot"] = host_tree((state.obs, state.prev_action,
                                              state.prev_reward,
                                              state.agent_state))
                # the learner's log reads these host numbers, never the
                # actor's device tensors
                self._traj_host = host_tree(self.sampler.traj_stats(state))
                self._sampler_state = state
        return item, time.perf_counter() - t0

    def _actor_loop(self, start_iter: int):
        try:
            for it in range(start_iter, self.n_iterations):
                item, busy = self._actor_step(it)
                self._actor_busy_s += busy
                if not self._db.put(item):
                    return
        except BaseException as e:   # surface in the learner thread
            self._actor_error = e
            self._db.close()
        finally:
            self._actor_done.set()

    # -- copier side (replayed modes) --------------------------------------
    def _insert_item(self, item):
        with self.tracer.span("async.insert", iteration=item["it"]):
            self.replay.insert(self._replay_state, item["batch"],
                               **item["extras"])
        self._note_generated(item)

    def _copier_loop(self):
        try:
            while True:
                item = self._db.get(timeout=0.05)
                if item is None:
                    if self._actor_done.is_set() and self._db.depth() == 0:
                        return
                    continue
                self._insert_item(item)
        except BaseException as e:
            self._actor_error = self._actor_error or e
        finally:
            self._copier_done.set()

    # -- shared accounting -------------------------------------------------
    def _note_generated(self, item):
        with self._count_lock:
            self._generated += self.steps_per_iter
            self._iters_done = item["it"] + 1
            self._staleness_window.append(
                self._updates_done - item["behavior_updates"])

    def _note_update(self, info):
        self._last_info = info
        self._updates_done += 1
        self._consumed += self._samples_per_update
        if self._updates_done % self.publish_interval == 0:
            # a snapshot, never a reference: the optimizer steps in place
            snap, event = self._snapshot(self._train_state.params)
            self._bus.publish(snap, event, self._updates_done)

    def _throttle_ok(self) -> bool:
        return ((self._consumed + self._samples_per_update)
                / max(self._generated, 1) <= self.replay_ratio)

    # -- run loop (one loop for both runner classes and both schedules) ----
    def run(self, seed: int, params=None, restore: bool = False, *,
            device="cuda"):
        """Train from ``seed``; returns (train_state, sampler_state,
        last_info).  ``device`` is where actor and learner run unless the
        runner was given ``devices``; a CUDA device without a card raises."""
        devices = self.devices if self.devices is not None else [device]
        self.actor_device, self.learner_device = split_actor_learner(devices)
        for dev in (self.actor_device, self.learner_device):
            if dev.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("device cuda but no CUDA device is "
                                   "available; pass device='cpu' to run on "
                                   "the host")
        self._actor_stream = _side_stream(self.actor_device)
        self._learner_stream = _side_stream(self.learner_device)
        gen = torch.Generator(device=self.learner_device).manual_seed(seed)
        with _on(self._learner_stream):
            if params is None:
                params = self.sampler.agent.init_params(gen)
            train_state = self.algo.init_train_state(gen, params)
        with _on(self._actor_stream):
            self._sampler_state = self.sampler.init(
                torch.Generator(device=self.actor_device).manual_seed(
                    seed + 1), self.agent_state_kwargs)
            self._traj_host = host_tree(
                self.sampler.traj_stats(self._sampler_state))
        learner_gen = torch.Generator(
            device=self.learner_device).manual_seed(seed + 2)
        self._replay_state = self.replay.init() if self.replay else None

        self._generated, self._consumed, self._updates_done = 0, 0, 0
        start_iter = 0
        with _on(self._learner_stream):
            if restore and self.ckpt_dir and \
                    latest_step(self.ckpt_dir) is not None:
                train_state, start_iter = self._restore(train_state)
            self._train_state = train_state
            self._bus = _ParamBus(*self._snapshot(train_state.params))
        self._iters_done = start_iter
        updates0 = self._updates_done
        self._db = _DoubleBuffer(self.db_slots)
        self._staleness_window = []
        self._last_info = None
        self._last_stats = {"avg_return": 0.0, "avg_len": 0.0,
                            "episodes": 0.0}
        self._actor_busy_s = 0.0
        self._learner_busy_s = 0.0
        self._learner_idle_s = 0.0
        self._count_lock = threading.Lock()
        self._actor_error = None
        self._actor_done = threading.Event()
        self._copier_done = threading.Event()
        self._last_ckpt = -1
        L = self.log_interval
        self._next_log = (start_iter // L + 1) * L
        self._last_logged_iters = start_iter
        self._last_log_time = self._run_t0 = time.perf_counter()

        try:
            with _on(self._learner_stream):
                if self.threaded:
                    self._run_threaded(learner_gen, start_iter)
                else:
                    self._run_lockstep(learner_gen, start_iter)
        finally:
            # the caller reads the results on its own stream
            for dev in {self.actor_device, self.learner_device}:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)

        elapsed = max(time.perf_counter() - self._run_t0, 1e-9)
        self.stats = {
            "elapsed_s": elapsed,
            "samples_per_sec": (self._iters_done - start_iter)
            * self.steps_per_iter / elapsed,
            "updates": self._updates_done,
            "replay_ratio_actual": self._consumed / max(self._generated, 1),
            "overlap_frac": max(
                0.0, (self._actor_busy_s + self._learner_busy_s - elapsed)
                / elapsed),
            "publish_version": self._bus.version,
            # each thread's busy time per unit of its work, and its waits
            "collect_ms": self._actor_busy_s * 1e3
            / max(self._iters_done - start_iter, 1),
            "update_ms": self._learner_busy_s * 1e3
            / max(self._updates_done - updates0, 1),
            "actor_put_wait_s": self._db.put_wait_s,
            "learner_idle_s": self._learner_idle_s,
        }
        return self._train_state, self._sampler_state, self._last_info

    def update_once(self, generator):
        """One more learner update after ``run`` (replay modes): sample the
        buffer as the run left it, upload, update, write the priorities back,
        on the learner's stream; returns its OptInfo."""
        if self.replay is None:
            raise ValueError("update_once: rollout mode has no replay")
        with _on(self._learner_stream):
            self._train_state, info = self._optimize(
                self._train_state, self._replay_state, generator)
        return info

    def _run_lockstep(self, generator, start_iter: int):
        """Deterministic schedule: collect -> insert -> throttled updates,
        one iteration at a time (used for equivalence tests)."""
        for it in range(start_iter, self.n_iterations):
            item, busy = self._actor_step(it)
            self._actor_busy_s += busy
            if self.mode == "rollout":
                self._note_generated(item)
                self._learner_consume_rollout(item, generator)
            else:
                self._insert_item(item)
                with self.tracer.span("async.optimize", iteration=it):
                    while self._replay_ready() and self._throttle_ok():
                        self._learner_update_replayed(generator)
            self._boundaries()

    def _run_threaded(self, generator, start_iter: int):
        actor = threading.Thread(target=self._actor_loop, args=(start_iter,),
                                 name="async-actor", daemon=True)
        copier = None
        if self.mode != "rollout":
            copier = threading.Thread(target=self._copier_loop,
                                      name="async-copier", daemon=True)
        else:
            self._copier_done.set()
        actor.start()
        if copier:
            copier.start()
        try:
            if self.mode == "rollout":
                self._learner_loop_rollout(generator)
            else:
                self._learner_loop_replayed(generator)
        finally:
            self._db.close()
            actor.join(timeout=30.0)
            if copier:
                copier.join(timeout=30.0)
        if self._actor_error is not None:
            raise self._actor_error
        if actor.is_alive() or (copier and copier.is_alive()):
            raise RuntimeError("async runner: the actor or copier thread "
                               "did not stop within 30 s")

    # -- learner side ------------------------------------------------------
    def _learner_consume_rollout(self, item, generator):
        t0 = time.perf_counter()
        with self.tracer.span("async.optimize", iteration=item["it"]):
            dev = self.learner_device
            self._train_state, info = self._rollout_update(
                self._train_state, _device_tree(item["batch"], dev),
                _device_tree(item["boot"], dev), generator)
        self._learner_busy_s += time.perf_counter() - t0
        self._note_update(info)

    def _learner_update_replayed(self, generator):
        t0 = time.perf_counter()
        self._train_state, info = self._optimize(self._train_state,
                                                 self._replay_state, generator)
        self._learner_busy_s += time.perf_counter() - t0
        self._note_update(info)

    def _learner_loop_rollout(self, generator):
        """Threaded on-policy family: one V-trace-corrected update per
        collected rollout, in arrival order."""
        while True:
            if self._actor_error is not None:
                return
            t0 = time.perf_counter()
            item = self._db.get(timeout=0.05)
            if item is None:
                if self._actor_done.is_set() and self._db.depth() == 0:
                    return
                self._learner_idle_s += time.perf_counter() - t0
                continue
            self._note_generated(item)
            self._learner_consume_rollout(item, generator)
            self._boundaries()

    def _learner_loop_replayed(self, generator):
        """Threaded replayed modes: update whenever the buffer is warm and
        the replay-ratio throttle allows; otherwise idle briefly."""
        while True:
            if self._actor_error is not None:
                return
            can = self._replay_ready() and self._throttle_ok()
            pipeline_done = (self._actor_done.is_set()
                             and self._copier_done.is_set())
            if can and (not pipeline_done or self.drain):
                self._learner_update_replayed(generator)
            elif pipeline_done:
                break
            else:
                time.sleep(0.002)
                self._learner_idle_s += 0.002
            self._boundaries()

    # -- logging / checkpoint boundaries -----------------------------------
    def _traj_window(self):
        """Per-window trajectory stats from cumulative sampler accumulators
        (delta-based: no reset, so the learner never races the actor for a
        write into the sampler state; it reads the actor's host copy)."""
        cur = {k: float(v) for k, v in self._traj_host.items()}
        n_prev, n_cur = self._last_stats["episodes"], cur["episodes"]
        dn = n_cur - n_prev
        out = {"episodes": dn}
        for key in ("avg_return", "avg_len"):
            s_cur = cur[key] * max(n_cur, 1.0)
            s_prev = self._last_stats[key] * max(n_prev, 1.0)
            out[key] = (s_cur - s_prev) / max(dn, 1.0)
        self._last_stats = cur
        return out

    def _boundaries(self):
        while self._iters_done >= self._next_log:
            self._log_window(self._next_log)
            self._next_log += self.log_interval
        if self.ckpt_dir and self.ckpt_interval:
            it = self._iters_done
            if it % self.ckpt_interval == 0 and it > self._last_ckpt:
                self._last_ckpt = it
                self._save_ckpt(it)

    def _log_window(self, boundary: int):
        now = time.perf_counter()
        dt = max(now - self._last_log_time, 1e-9)
        d_iters = self._iters_done - self._last_logged_iters
        sps = d_iters * self.steps_per_iter / dt
        self._last_log_time = now
        self._last_logged_iters = self._iters_done
        with self._count_lock:
            stale = self._staleness_window
            self._staleness_window = []
        elapsed = max(now - self._run_t0, 1e-9)
        info = self._last_info
        if info is None:      # still warming up the replay: skip the row
            return
        extra = {k: float(v) for k, v in info.extra.items() if v.dim() == 0}
        row = {
            "iter": boundary, "loss": float(info.loss),
            "replay_ratio_actual": self._consumed / max(self._generated, 1),
            "samples_per_sec": sps,
            "param_staleness_mean": float(np.mean(stale)) if stale else 0.0,
            "param_staleness_max": float(np.max(stale)) if stale else 0.0,
            "publish_version": self._bus.version,
            "db_occupancy": self._db.occupancy(),
            "queue_depth": self._db.depth(),
            "actor_idle_frac": min(self._db.put_wait_s / elapsed, 1.0),
            "learner_idle_frac": min(self._learner_idle_s / elapsed, 1.0),
            "overlap_frac": max(0.0, (self._actor_busy_s +
                                      self._learner_busy_s - elapsed)
                                / elapsed),
            **self._traj_window(), **extra,
        }
        self.logger.record(boundary * self.steps_per_iter, row)
        self.tracer.memory_snapshot(f"async_log_{boundary}")
        self.tracer.flush()

    # -- checkpoint / restore ----------------------------------------------
    def _replay_path(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"replay_{step:08d}.npz")

    def _save_ckpt(self, it: int):
        extra = {"iteration": it, "generated": self._generated,
                 "consumed": self._consumed, "updates": self._updates_done,
                 "publish_version": self._bus.version}
        os.makedirs(self.ckpt_dir, exist_ok=True)
        if self.buffer is not None:
            extra["buffer_t"] = self.buffer.t
            extra["buffer_filled"] = self.buffer.filled
            with self.replay.lock:
                state = self.buffer.state_dict()
            tmp = self._replay_path(it) + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, **state)
            os.replace(tmp, self._replay_path(it))
        save_checkpoint(self.ckpt_dir, it, self._train_state, extra=extra)

    def _restore(self, train_state):
        step = latest_step(self.ckpt_dir)
        train_state, manifest = restore_checkpoint(self.ckpt_dir,
                                                   train_state)
        extra = manifest["extra"]
        start_iter = extra.get("iteration", 0)
        self._generated = extra.get("generated",
                                    start_iter * self.steps_per_iter)
        self._consumed = extra.get("consumed", 0)
        self._updates_done = extra.get("updates", 0)
        if self.buffer is not None:
            path = self._replay_path(step)
            if os.path.exists(path):
                with np.load(path) as d:
                    self.buffer.load_state_dict(d)
            else:
                warnings.warn(
                    "async restore: no replay sidecar at "
                    f"{path}; resuming with an empty buffer and re-enforcing "
                    f"the min_replay={self.min_replay} warmup")
        return train_state, start_iter


class AsyncR2D1Runner(AsyncRunner):
    """Sequence-mode async runner: R2D1 (paper §3.2).

    The sampler horizon must equal the replay ``state_interval`` so the
    recurrent state captured at batch start is the stored initial state for
    the block (periodic storage).  Priorities update with the R2D2 mixture.
    Shares the base run loop — threading, throttling, logging, AND
    checkpoint/restore — differing only in the replay wrapper, the per-update
    sample accounting (sequences x seq_len), and the stored-state capture.
    """

    def __init__(self, sampler, algo, buffer: SequenceReplayBuffer, **kw):
        if sampler.horizon != buffer.state_interval:
            raise ValueError(
                f"horizon {sampler.horizon} must equal state_interval "
                f"{buffer.state_interval} for stored-state alignment")
        super().__init__(sampler, algo, buffer, **kw)

    @staticmethod
    def _make_replay(buffer):
        return HostSequenceReplay(buffer)

    def _consumed_per_update(self) -> int:
        return self.batch_size * self.buffer.seq_len

    def _collect_extras(self) -> dict:
        # a synchronous host copy, taken before the collect moves the
        # sampler state on
        state = self.sampler.full_agent_state(self._sampler_state)["lstm"]
        return {"init_state": host_tree(state)}

    def _replay_ready(self) -> bool:
        return (self.buffer.tree.total > 0
                and len_filled(self.buffer) >= self.min_replay)


def len_filled(buffer) -> int:
    return buffer.filled * buffer.B
