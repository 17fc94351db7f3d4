"""Host (numpy) replay buffers — the paper's preallocated shared-memory
samples buffers, written in-place through namedarraytuple __setitem__.
Port of ``repro/replay/host.py``.

Layout follows rlpyt: storage is [T_size, B_envs] time-major ring per env
column; samplers append (T, B) blocks; sampling addresses (t_idx, b_idx)
pairs.  Supported options (paper §1.1): n-step returns, prioritized replay
(sum tree), sequence replay for recurrence with periodic recurrent-state
storage, frame-based buffer storing only unique frames.

Storage, sampling and the sum tree stay numpy on the host, as in JAX, so
that for the same ``np.random.Generator`` every buffer draws the JAX
package's indices, weights and batches bit for bit, and ``state_dict``
writes the same keys (``samples_{i}``, ``states_{i}``, ... numbered in
JAX's leaf order, dict keys sorted): a ``replay_*.npz`` sidecar written by
either package loads into the other.  The runner copies device batches to
the host before inserting (``replay/interface.py::host_tree``).
"""
from __future__ import annotations

import numpy as np
from torch.utils import _pytree as pytree

from ..core.narrtup import namedarraytuple, buffer_from_example
from ..core.tree import jax_order_leaves
from .sum_tree import SumTree

TransitionSamples = namedarraytuple(
    "TransitionSamples", ["observation", "action", "reward", "done", "timeout"])
SequenceSamples = namedarraytuple(
    "SequenceSamples",
    ["observation", "prev_action", "prev_reward", "action", "reward", "done",
     "init_state"])


def _np(x):
    return np.asarray(x)


def _flat_state(tree, prefix: str) -> dict:
    """Tree leaves -> {prefix_i: array} (np.savez-able checkpoint form)."""
    return {f"{prefix}{i}": np.asarray(leaf)
            for i, leaf in enumerate(jax_order_leaves(tree))}


def _load_flat_state(tree, d, prefix: str):
    """Inverse of ``_flat_state``: copy arrays back into the live leaves."""
    for i, leaf in enumerate(jax_order_leaves(tree)):
        leaf[...] = d[f"{prefix}{i}"]


class BaseReplayBuffer:
    """Ring over time dim: storage leaves are (T_size, B, ...)."""

    def __init__(self, example: TransitionSamples, T_size: int, B: int, *,
                 n_step: int = 1, discount: float = 0.99,
                 store_next_obs: bool = False):
        self.T_size, self.B = T_size, B
        self.n_step, self.discount = n_step, discount
        self.samples = buffer_from_example(example, (T_size, B))
        self.store_next_obs = store_next_obs
        if store_next_obs:
            self.next_obs = buffer_from_example(example.observation, (T_size, B))
        self.t = 0          # ring cursor (next write)
        self.filled = 0     # <= T_size

    def __len__(self):
        return self.filled * self.B

    def append_samples(self, samples: TransitionSamples, next_obs=None):
        """samples leaves: (T, B, ...); returns absolute time indices written."""
        T = _np(samples.reward).shape[0]
        assert T <= self.T_size
        idxs = (self.t + np.arange(T)) % self.T_size
        self.samples[idxs] = samples
        if self.store_next_obs and next_obs is not None:
            self.next_obs[idxs] = next_obs
        self.t = int((self.t + T) % self.T_size)
        self.filled = min(self.filled + T, self.T_size)
        return idxs

    # -- n-step return machinery ------------------------------------------
    def _valid_ages(self):
        """Sampleable ages a (steps back from cursor): need a >= n_step so the
        whole window [t, t+n) is written, and a <= filled - 1."""
        lo, hi = self.n_step, self.filled - 1
        if hi < lo:
            raise ValueError("not enough data in replay buffer")
        return lo, hi

    def _age_to_t(self, age):
        return (self.t - 1 - age) % self.T_size

    def extract_batch(self, t_idx, b_idx):
        """Compute n-step transition tuples at (t_idx, b_idx)."""
        n, g = self.n_step, self.discount
        obs = self.samples.observation[t_idx, b_idx]
        act = self.samples.action[t_idx, b_idx]
        ret = np.zeros(len(t_idx), np.float32)
        not_done = np.ones(len(t_idx), np.float32)
        done_n = np.zeros(len(t_idx), bool)
        timeout_n = np.zeros(len(t_idx), bool)
        steps_to_done = np.full(len(t_idx), n, np.int64)
        for i in range(n):
            ti = (t_idx + i) % self.T_size
            r = self.samples.reward[ti, b_idx]
            ret += (g ** i) * r * not_done
            d = _np(self.samples.done[ti, b_idx]).astype(bool)
            to = _np(self.samples.timeout[ti, b_idx]).astype(bool)
            first_done = d & ~done_n
            timeout_n |= first_done & to
            steps_to_done = np.where(first_done, i + 1, steps_to_done)
            done_n |= d
            not_done *= 1.0 - d.astype(np.float32)
        t_next = (t_idx + steps_to_done) % self.T_size
        if self.store_next_obs:
            # true pre-reset obs at the step BEFORE t_next
            t_last = (t_next - 1) % self.T_size
            next_obs = self.next_obs[t_last, b_idx]
        else:
            next_obs = self.samples.observation[t_next, b_idx]
        # bootstrap mask: continue value at s_{t+n} unless true env death
        bootstrap = (~done_n) | timeout_n
        return dict(
            observation=obs, action=act, return_=ret,
            done_n=done_n, bootstrap=bootstrap.astype(np.float32),
            next_observation=next_obs, n_used=steps_to_done,
        )

    def sample_batch(self, batch_size: int, rng: np.random.Generator):
        lo, hi = self._valid_ages()
        ages = rng.integers(lo, hi + 1, size=batch_size)
        t_idx = self._age_to_t(ages)
        b_idx = rng.integers(0, self.B, size=batch_size)
        batch = self.extract_batch(t_idx, b_idx)
        batch["is_weights"] = np.ones(batch_size, np.float32)
        batch["indices"] = (t_idx, b_idx)
        return batch

    # -- checkpointing (async restore rehydrates the host buffer) ----------
    def state_dict(self) -> dict:
        d = {"t": np.int64(self.t), "filled": np.int64(self.filled)}
        d.update(_flat_state(self.samples, "samples_"))
        if self.store_next_obs:
            d.update(_flat_state(self.next_obs, "next_obs_"))
        return d

    def load_state_dict(self, d):
        self.t, self.filled = int(d["t"]), int(d["filled"])
        _load_flat_state(self.samples, d, "samples_")
        if self.store_next_obs:
            _load_flat_state(self.next_obs, d, "next_obs_")


class UniformReplayBuffer(BaseReplayBuffer):
    pass


class PrioritizedReplayBuffer(BaseReplayBuffer):
    """Proportional prioritization (sum tree) with importance weights."""

    def __init__(self, example, T_size, B, *, alpha=0.6, beta=0.4,
                 default_priority=1.0, eps=1e-6, **kw):
        super().__init__(example, T_size, B, **kw)
        self.alpha, self.beta, self.eps = alpha, beta, eps
        self.default_priority = default_priority
        self.tree = SumTree(T_size * B)

    def _flat(self, t_idx, b_idx):
        return np.asarray(t_idx) * self.B + np.asarray(b_idx)

    def append_samples(self, samples, next_obs=None, priorities=None):
        t_idxs = super().append_samples(samples, next_obs)
        T = len(t_idxs)
        flat = (t_idxs[:, None] * self.B + np.arange(self.B)[None, :]).reshape(-1)
        if priorities is None:
            pr = np.full(flat.shape, self.default_priority, np.float64)
        else:
            pr = (np.abs(_np(priorities).reshape(-1)) + self.eps) ** self.alpha
        self.tree.set(flat, pr)
        # invalidate slots whose n-step window is no longer contiguous
        bad_t = (t_idxs[-1] + 1 - np.arange(self.n_step)) % self.T_size
        bad = (bad_t[:, None] * self.B + np.arange(self.B)[None, :]).reshape(-1)
        live = self.tree.get(bad) > 0
        self.tree.set(bad[live], np.zeros(int(live.sum())))
        return t_idxs

    def sample_batch(self, batch_size: int, rng: np.random.Generator):
        flat, prob = self.tree.sample(batch_size, rng)
        t_idx, b_idx = flat // self.B, flat % self.B
        batch = self.extract_batch(t_idx, b_idx)
        n_valid = self.filled * self.B
        w = (n_valid * np.maximum(prob, 1e-12)) ** (-self.beta)
        batch["is_weights"] = (w / w.max()).astype(np.float32)
        batch["indices"] = flat
        return batch

    def update_priorities(self, flat_idx, td_errors):
        pr = (np.abs(_np(td_errors)) + self.eps) ** self.alpha
        self.tree.set(flat_idx, pr)

    def state_dict(self) -> dict:
        d = super().state_dict()
        d["tree"] = self.tree.tree.copy()
        return d

    def load_state_dict(self, d):
        super().load_state_dict(d)
        self.tree.tree[...] = d["tree"]


class SequenceReplayBuffer:
    """R2D1 sequence replay: fixed-length sequences (burn-in + train) sampled
    at ``state_interval`` boundaries where the recurrent state was stored
    (periodic storage — paper's memory-saving trick).  Prioritized with the
    R2D2 mixture eta*max|delta| + (1-eta)*mean|delta|.
    """

    def __init__(self, example: SequenceSamples, T_size: int, B: int, *,
                 seq_len: int = 80, burn_in: int = 40, state_interval: int = 40,
                 alpha=0.6, beta=0.4, eta=0.9, eps=1e-6):
        assert T_size % state_interval == 0
        self.T_size, self.B = T_size, B
        self.seq_len, self.burn_in = seq_len, burn_in
        self.state_interval = state_interval
        self.alpha, self.beta, self.eta, self.eps = alpha, beta, eta, eps
        # flat stream storage (minus init_state, which is stored periodically)
        stream_example = SequenceSamples(*[
            None if name == "init_state" else getattr(example, name)
            for name in SequenceSamples._fields])
        self.samples = buffer_from_example(stream_example, (T_size, B))
        n_slots = T_size // state_interval
        self.n_slots = n_slots
        self.states = buffer_from_example(example.init_state, (n_slots, B))
        self.tree = SumTree(n_slots * B)
        self.slot_pr = np.zeros((n_slots, B))  # raw p^alpha per sequence start
        self.t = 0
        self.filled = 0

    def append_samples(self, samples: SequenceSamples, priorities=None):
        """samples: (T, B) stream; T must be a multiple of state_interval and
        samples.init_state is the recurrent state at the START of the block."""
        T = _np(samples.reward).shape[0]
        assert T % self.state_interval == 0 and self.t % self.state_interval == 0
        idxs = (self.t + np.arange(T)) % self.T_size
        self.samples[idxs] = SequenceSamples(*[
            None if name == "init_state" else getattr(samples, name)
            for name in SequenceSamples._fields])
        slot0 = self.t // self.state_interval
        n_new = T // self.state_interval
        n_slots = self.T_size // self.state_interval
        slots = (slot0 + np.arange(n_new)) % n_slots
        # init_state provided for block starts: (n_new, B, ...) or (B,...) if
        # n_new == 1; arbitrary pytree (LSTM (h,c), SSM state, KV slices...)
        for dest, src in zip(jax_order_leaves(self.states),
                             jax_order_leaves(samples.init_state)):
            dest[slots] = np.asarray(src)
        self.t = int((self.t + T) % self.T_size)
        self.filled = min(self.filled + T, self.T_size)
        # raw priorities for the new sequence starts
        if priorities is None:
            self.slot_pr[slots] = 1.0
        else:
            self.slot_pr[slots] = (np.abs(_np(priorities).reshape(n_new, self.B))
                                   + self.eps) ** self.alpha
        self._refresh_tree()
        return slots

    def _valid_slots(self):
        """A start at t_s is sampleable iff its whole window
        [t_s, t_s + seq_len + 1) is written and does not cross the cursor."""
        total_len = self.seq_len + 1
        t_s = np.arange(self.n_slots) * self.state_interval
        age = (self.t - t_s) % self.T_size
        age = np.where(age == 0, self.T_size, age)  # cursor slot = oldest
        return (age >= total_len) & (age <= self.filled)

    def _refresh_tree(self):
        valid = self._valid_slots()[:, None]
        pr = np.where(valid, self.slot_pr, 0.0)
        flat = np.arange(self.n_slots * self.B)
        self.tree.set(flat, pr.reshape(-1))

    def sample_batch(self, batch_size: int, rng: np.random.Generator):
        flat, prob = self.tree.sample(batch_size, rng)
        slot, b_idx = flat // self.B, flat % self.B
        t0 = slot * self.state_interval
        L = self.seq_len + 1
        t_seq = (t0[:, None] + np.arange(L)[None, :]) % self.T_size  # (batch, L)
        seq = self.samples[t_seq, b_idx[:, None]]  # leaves (batch, L, ...)
        init_state = pytree.tree_map(lambda d: d[slot, b_idx], self.states)
        n_slots_filled = max(self.filled // self.state_interval, 1) * self.B
        w = (n_slots_filled * np.maximum(prob, 1e-12)) ** (-self.beta)
        return dict(sequence=seq, init_state=init_state,
                    is_weights=(w / w.max()).astype(np.float32), indices=flat)

    def update_priorities(self, flat_idx, td_abs_max, td_abs_mean):
        delta = self.eta * _np(td_abs_max) + (1 - self.eta) * _np(td_abs_mean)
        pr = (np.abs(delta) + self.eps) ** self.alpha
        slot, b = np.asarray(flat_idx) // self.B, np.asarray(flat_idx) % self.B
        self.slot_pr[slot, b] = pr
        valid = self._valid_slots()[slot]
        self.tree.set(flat_idx, np.where(valid, pr, 0.0))

    def state_dict(self) -> dict:
        d = {"t": np.int64(self.t), "filled": np.int64(self.filled),
             "slot_pr": self.slot_pr.copy()}
        d.update(_flat_state(self.samples, "samples_"))
        d.update(_flat_state(self.states, "states_"))
        return d

    def load_state_dict(self, d):
        self.t, self.filled = int(d["t"]), int(d["filled"])
        self.slot_pr[...] = d["slot_pr"]
        _load_flat_state(self.samples, d, "samples_")
        _load_flat_state(self.states, d, "states_")
        self._refresh_tree()  # sum tree is derived from slot_pr + validity


class FrameReplayBuffer(BaseReplayBuffer):
    """Frame-based buffer (paper §1.1): stores each unique frame once; the
    f-stacked observation is reconstructed at sample time, saving ~f x obs
    memory (the Atari trick, exercised on Catch)."""

    def __init__(self, example: TransitionSamples, T_size: int, B: int, *,
                 frames: int = 4, **kw):
        # example.observation is a SINGLE frame (H, W, 1)
        super().__init__(example, T_size, B, **kw)
        self.frames = frames
        # episode id per slot: stacking never crosses episode boundaries
        self.ep_id = np.zeros((T_size, B), np.int64)
        self._ep_counter = np.zeros(B, np.int64)

    def append_samples(self, samples, next_obs=None):
        T = _np(samples.reward).shape[0]
        idxs = (self.t + np.arange(T)) % self.T_size
        done = _np(samples.done).astype(bool)  # (T, B)
        for i, ti in enumerate(idxs):  # small T per append; fine on host
            self.ep_id[ti] = self._ep_counter
            self._ep_counter += done[i].astype(np.int64)
        return super().append_samples(samples, next_obs)

    def stacked_obs(self, t_idx, b_idx):
        """(batch, H, W, frames): zero-pad frames from before episode start."""
        frames = []
        cur_ep = self.ep_id[t_idx, b_idx]
        for k in range(self.frames - 1, -1, -1):
            tk = (t_idx - k) % self.T_size
            f = self.samples.observation[tk, b_idx].astype(np.float32)
            same_ep = self.ep_id[tk, b_idx] == cur_ep
            f = f * same_ep[:, None, None, None]
            frames.append(f[..., 0])
        return np.stack(frames, axis=-1)

    def sample_batch(self, batch_size: int, rng: np.random.Generator):
        lo, hi = self._valid_ages()
        ages = rng.integers(lo, hi + 1, size=batch_size)
        t_idx = self._age_to_t(ages)
        b_idx = rng.integers(0, self.B, size=batch_size)
        batch = self.extract_batch(t_idx, b_idx)
        batch["observation"] = self.stacked_obs(t_idx, b_idx)
        t_next = (t_idx + batch["n_used"]) % self.T_size
        batch["next_observation"] = self.stacked_obs(t_next, b_idx)
        batch["is_weights"] = np.ones(batch_size, np.float32)
        batch["indices"] = (t_idx, b_idx)
        return batch

    def state_dict(self) -> dict:
        d = super().state_dict()
        d["ep_id"] = self.ep_id.copy()
        d["ep_counter"] = self._ep_counter.copy()
        return d

    def load_state_dict(self, d):
        super().load_state_dict(d)
        self.ep_id[...] = d["ep_id"]
        self._ep_counter[...] = d["ep_counter"]
