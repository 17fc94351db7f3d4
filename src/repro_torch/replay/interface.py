"""One replay interface (init/insert/sample/update_priorities) so runners
are replay-backend-agnostic; port of ``repro/replay/interface.py``.

Backends:
- ``DeviceReplay``         — the torch ring of ``replay/device.py`` on the
  device (the TrainLoop path).
- ``HostTransitionReplay`` — numpy n-step buffers (replay/host.py); the
  paper's shared-memory buffer for the asynchronous runner.  State is the
  buffer object itself, mutated in place and returned for signature parity.
- ``HostSequenceReplay``   — numpy sequence buffer with periodic stored
  recurrent state (R2D1).
- ``LockedReplay``         — one lock around a host backend, so the async
  runner's copier thread inserts while its learner samples.

All backends speak RolloutBatch on insert — each converts to its own
storage layout — and return ``(sample, indices, is_weights)`` from
``sample``, so the runner's only other contact with replay data is
``make_algo_batch(algo.batch_spec, sample, ...)``.  The host backends
return numpy samples; the runner moves them to its learner's device.
"""
from __future__ import annotations

import threading
from typing import Any

import torch
from torch.utils import _pytree as pytree

from ..core.batch_spec import rollout_to_transitions
from . import device as dreplay
from .host import PrioritizedReplayBuffer, SequenceSamples, TransitionSamples

F32 = torch.float32


def host_tree(x):
    """Device -> host copy of a tree (the async memory-copier role): every
    tensor leaf becomes a numpy array, synchronously (the copy has landed
    when this returns); numpy leaves pass through and ``None`` stays."""
    return pytree.tree_map(
        lambda leaf: leaf.detach().cpu().numpy()
        if isinstance(leaf, torch.Tensor) else leaf, x)


def transition_example(env, *, device="cpu") -> dict:
    """Single-transition tree (no batch dim) describing what one slot of a
    transition replay stores for ``env`` — the init-time example."""
    obs = torch.as_tensor(env.observation_space.null_value(), device=device)
    act = torch.as_tensor(env.action_space.null_value(), device=device)
    return {
        "observation": obs,
        "action": act,
        "reward": torch.zeros((), dtype=F32, device=device),
        "done": torch.zeros((), dtype=torch.bool, device=device),
        "timeout": torch.zeros((), dtype=torch.bool, device=device),
        "next_observation": obs,
    }


class ReplayLike:
    """The contract runners program against.

    init(example) -> state
    insert(state, rollout, **extras) -> state
    sample(state, generator, batch_size) -> (sample, indices, is_weights)
    update_priorities(state, indices, *priorities) -> state

    ``device_resident`` says whether the state lives on the device (and the
    sampled batch with it).
    """

    device_resident: bool = False

    def init(self, example) -> Any:
        raise NotImplementedError

    def insert(self, state, rollout, **extras):
        raise NotImplementedError

    def sample(self, state, generator, batch_size: int):
        raise NotImplementedError

    def update_priorities(self, state, indices, *priorities):
        raise NotImplementedError


class DeviceReplay(ReplayLike):
    """Torch ring + sum tree on the example's device."""

    device_resident = True

    def __init__(self, capacity: int, *, prioritized: bool = False,
                 alpha: float = 0.6, beta: float = 0.4):
        self.capacity = capacity
        self.prioritized = prioritized
        self.alpha, self.beta = alpha, beta

    def init(self, example) -> dreplay.ReplayState:
        device = next(iter(example.values())).device
        return dreplay.init_replay(example, self.capacity, device=device)

    def insert(self, state, rollout, **extras):
        return dreplay.insert(state, rollout_to_transitions(rollout))

    def sample(self, state, generator, batch_size: int, *, draws=None):
        return dreplay.sample(state, generator, batch_size,
                              uniform=not self.prioritized, beta=self.beta,
                              draws=draws)

    def update_priorities(self, state, indices, *priorities):
        if not self.prioritized:
            return state
        (td_abs,) = priorities
        return dreplay.update_priorities(state, indices, td_abs,
                                         alpha=self.alpha)

    # -- data-parallel views (paper §2.4: replay sharded across GPUs) -----
    #
    # On a data mesh each rank owns an independent ring of
    # capacity / n_shards slots with its OWN sum tree; cursor and filled
    # are the same on every rank (each inserts the same number of
    # transitions at the same times).  The global state, as JAX's, is one
    # ReplayState: storage (capacity, ...) is the ranks' rings end to end
    # and the trees are stacked on a leading (n_shards,) axis.  A rank holds
    # its block of it (storage (capacity / n_shards, ...), tree (1, 2 *
    # size)); ``local_view`` / ``merge_view`` strip / restore the tree's
    # leading axis (views: the in-place writes reach the block), so insert,
    # sample and update_priorities run UNCHANGED on the rank's ring.

    def init_sharded(self, example, n_shards: int, *, index=None
                     ) -> dreplay.ReplayState:
        """The global state of ``n_shards`` rings of capacity // n_shards
        slots each, or, with ``index``, rank ``index``'s block of it."""
        if self.capacity % n_shards:
            raise ValueError(f"capacity {self.capacity} does not split over "
                             f"{n_shards} shards")
        device = next(iter(example.values())).device
        local = dreplay.init_replay(example, self.capacity // n_shards,
                                    device=device)
        if index is not None:
            return self.merge_view(local)
        return local._replace(
            storage=pytree.tree_map(
                lambda l: torch.zeros((self.capacity,) + tuple(l.shape[1:]),
                                      dtype=l.dtype, device=l.device),
                local.storage),
            tree=torch.zeros((n_shards,) + tuple(local.tree.shape),
                             dtype=local.tree.dtype, device=device))

    @staticmethod
    def shard_spec(mesh) -> dreplay.ReplayState:
        """Which leaves of a state built by ``init_sharded`` are per rank
        (sharded over ``mesh``'s axis on dim 0) and which replicated
        (None), as a prefix tree for ``train.checkpoint`` (``shardings=``);
        JAX's PartitionSpec prefix."""
        return dreplay.ReplayState(storage=mesh, cursor=None, filled=None,
                                   tree=mesh)

    @staticmethod
    def local_view(state: dreplay.ReplayState) -> dreplay.ReplayState:
        """A rank's block (tree (1, 2*size)) -> plain local ReplayState."""
        return state._replace(tree=state.tree[0])

    @staticmethod
    def merge_view(state: dreplay.ReplayState) -> dreplay.ReplayState:
        """Inverse of ``local_view``."""
        return state._replace(tree=state.tree[None])


class HostTransitionReplay(ReplayLike):
    """Wraps Uniform/Prioritized/Frame host buffers; ``state`` is the buffer."""

    device_resident = False

    def __init__(self, buffer):
        self.buffer = buffer

    def init(self, example=None):
        return self.buffer

    def insert(self, state, rollout, **extras):
        b = host_tree(rollout)
        samples = TransitionSamples(
            observation=b.observation, action=b.action, reward=b.reward,
            done=b.done, timeout=b.timeout)
        state.append_samples(samples, next_obs=b.next_observation
                             if state.store_next_obs else None)
        return state

    def sample(self, state, rng, batch_size: int):
        hb = state.sample_batch(batch_size, rng)
        indices = hb.pop("indices")
        weights = hb.pop("is_weights")
        return hb, indices, weights

    def update_priorities(self, state, indices, *priorities):
        if isinstance(state, PrioritizedReplayBuffer):
            (td_abs,) = priorities
            state.update_priorities(indices, host_tree(td_abs))
        return state


class HostSequenceReplay(ReplayLike):
    """Wraps SequenceReplayBuffer; insert takes the block-start recurrent
    state via ``init_state=`` (periodic storage, paper §6.3)."""

    device_resident = False

    def __init__(self, buffer):
        self.buffer = buffer

    def init(self, example=None):
        return self.buffer

    def insert(self, state, rollout, *, init_state=None, **extras):
        b = host_tree(rollout)
        samples = SequenceSamples(
            observation=b.observation, prev_action=b.prev_action,
            prev_reward=b.prev_reward, action=b.action, reward=b.reward,
            done=b.done, init_state=host_tree(init_state))
        state.append_samples(samples)
        return state

    def sample(self, state, rng, batch_size: int):
        hb = state.sample_batch(batch_size, rng)
        indices = hb.pop("indices")
        weights = hb.pop("is_weights")
        return hb, indices, weights

    def update_priorities(self, state, indices, *priorities):
        td_max, td_mean = host_tree(priorities)
        state.update_priorities(indices, td_max, td_mean)
        return state


class LockedReplay(ReplayLike):
    """Concurrent-safe view over a host ReplayLike (the async memory-copier
    hand-off, paper §2.3): one RLock serializes insert / sample /
    update_priorities so the copier thread can append while the learner
    samples.  The lock guards only the host-side numpy mutation — callers
    should materialize device batches (``host_tree``) BEFORE insert, and
    priorities before ``update_priorities``, so no device wait ever happens
    under the lock.
    """

    device_resident = False

    def __init__(self, inner: ReplayLike):
        if inner.device_resident:
            raise TypeError("LockedReplay wraps host backends")
        self.inner = inner
        self.lock = threading.RLock()

    @property
    def buffer(self):
        return self.inner.buffer

    def init(self, example=None):
        with self.lock:
            return self.inner.init(example)

    def insert(self, state, rollout, **extras):
        with self.lock:
            return self.inner.insert(state, rollout, **extras)

    def sample(self, state, rng, batch_size: int):
        with self.lock:
            return self.inner.sample(state, rng, batch_size)

    def update_priorities(self, state, indices, *priorities):
        with self.lock:
            return self.inner.update_priorities(state, indices, *priorities)
