"""Declarative batch contract between algorithms and the runner stack, port
of ``repro/core/batch_spec.py``.

Each algorithm *declares* what it consumes — which fields, whether it is
on-policy or replayed, transition- or sequence-mode — and the single
``make_algo_batch`` adapter assembles exactly those fields from whatever the
sampler/replay produced.  Runners never hand-build algorithm batches.

Modes
-----
- ``rollout``:    on-policy; the adapter reads the (T, B) RolloutBatch the
                  sampler emitted (A2C, PPO).
- ``transition``: replayed flat transitions; ``return_`` / ``bootstrap`` /
                  ``n_used`` are passed through when the backend
                  precomputed them or derived from the raw 1-step fields
                  (device ring) — DQN and the QPG family.
- ``sequence``:   replayed fixed-length sequences with stored initial
                  recurrent state (R2D1).
"""
from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Optional, Tuple

import torch

F32 = torch.float32

ROLLOUT = "rollout"
TRANSITION = "transition"
SEQUENCE = "sequence"

#: transition keys every replay backend stores for the device/1-step path
TRANSITION_FIELDS = ("observation", "action", "reward", "done", "timeout",
                     "next_observation")

# rollout-mode fields that live inside RolloutBatch.agent_info, keyed by the
# name the algorithm consumes -> the name the agent recorded
_AGENT_INFO_FIELDS = {"value": "value", "logp_old": "logp"}


class BatchSpec(NamedTuple):
    """What an algorithm's ``update`` consumes.

    mode:          "rollout" | "transition" | "sequence"
    fields:        exact batch keys ``algo.update`` reads — the adapter
                   produces these and nothing else
    priority_keys: ``OptInfo.extra`` keys that feed replay priority updates,
                   in the order ``ReplayLike.update_priorities`` expects them
    """
    mode: str
    fields: Tuple[str, ...]
    priority_keys: Tuple[str, ...] = ()

    @property
    def on_policy(self) -> bool:
        return self.mode == ROLLOUT

    @property
    def replayed(self) -> bool:
        return not self.on_policy


def rollout_to_transitions(batch) -> dict:
    """Flatten a time-major (T, B) RolloutBatch into a (T*B,) slot-major
    transition dict (views where the layout allows)."""
    return {name: getattr(batch, name).flatten(0, 1)
            for name in TRANSITION_FIELDS}


def _derive_transition_field(name: str, data: Mapping[str, Any]):
    """Fields the 1-step device ring does not store but the algorithms
    consume."""
    if name == "return_":
        return data["reward"]
    if name == "bootstrap":
        done = data["done"].to(F32)
        timeout = data["timeout"].to(F32)
        return (1.0 - done) + done * timeout
    if name == "n_used":
        return torch.ones_like(data["reward"], dtype=torch.int32)
    if name == "is_weights":
        return torch.ones_like(data["reward"], dtype=F32)
    raise KeyError(name)


def make_algo_batch(spec: BatchSpec, data, extras: Optional[Mapping] = None):
    """Assemble the algorithm batch declared by ``spec``.

    data:   the raw producer output — a RolloutBatch (rollout mode) or a
            replay-sample mapping (transition/sequence mode).
    extras: runner-supplied values outside the sample itself
            (``bootstrap_value`` for on-policy, ``is_weights`` for replayed).

    Returns a dict whose keys are exactly ``spec.fields``.
    """
    extras = extras or {}
    out = {}
    if spec.mode == ROLLOUT:
        for name in spec.fields:
            if name in extras:
                out[name] = extras[name]
            elif name in _AGENT_INFO_FIELDS:
                out[name] = data.agent_info[_AGENT_INFO_FIELDS[name]]
            elif hasattr(data, name):
                out[name] = getattr(data, name)
            else:
                raise KeyError(
                    f"rollout field {name!r} not found on {type(data).__name__}"
                    f" or in extras {sorted(extras)}")
        return out
    if spec.mode in (TRANSITION, SEQUENCE):
        for name in spec.fields:
            if name in extras:
                out[name] = extras[name]
            elif name in data:
                out[name] = data[name]
            elif spec.mode == TRANSITION:
                out[name] = _derive_transition_field(name, data)
            else:
                raise KeyError(
                    f"sequence field {name!r} missing from sample keys "
                    f"{sorted(data)} and extras {sorted(extras)}")
        return out
    raise ValueError(f"unknown BatchSpec mode {spec.mode!r}")
