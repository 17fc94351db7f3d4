"""Alternating sampler (paper §2.1 'Alternating-GPU'), port of
``repro/samplers/alternating.py``.

rlpyt splits workers into two groups: one steps environments while the other
awaits batched action selection, hiding env-step latency behind the agent.
The state holds a *pending action* for group A; one alternating step is
(apply A's pending action to A's envs) and (select B's next action), then
the roles swap.  A collect of horizon T runs 2T half-steps so each group
contributes T transitions; the outputs interleave to the (T, B) layout the
other samplers produce, group A's envs first along the batch axis.

This port keeps the schedule, not the overlap.  In JAX both groups live in
one compiled program as two independent dependency chains, and XLA's
scheduler overlaps them.  Here each half-step is a run of eager launches on
one CUDA stream, so the two groups' work runs one after the other.  A
two-stream form is ROADMAP Queue 2 performance work.

Randomness: JAX splits its key into three (group A, group B, one unused).
The port gives each half a generator of its own, on the given generator's
device, seeded ``fold_seed(s, 0)`` and ``fold_seed(s, 1)`` from its seed
``s`` (``samplers/eval.py::fold_seed``), so a group's draws never depend on
the other group's.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils import _pytree as pytree

from ..core.tree import tree_concat
from .eval import fold_seed
from .serial import SamplerState, SerialSampler

F32 = torch.float32


class AltState(NamedTuple):
    a: SamplerState          # group A (the first half of the env batch)
    b: SamplerState          # group B
    pending_a: Any           # action already selected for A, not yet stepped
    pending_info_a: Any


def _stack(steps):
    return pytree.tree_map(lambda *xs: torch.stack(xs), *steps)


class AlternatingSampler:
    """Same interface as SerialSampler; n_envs splits into two half-batches."""

    def __init__(self, env_spec, agent, n_envs: int, horizon: int):
        if n_envs % 2:
            raise ValueError(f"n_envs {n_envs} must be even")
        self.env = env_spec
        self.agent = agent
        self.n_envs = n_envs
        self.horizon = horizon
        self.half = SerialSampler(env_spec, agent, n_envs // 2, horizon)

    def init(self, generator, agent_state_kwargs=None) -> AltState:
        seed, dev = generator.initial_seed(), generator.device
        halves = [self.half.init(
            torch.Generator(device=dev).manual_seed(fold_seed(seed, g)),
            agent_state_kwargs) for g in (0, 1)]
        return AltState(a=halves[0], b=halves[1], pending_a=None,
                        pending_info_a=None)

    @torch.no_grad()
    def collect(self, params, state: AltState):
        """One sampling batch: returns (state', RolloutBatch (T, B))."""
        half = self.half
        # prime A's first action if needed
        if state.pending_a is None:
            act_a, info_a, sa = half.select(params, state.a)
            state = AltState(sa, state.b, act_a, info_a)
        st, outs_a, outs_b = state, [], []
        for _ in range(self.horizon):
            # phase 1: A steps envs (its pending action) || B selects
            act_b, info_b, sb = half.select(params, st.b)
            sa, out_a = half.step_envs(st.a, st.pending_a, st.pending_info_a)
            # phase 2: B steps envs || A selects its next action
            act_a, info_a, sa = half.select(params, sa)
            sb, out_b = half.step_envs(sb, act_b, info_b)
            st = AltState(sa, sb, act_a, info_a)
            outs_a.append(out_a)
            outs_b.append(out_b)
        # interleave the half-batches back to full batch width
        return st, tree_concat([_stack(outs_a), _stack(outs_b)], axis=1)

    @torch.no_grad()
    def bootstrap_value(self, params, state: AltState):
        va = self.half.bootstrap_value(params, state.a)
        vb = self.half.bootstrap_value(params, state.b)
        return torch.cat([va, vb], dim=0)

    @staticmethod
    def traj_stats(state: AltState):
        a, b = state.a, state.b
        count = a.completed_count + b.completed_count
        n = torch.clamp(count, min=1).to(F32)
        return {"avg_return": (a.completed_return_sum
                               + b.completed_return_sum) / n,
                "avg_len": (a.completed_len_sum + b.completed_len_sum) / n,
                "episodes": count}

    @staticmethod
    def full_agent_state(state: AltState):
        """Interleaved [A-half, B-half] agent state matching batch layout."""
        return tree_concat([state.a.agent_state, state.b.agent_state], axis=0)

    @staticmethod
    def reset_stats(state: AltState) -> AltState:
        return AltState(SerialSampler.reset_stats(state.a),
                        SerialSampler.reset_stats(state.b),
                        state.pending_a, state.pending_info_a)
