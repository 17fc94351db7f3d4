"""Sharded sampler: the paper's parallel workers as data-parallel ranks,
port of ``repro/samplers/sharded.py``.

rlpyt forks worker processes and synchronizes per batch.  JAX runs the
shards as one ``shard_map``'d program; the port runs them as the ranks of
a ``launch.mesh.DataMesh``: each rank steps its ``n_envs / n_shards`` envs
with action selection on its own device, and the only collective is the
sum of the episode stats ("synchronization across workers only per
sampling batch", paper §2.1).

Randomness: each shard draws from a generator of its own, seeded
``fold_seed(base, shard)`` from a base seed drawn once from the init
generator (the port's counterpart of JAX folding ``axis_index`` into the
replicated key, ``sharded.py:82-84``).  A rank holds its shard's
generator; the one-process view holds all of them, so both draw the same
numbers for a shard.

Two entry points, as JAX's:
- ``collect``       — returns the GLOBAL (T, B) batch.  In one process
                      (a mesh without a process group) it runs the shards in
                      turn on the global state; on a rank it collects the
                      rank's shard and gathers the batch from every rank.
- ``local_collect`` — the rank-local body, for ``TrainLoop(mesh=...)``:
                      the rank's (T, B / n_shards) batch, episode stats
                      summed over the ranks as deltas.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from .eval import fold_seed
from .serial import SamplerState, SerialSampler

F32 = torch.float32

_SCALAR_STATS = ("completed_return_sum", "completed_len_sum",
                 "completed_count")
SHARD_SEED_BITS = 62


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


class ShardedSampler:
    """``n_envs`` TOTAL envs sharded over ``axis`` of ``mesh``.  Same
    interface as SerialSampler."""

    def __init__(self, env_spec, agent, n_envs: int, horizon: int, *,
                 mesh, axis: str = "data"):
        self.env = env_spec
        self.agent = agent
        self.n_envs = n_envs
        self.horizon = horizon
        self.mesh = mesh
        self.axis = axis
        n_shards = mesh.shape[axis]
        if n_envs % n_shards:
            raise ValueError(f"{n_envs} envs do not split over {n_shards} "
                             "shards")
        self.n_shards = n_shards
        self._local = SerialSampler(env_spec, agent, n_envs // n_shards,
                                    horizon)
        self._global = SerialSampler(env_spec, agent, n_envs, horizon)

    @property
    def _per_rank(self) -> bool:
        return self.mesh.distributed

    # -- state ------------------------------------------------------------
    def _env_leaf(self, x, n=None) -> bool:
        """A per-env leaf: a tensor whose leading dim is the env batch
        (``n`` envs; default all of them)."""
        return _is_tensor(x) and x.dim() >= 1 and \
            x.shape[0] == (self.n_envs if n is None else n)

    def _slice(self, state: SamplerState, shard: int, generator):
        """Shard ``shard``'s block of a global state, with ``generator``."""
        b = self.n_envs // self.n_shards
        sl = lambda x: x[shard * b:(shard + 1) * b] if self._env_leaf(x) \
            else x
        return SamplerState(**{
            f: generator if f == "generator" else
            pytree.tree_map(sl, getattr(state, f))
            for f in SamplerState._fields})

    def init(self, generator, agent_state_kwargs=None) -> SamplerState:
        """The envs reset from ``generator`` as one global batch (so every
        rank and the one-process view start alike); on a rank, the rank's
        block of it with the rank's generator, else the global state with
        every shard's generator (a tuple in ``generator``)."""
        state = self._global.init(generator, agent_state_kwargs)
        base = int(torch.randint(0, 1 << SHARD_SEED_BITS, (),
                                 generator=generator,
                                 device=generator.device))
        gens = tuple(torch.Generator(device=generator.device).manual_seed(
            fold_seed(base, s)) for s in range(self.n_shards))
        if self._per_rank:
            i = self.mesh.index
            return self._slice(state, i, gens[i])
        return state._replace(generator=gens)

    def state_spec(self, state: SamplerState) -> SamplerState:
        """Which leaves of a rank's state are per rank (sharded over the
        mesh's axis on dim 0: ``self.mesh``) and which replicated (None),
        as a prefix tree for ``train.checkpoint`` (``shardings=``): per-env
        leaves sharded; the generator and the summed episode scalars
        replicated."""
        fields = {}
        for name in SamplerState._fields:
            leaf_tree = getattr(state, name)
            if name in _SCALAR_STATS or name == "generator":
                fields[name] = None
            else:
                fields[name] = pytree.tree_map(
                    lambda l: self.mesh if _is_tensor(l) and l.dim() >= 1
                    else None, leaf_tree)
        return SamplerState(**fields)

    # -- the rank-local body ------------------------------------------------
    def _sum_stats(self, state: SamplerState, s2: SamplerState, deltas_sum):
        d = deltas_sum
        return s2._replace(
            completed_return_sum=d[0] + state.completed_return_sum,
            completed_len_sum=d[1] + state.completed_len_sum,
            completed_count=d[2].to(state.completed_count.dtype)
            + state.completed_count)

    @staticmethod
    def _deltas(state: SamplerState, s2: SamplerState) -> torch.Tensor:
        """The episode stats this collect added, as one f32 vector (the
        count is exact in f32 below 2^24 episodes a collect)."""
        return torch.stack([
            s2.completed_return_sum - state.completed_return_sum,
            s2.completed_len_sum - state.completed_len_sum,
            (s2.completed_count - state.completed_count).to(F32)])

    @torch.no_grad()
    def local_collect(self, params, state: SamplerState):
        """Rank-local rollout on a rank's state (its env block, its
        generator, the global episode scalars); episode stats are summed
        over the ranks as deltas, so ``traj_stats`` / ``reset_stats`` see
        the global values.  Returns (state', (T, B / n_shards) batch)."""
        if not self._per_rank and self.n_shards > 1:
            raise ValueError("local_collect runs on the ranks of a mesh; in "
                             "one process use collect")
        s2, batch = self._local.collect(params, state)
        return self._sum_stats(state, s2,
                               self.mesh.psum(self._deltas(state, s2))), batch

    @torch.no_grad()
    def local_bootstrap(self, params, state: SamplerState):
        """Rank-local bootstrap values (B / n_shards,)."""
        return self._local.bootstrap_value(params, state)

    # -- the global batch -----------------------------------------------------
    @torch.no_grad()
    def collect(self, params, state: SamplerState):
        """The global (T, B) batch: on a rank, the rank's collect with every
        rank's batch gathered (the state stays the rank's); in one process,
        the shards in turn on the global state, as JAX's ``shard_map``'d
        collect."""
        if self._per_rank:
            state, batch = self.local_collect(params, state)
            return state, pytree.tree_map(
                lambda x: self.mesh.all_gather(x, dim=1) if x.dim() >= 2
                else x, batch)
        gens = state.generator
        parts, deltas, batches = [], [], []
        for s in range(self.n_shards):
            local = self._slice(state, s, gens[s])
            s2, batch = self._local.collect(params, local)
            parts.append(s2)
            deltas.append(self._deltas(local, s2))
            batches.append(batch)
        b = self.n_envs // self.n_shards
        cat = lambda *xs: torch.cat(xs, dim=0) if self._env_leaf(xs[0], b) \
            else xs[0]
        merged = SamplerState(**{
            f: gens if f == "generator" else
            pytree.tree_map(cat, *[getattr(p, f) for p in parts])
            for f in SamplerState._fields})
        total = deltas[0]
        for d in deltas[1:]:
            total = total + d
        merged = self._sum_stats(state, merged, total)
        batch = pytree.tree_map(
            lambda *xs: torch.cat(xs, dim=1) if xs[0].dim() >= 2 else xs[0],
            *batches)
        return merged, batch

    @torch.no_grad()
    def bootstrap_value(self, params, state: SamplerState):
        """Global bootstrap values (B,): gathered from every rank, or over
        the global state in one process."""
        if self._per_rank:
            return self.mesh.all_gather(self.local_bootstrap(params, state))
        return self._global.bootstrap_value(params, state)

    traj_stats = staticmethod(SerialSampler.traj_stats)
    full_agent_state = staticmethod(SerialSampler.full_agent_state)
    reset_stats = staticmethod(SerialSampler.reset_stats)
