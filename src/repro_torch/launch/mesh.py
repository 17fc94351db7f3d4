"""The data-parallel mesh as ``torch.distributed`` ranks, and the device
split of the decoupled async runner; port of ``repro/launch/mesh.py``.

JAX's 1-D data mesh (paper §2.4: replicated model, sharded envs and
replay, all-reduced gradients) is one SPMD program over devices, its
collectives bound to an axis name inside ``shard_map``.  The port runs it
as rlpyt's PyTorch code does: one process per rank, each owning a shard of
the envs and of the replay, with the model and optimizer state replicated
and every gradient all-reduced before the step.  ``DataMesh`` stands in for
the mesh and its axis at once: the process group, the axis name, its size,
this rank's index and device, and the collectives JAX binds to the axis
name (``psum``, ``pmean``, ``pmax``, ``all_gather``), packed into
all-reduces of at most ``BUCKET_BYTES`` a dtype.  Callers read the size
as JAX's do, ``mesh.shape[axis]``.

The backend is chosen, not configured (``choose_backend``): NCCL where
every rank has a card of its own (the world no larger than the cards),
gloo where ranks share a card (NCCL refuses two ranks on one GPU) or run
on the CPU.  Each rank's device is ``cuda:(rank % device_count)``.  Gloo
offers only broadcast, all-reduce and barrier on CUDA tensors, so there
``all_gather`` is an all-reduce SUM of a zeroed global buffer of bytes
into which each rank writes its block (every other addend is zero, so the
result is its inputs bit for bit); under NCCL it is NCCL's own
``all_gather_into_tensor``, and a CPU tensor goes through the rank's card.

NCCL's collectives are kernels on the card, so a CUDA graph can hold them
(``DataMesh.capturable``): ``TrainLoop(mesh=, fuse=True)`` and the model
axis' rollout replay them (core/graphs.py).  Gloo's run on the host: one
issued while the stream captures a graph raises (``_refuse_capture``)
rather than freeze its result into the graph.  An NCCL rank binds its
group to its card (``init_process_group(device_id=)``), so the
communicators exist before any capture, which cannot create one.

A mesh without a process group (``make_data_mesh`` where
``torch.distributed`` is not initialized) is the one-process view of
``size`` shards: ``ShardedSampler.collect`` then runs the shards in turn,
and the collectives refuse to run (a mesh of one shard reduces to itself).

``spawn_ranks`` starts the ranks (``torch.multiprocessing``'s spawn
context, a ``file://`` rendezvous, gloo with a short timeout), returns each
rank's result and raises if any rank raises or misses its deadline; the
tests and ``chip_smoke.py`` run the mesh through it.  JAX's SPMD needs no
launcher.

``make_production_mesh`` describes the dry run's meshes (``(16, 16)``
over ``("data", "model")``, ``(2, 16, 16)`` with an outer ``"pod"``) as an
``AbstractMesh``: axis names and sizes, no devices and no processes.
``record_collectives`` lists what a ``DataMesh`` puts on the wire while it
is entered, for ``launch/hlo_analysis.py``'s ``collective_bytes``; a
``RecordingMesh`` is a data axis with no ranks behind it whose
collectives record their bytes and send nothing (the dry run's gradient
all-reduce).  The roofline constants are the H100 SXM's.

The LM's 2-D (data x model) mesh (``make_2d_mesh``, ``Mesh2D``) is two
axes of ranks laid out row-major as ``jax.make_mesh`` lays out devices: a
model group is M consecutive ranks, a data group every M-th.  The 'model'
axis runs tensor parallelism by ``param_pspecs``' rules: each rank holds
its block of every leaf the rules split, and the layers call Megatron's
f / g collectives and an all-gather on ``Mesh2D.model``
(``models/sharding.py``'s execution half).  ``install`` / ``install_2d``
register a mesh with ``models/sharding.py``'s rules as JAX's do.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

COLLECTIVE_TIMEOUT_S = 60.0   # a rank blocked this long in a collective raises

# Hardware constants for the roofline: one NVIDIA H100 SXM, NVIDIA's data
# sheet (dense rates, no sparsity, at the 700 W power limit)
PEAK_FLOPS_BF16 = 989e12       # bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12               # HBM3 bytes/s per card
LINK_BW = 450e9                # NVLink bytes/s per direction (900 GB/s both)
# the largest staging buffer of one all-reduce: a collective on N bytes
# holds at most this much beside its tensors
BUCKET_BYTES = 256 * 2**20


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no devices behind it: what the
    sharding rules and the dry run's byte counts read (``.shape[axis]``,
    ``.axis_names``), as ``DataMesh`` offers them."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The dry run's mesh: (16, 16) over ('data', 'model'), or (2, 16, 16)
    over ('pod', 'data', 'model') -- the JAX package's shapes, so the port's
    rules and byte counts compare with JAX's."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


_RECORDS: List[tuple] = []   # the active record_collectives (axis, list)


@contextlib.contextmanager
def record_collectives(axis: Optional[str] = None):
    """Collect one ``(kind, result_bytes, group_size)`` record for every
    collective a ``DataMesh`` of axis ``axis`` (None: any) sends inside
    the block: what goes on the wire, so a gloo ``all_gather`` (an
    all-reduce of a zeroed byte buffer) records an all-reduce of the whole
    buffer."""
    records: list = []
    entry = (axis, records)
    _RECORDS.append(entry)
    try:
        yield records
    finally:
        _RECORDS.remove(entry)


_TIMERS: List[tuple] = []   # the active time_collectives (axis, timer)


class CollectiveTime:
    """What ``time_collectives`` accumulates.  A collective staged
    through the host (gloo, the CPU) adds its host time, from a
    synchronised device to its result copied back (so the time is the
    collective's, not the device work queued before it).  Under NCCL a
    collective adds a pair of CUDA events recorded on the stream around
    it, and nothing waits for them: ``seconds()`` reads the pairs once,
    after the caller's own synchronisation.  A collective inside a
    replayed CUDA graph is timed by the event pair its capture recorded
    (``GraphTimes``): each replay owes its pairs' times to the
    accumulators active when it ran."""

    def __init__(self):
        self.host = 0.0
        self.events: list = []
        self.replayed = 0.0          # seconds read from graph replays
        self.owed: list = []         # GraphTimes whose last replay is unread

    def seconds(self) -> float:
        for times in list(self.owed):
            times.settle()
        ms = 0.0
        if self.events:
            self.events[-1][1].synchronize()
            ms = sum(a.elapsed_time(b) for a, b in self.events)
        return self.host + self.replayed + ms / 1e3


class GraphTimes:
    """The event pairs one CUDA graph's capture recorded around its
    collectives: ``torch.cuda.Event(enable_timing=True, external=True)``,
    recorded under capture as event nodes that every replay records again.
    ``StepGraph`` calls ``replayed`` after each replay, which owes the
    pairs' times to the ``time_collectives`` of their axes active then,
    and ``settle`` before the next replay, which would overwrite them: it
    waits for the last replay's last collective and adds the times to
    those accumulators.  So a graph's collectives cost the host one wait a
    replay while a ``time_collectives`` reads them, and none otherwise."""

    def __init__(self):
        self.pairs: list = []        # (axis, start, end) in capture order
        self._owed: list = []        # (CollectiveTime, [(start, end)])

    def replayed(self) -> None:
        for want, acc in _TIMERS:
            mine = [(a, b) for axis, a, b in self.pairs
                    if want is None or want == axis]
            if mine:
                self._owed.append((acc, mine))
                acc.owed.append(self)

    def settle(self) -> None:
        if not self._owed:
            return
        self.pairs[-1][2].synchronize()
        for acc, mine in self._owed:
            acc.replayed += sum(a.elapsed_time(b) for a, b in mine) / 1e3
            acc.owed.remove(self)
        self._owed = []


_CAPTURES: List[GraphTimes] = []   # the active capture_times, innermost last


@contextlib.contextmanager
def capture_times():
    """Collect into a ``GraphTimes`` the event pairs of every NCCL
    collective a ``DataMesh`` issues while a CUDA graph is captured inside
    the block (``StepGraph``'s capture)."""
    times = GraphTimes()
    _CAPTURES.append(times)
    try:
        yield times
    finally:
        _CAPTURES.remove(times)


def capturing(device) -> bool:
    """True while ``device``'s current stream captures a CUDA graph."""
    device = torch.device(device)
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def time_collectives(axis: Optional[str] = None):
    """Accumulate into a ``CollectiveTime`` the time of every collective
    a ``DataMesh`` of axis ``axis`` (None: any) sends inside the block."""
    acc = CollectiveTime()
    entry = (axis, acc)
    _TIMERS.append(entry)
    try:
        yield acc
    finally:
        _TIMERS.remove(entry)


def choose_backend(world: int, device) -> str:
    """NCCL where each of ``world`` ranks has a card of its own, gloo where
    ranks share a card or run on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and dist.is_nccl_available() and \
            torch.cuda.is_available() and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _record_bytes(kind: str, nbytes: int, group_size: int,
                  axis: Optional[str] = None) -> None:
    for want, records in _RECORDS:
        if want is None or want == axis:
            records.append((kind, nbytes, group_size))


def _record(kind: str, t: torch.Tensor, group_size: int,
            axis: Optional[str] = None) -> None:
    _record_bytes(kind, t.numel() * t.element_size(), group_size, axis)


@dataclasses.dataclass(frozen=True, eq=False)
class DataMesh:
    """One data axis over ``size`` ranks (see the module docstring).

    ``group`` is the process group of the axis (None: the one-process view
    of ``size`` shards); ``index`` is this rank's position on the axis;
    ``devices[i]`` the device of the rank at position ``i``.  Equality is
    identity."""
    axis: str
    size: int
    index: int = 0
    device: torch.device = torch.device("cpu")
    devices: Tuple[torch.device, ...] = ()
    group: Any = None

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}

    @property
    def axis_names(self) -> tuple:
        return (self.axis,)

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)

    @property
    def capturable(self) -> bool:
        """True where a CUDA graph can hold what this axis sends: nothing
        (one rank, or no process group) or NCCL's collectives on the card.
        Gloo's run on the host (``_refuse_capture``)."""
        return self.size == 1 or self.group is None or (
            self.device.type == "cuda" and self.backend == "nccl")

    def _refuse_capture(self, device, what: str) -> None:
        """Raise where a collective that no graph can hold is issued while
        ``device``'s stream captures one: a gloo collective would run once,
        on the host, and its result freeze into the graph."""
        if capturing(device) and not self.capturable:
            raise RuntimeError(
                f"{what} over {self.axis!r} while {device}'s stream captures "
                f"a CUDA graph: this axis' collectives are "
                f"{self.backend}'s, which run on the host; only NCCL's (a "
                "card a rank) can be captured.  Run this path eagerly "
                "(TrainLoop(fuse=False), make_lm_rollout(graph=False))")

    def _timers(self) -> list:
        return [acc for axis, acc in _TIMERS if axis in (None, self.axis)]

    @contextlib.contextmanager
    def _timed(self, device):
        """Add the block's time to the active ``time_collectives`` of this
        axis (``CollectiveTime``): under NCCL a pair of events on
        ``device``'s stream, else the host time from a synchronised
        ``device`` to a synchronised one.  Under a graph's capture (NCCL
        only) the pair is recorded as event nodes into the capture's
        ``GraphTimes``, whatever is active: the replays are timed."""
        device = torch.device(device)
        if capturing(device):
            if not _CAPTURES:
                yield
                return
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True, external=True)
            end = torch.cuda.Event(enable_timing=True, external=True)
            start.record(stream)
            yield
            end.record(stream)
            _CAPTURES[-1].pairs.append((self.axis, start, end))
            return
        accs = self._timers()
        if not accs:
            yield
            return
        cuda = device.type == "cuda"
        if cuda and self.backend == "nccl":
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            yield
            end.record(stream)
            for acc in accs:
                acc.events.append((start, end))
            return
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        yield
        if cuda:
            torch.cuda.synchronize(device)
        for acc in accs:
            acc.host += time.perf_counter() - t0

    def _on_wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the backend can send it: NCCL sends from the card,
        so a CPU tensor goes through this rank's device."""
        if self.backend == "nccl" and t.device.type != "cuda":
            return t.to(self.device)
        return t

    # -- collectives (JAX's lax.psum / pmean / pmax / all_gather) ----------
    def _check(self, what: str) -> bool:
        """True when the collective must talk to other ranks."""
        if self.size == 1:
            return False
        if self.group is None:
            raise ValueError(
                f"{what} over {self.axis!r}: this mesh is the one-process "
                f"view of {self.size} shards and has no process group; run "
                "it on its ranks (launch.mesh.spawn_ranks)")
        return True

    def _reduce_(self, tensors: List[torch.Tensor], op, what: str
                 ) -> List[torch.Tensor]:
        """``op`` over the axis of every tensor, IN PLACE (contiguous
        tensors), in buckets of at most ``BUCKET_BYTES`` a dtype and
        device: each bucket's elements are copied into one staging buffer,
        all-reduced, and copied back, so a call holds one bucket beyond its
        tensors (gloo stages a CUDA buffer through host memory).  Returns
        the tensors."""
        if tensors:
            self._refuse_capture(tensors[0].device, what)
        if not self._check(what):
            return tensors
        groups = {}
        for t in tensors:
            groups.setdefault((t.dtype, t.device), []).append(t.view(-1))
        for flats in groups.values():
            per = max(BUCKET_BYTES // flats[0].element_size(), 1)
            pieces, n = [], 0
            for f in flats:
                start = 0
                while start < f.numel():
                    k = min(per - n, f.numel() - start)
                    pieces.append(f[start:start + k])
                    n, start = n + k, start + k
                    if n == per:
                        self._send_bucket(pieces, op)
                        pieces, n = [], 0
            if pieces:
                self._send_bucket(pieces, op)
        return tensors

    def _send_bucket(self, pieces, op) -> None:
        buf = torch.cat(pieces)
        _record("all-reduce", buf, self.size, self.axis)
        with self._timed(buf.device):
            wire = self._on_wire(buf)
            dist.all_reduce(wire, op=op, group=self.group)
            if wire is not buf:
                buf.copy_(wire)
            off = 0
            for piece in pieces:
                piece.copy_(buf[off:off + piece.numel()])
                off += piece.numel()

    def _all_reduce(self, tensors: Sequence[torch.Tensor], op, what: str
                    ) -> List[torch.Tensor]:
        """``op`` over the axis of every tensor (``_reduce_`` on copies);
        returns new tensors."""
        return self._reduce_([torch.as_tensor(t).detach().clone(
            memory_format=torch.contiguous_format) for t in tensors], op, what)

    def psum_all(self, tensors) -> List[torch.Tensor]:
        """Sum of each tensor over the axis (new tensors)."""
        return self._all_reduce(tensors, dist.ReduceOp.SUM, "psum")

    def psum_all_(self, tensors, *, int8_scales: Optional[int] = None
                  ) -> List[torch.Tensor]:
        """Sum of each (contiguous) tensor over the axis, IN PLACE.
        ``int8_scales``: the tensors hold ``q * scale`` of int8 ``q`` with
        this many f32 scales (``compress.cross_pod_allreduce_``): gloo
        cannot add int8 tensors of different scales, so their f32 values
        go on the wire; a ``RecordingMesh`` counts the int8 payload."""
        return self._reduce_(list(tensors), dist.ReduceOp.SUM, "psum")

    def pmean_all(self, tensors) -> List[torch.Tensor]:
        """``psum / size`` of each tensor, as JAX's ``pmean``."""
        return [t.div_(self.size) for t in
                self._all_reduce(tensors, dist.ReduceOp.SUM, "pmean")]

    def pmax_all(self, tensors) -> List[torch.Tensor]:
        return self._all_reduce(tensors, dist.ReduceOp.MAX, "pmax")

    def psum(self, x) -> torch.Tensor:
        return self.psum_all([x])[0]

    def pmean(self, x) -> torch.Tensor:
        return self.pmean_all([x])[0]

    def pmax(self, x) -> torch.Tensor:
        return self.pmax_all([x])[0]

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Concatenate every rank's ``x`` along ``dim`` in axis order (JAX's
        ``all_gather(..., tiled=True)``), bit for bit: NCCL's
        ``all_gather_into_tensor``, or under gloo an all-reduce SUM of a
        zeroed byte buffer into which this rank writes its block."""
        self._refuse_capture(x.device, "all_gather")
        if not self._check("all_gather"):
            return x
        xt = x.detach().movedim(dim, 0).contiguous()
        b, rest = xt.shape[0], tuple(xt.shape[1:])
        raw = xt.reshape(b, -1).view(torch.uint8)
        with self._timed(x.device):
            if self.backend == "nccl":
                raw = self._on_wire(raw)
                buf = torch.empty((self.size * b, raw.shape[1]),
                                  dtype=torch.uint8, device=raw.device)
                _record("all-gather", buf, self.size, self.axis)
                dist.all_gather_into_tensor(buf, raw, group=self.group)
                buf = buf.to(x.device)
            else:
                buf = torch.zeros((self.size * b, raw.shape[1]),
                                  dtype=torch.uint8, device=x.device)
                buf[self.index * b:(self.index + 1) * b] = raw
                _record("all-reduce", buf, self.size, self.axis)
                dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        return buf.view(x.dtype).reshape((self.size * b,) + rest).movedim(
            0, dim)

    def block(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block of a global ``x`` (dim ``dim`` split evenly
        over the axis): the inverse of ``all_gather``."""
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {self.size} ranks of {self.axis!r}")
        k = n // self.size
        return x.narrow(dim, self.index * k, k)

    def barrier(self) -> None:
        if self._check("barrier"):
            dist.barrier(group=self.group)


@dataclasses.dataclass(frozen=True, eq=False)
class RecordingMesh(DataMesh):
    """A data axis of ``size`` ranks that are not there: every collective
    records what one rank would put on the wire (``record_collectives``:
    one all-reduce a dtype) and sends nothing, so its results are its
    inputs.  The dry run wraps a train cell's optimizer in
    ``cross_replica`` over these to count the gradient all-reduce on meta
    tensors.  The compressed all-reduce records its int8 payload and its
    f32 scales (``compress.wire_bytes``), the bytes a lowering that sends
    int8 puts on the wire."""

    def _reduce_(self, tensors, op, what):
        by_dtype = {}
        for t in tensors:
            by_dtype[t.dtype] = by_dtype.get(t.dtype, 0) + \
                t.numel() * t.element_size()
        for nbytes in by_dtype.values():
            _record_bytes("all-reduce", nbytes, self.size, self.axis)
        return tensors

    def pmean_all(self, tensors):
        return self._reduce_([torch.as_tensor(t) for t in tensors], None,
                             "pmean")

    def psum_all_(self, tensors, *, int8_scales=None):
        tensors = list(tensors)
        if int8_scales is None:
            return self._reduce_(tensors, None, "psum")
        _record_bytes("all-reduce", sum(t.numel() for t in tensors)
                      + 4 * int8_scales, self.size, self.axis)
        return tensors

    def all_gather(self, x, dim=0):
        """Records an all-gather of the result's bytes and returns ``x``
        repeated ``size`` times along ``dim`` (free on meta tensors)."""
        out = torch.cat([x] * self.size, dim=dim)
        _record("all-gather", out, self.size, self.axis)
        return out

    def barrier(self) -> None:
        return None


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh2D:
    """The LM's (data x model) mesh: ``data`` and ``model``, a ``DataMesh``
    each (this rank's group of the axis, or the one-process view of its
    extent).  ``shape`` / ``axis_names`` / ``size`` read as a JAX mesh's,
    for the sharding rules; ``lead`` is the mesh's first rank (global rank
    0: the one that prints and writes)."""
    data: DataMesh
    model: DataMesh
    axes: Tuple[str, str] = ("data", "model")

    @property
    def n_model(self) -> int:
        return self.model.size

    @property
    def lead(self) -> bool:
        return self.data.index == 0 and self.model.index == 0

    @property
    def shape(self) -> dict:
        return {self.axes[0]: self.data.size, self.axes[1]: self.model.size}

    @property
    def axis_names(self) -> tuple:
        return tuple(self.axes)

    @property
    def size(self) -> int:
        return self.data.size * self.n_model

    @property
    def capturable(self) -> bool:
        """Both axes' collectives can sit in a CUDA graph."""
        return self.data.capturable and self.model.capturable


def make_2d_mesh(n_data: int = 0, n_model: int = 1, axes=("data", "model"),
                 *, device="cuda") -> Mesh2D:
    """(data x model) mesh for LM-scale PPO (JAX's ``make_2d_mesh``).

    Where ``torch.distributed`` is initialized, the world's ranks row-major
    over ``(n_data, n_model)`` (``make_axis_meshes``; ``n_data`` 0 takes
    ``world // n_model``), this rank's place on both axes and its device
    ``cuda:(rank % cards)``; a mesh larger or smaller than the world
    raises.  Otherwise the one-process view of both axes."""
    if n_model < 1:
        raise ValueError(f"n_model must be >= 1, got {n_model}")
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        n_data = n_data or max(world // n_model, 1)
        if n_data * n_model != world:
            raise ValueError(f"mesh {n_data}x{n_model} needs "
                             f"{n_data * n_model} ranks, the world has "
                             f"{world}")
        data, model = make_axis_meshes((n_data, n_model), axes,
                                       device=device)
        return Mesh2D(data=data, model=model, axes=tuple(axes))
    n = n_data or 1
    return Mesh2D(data=make_data_mesh(n, axes[0], device=device),
                  model=make_data_mesh(n_model, axes[1], device=device),
                  axes=tuple(axes))


def make_test_mesh(n_data: int = 2, n_model: int = 2, *, device="cpu"
                   ) -> Mesh2D:
    """Small mesh for CPU tests: ``make_2d_mesh`` on the CPU, JAX's 2 x 2
    by default."""
    return make_2d_mesh(n_data, n_model, device=device)


def install(mesh):
    """Register ``mesh`` with the sharding-rule module: every axis but
    'model' is a dp axis, 'model' the tp axis.  ``None`` clears it."""
    from ..models import sharding as shd
    if mesh is None:
        shd.set_global_mesh(None)
        return None
    dp = tuple(a for a in mesh.axis_names if a != "model")
    shd.set_global_mesh(mesh, dp_axes=dp, tp_axis="model")
    return mesh


def install_2d(mesh):
    """Register a (data x model) mesh for the per-rank train path.  Unlike
    ``install`` the data axes are NOT dp axes: inside a rank the batch is
    already the rank's slice, so batch specs resolve to unsharded dims and
    ``n_batch_shards()`` is 1, while the param rules keep their model
    axis (JAX's ``install_2d``, whose batch dims are manual inside
    ``shard_map``)."""
    from ..models import sharding as shd
    if mesh is None:
        shd.set_global_mesh(None)
        return None
    shd.set_global_mesh(mesh, dp_axes=(), tp_axis="model")
    return mesh


def _rank_devices(n: int, device) -> Tuple[torch.device, ...]:
    """The device of each of ``n`` ranks: ``cuda:(rank % device_count)`` on
    the card, so ranks share a card when there are fewer cards than
    ranks."""
    device = torch.device(device)
    if device.type != "cuda":
        return tuple(device for _ in range(n))
    if not torch.cuda.is_available():
        raise RuntimeError("device cuda but no CUDA device is available; "
                           "pass device='cpu' to run the mesh on the CPU")
    count = torch.cuda.device_count()
    return tuple(torch.device("cuda", r % count) for r in range(n))


def make_data_mesh(n_data: int = 0, axis: str = "data", *,
                   device="cuda") -> DataMesh:
    """1-D data-parallel mesh for SPMD RL training (paper §2.4).  This is the
    mesh ``ShardedSampler`` and ``TrainLoop(mesh=...)`` expect.

    Where ``torch.distributed`` is initialized: the mesh over every rank of
    the world (``n_data`` must be 0 or the world size), this rank's place on
    it and its device.  Otherwise the one-process view of ``n_data`` shards
    (0: one) on ``device``, with no process group (the first shard's
    device: the one-process view runs on one device)."""
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_data not in (0, world):
            raise ValueError(f"make_data_mesh({n_data}) on a world of "
                             f"{world} ranks: the data mesh spans every rank")
        devices = _rank_devices(world, device)
        return DataMesh(axis=axis, size=world, index=rank,
                        device=devices[rank], devices=devices,
                        group=dist.group.WORLD)
    n = n_data or 1
    devices = _rank_devices(n, device)
    return DataMesh(axis=axis, size=n, index=0, device=devices[0],
                    devices=devices)


def make_axis_meshes(shape: Sequence[int], axes: Sequence[str], *,
                     device="cuda") -> Tuple[DataMesh, ...]:
    """One ``DataMesh`` per axis of a row-major ``shape`` over the world's
    ranks (rank = the row-major index of its coordinates, as
    ``jax.make_mesh`` lays out devices), for ``cross_replica`` over a tuple
    of axes.  Every rank must call it: each axis' groups are created on
    every rank, in one order."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} vs axes {axes}")
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"world has {world}")
    devices = _rank_devices(world, device)
    coords = [_coords(r, shape) for r in range(world)]
    mine = coords[rank]
    out = []
    for a, name in enumerate(axes):
        me = None
        for line in sorted({c[:a] + c[a + 1:] for c in coords}):
            members = tuple(_flat(line[:a] + (i,) + line[a:], shape)
                            for i in range(shape[a]))
            group = dist.new_group(ranks=list(members),
                                   backend=dist.get_backend(),
                                   timeout=datetime.timedelta(
                                       seconds=COLLECTIVE_TIMEOUT_S))
            if rank in members:
                me = DataMesh(axis=name, size=shape[a], index=mine[a],
                              device=devices[rank],
                              devices=tuple(devices[m] for m in members),
                              group=group)
        out.append(me)
    return tuple(out)


def _flat(coord, shape) -> int:
    i = 0
    for c, s in zip(coord, shape):
        i = i * s + c
    return i


def _coords(i: int, shape) -> tuple:
    out = []
    for s in reversed(shape):
        i, c = divmod(i, s)
        out.append(c)
    return tuple(reversed(out))


def parse_mesh_arg(spec: str):
    """'DxM' (e.g. '2x2', '1x4') -> (n_data, n_model); '1x1'/'' -> None."""
    if not spec:
        return None
    parts = spec.lower().replace(",", "x").split("x")
    if len(parts) != 2:
        raise ValueError(f"mesh spec must be DATAxMODEL, got {spec!r}")
    n_data, n_model = int(parts[0]), int(parts[1])
    if n_data == n_model == 1:
        return None
    return n_data, n_model


def mesh_devices(mesh) -> set:
    """The devices a mesh's ranks use."""
    return set(mesh.devices)


def split_actor_learner(devices, *, mesh=None):
    """Disjoint devices for the decoupled async runner (paper §2.3).

    ``devices``: the ``torch.device``s to choose from.  Returns
    ``(actor_device, learner_device)``.  With several devices the learner
    pins to the FIRST and the actor to the LAST, so the rollout and the
    update never contend for one device; the rest stay free for a future
    sharded learner.  With one device both share it, and the runner gives
    actor and learner a CUDA stream each.

    ``mesh``: a data mesh whose ranks already use devices.  Actor and
    learner then pick from the devices the mesh does NOT use, so they never
    contend with the mesh's ranks; raises when the mesh uses every device
    (on one card it always does): sharing it would silently serialize both,
    which is worse than failing loudly.
    """
    devs = [torch.device(d) for d in devices]
    if mesh is not None:
        owned = mesh_devices(mesh)
        devs = [d for d in devs if d not in owned]
        if not devs:
            raise ValueError(
                f"mesh uses every device ({sorted(map(str, owned))}); shrink "
                "the mesh to leave actor / learner devices free")
    if not devs:
        raise ValueError("no devices available")
    if len(devs) == 1:
        return devs[0], devs[0]
    return devs[-1], devs[0]


# ---------------------------------------------------------------------------
# the rank launcher
# ---------------------------------------------------------------------------

def _rank_main(fn, rank, n, init_method, device, timeout_s, args, results):
    torch.set_num_threads(1)
    try:
        backend, bound = choose_backend(n, device), {}
        if torch.device(device).type == "cuda":
            # NCCL binds a rank's communicators to its current card
            card = _rank_devices(n, device)[rank]
            torch.cuda.set_device(card)
            if backend == "nccl":
                # bound to its card, the group and every group split from
                # it create their communicators now: a CUDA graph's capture
                # cannot create one
                bound["device_id"] = card
        dist.init_process_group(
            backend, init_method=init_method, world_size=n, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s), **bound)
        try:
            out = fn(make_data_mesh(device=device), *args)
        finally:
            dist.destroy_process_group()
        # plain pickle: the queue's own would share tensor storage through
        # file descriptors that die with this process
        results.put(("ok", rank, pickle.dumps(out)))
    except Exception:  # noqa: BLE001 - the parent reports the traceback
        results.put(("error", rank, traceback.format_exc()))


def spawn_ranks(fn: Callable, n: int, args: tuple = (), *, device="cuda",
                timeout: float = 120.0,
                collective_timeout: float = COLLECTIVE_TIMEOUT_S) -> list:
    """Run ``fn(mesh, *args)`` on ``n`` ranks, one spawned process each
    (``choose_backend``: NCCL where each has a card of its own, else gloo),
    and return their results in rank order.

    ``fn`` and ``args`` must pickle (a module-level function), and so must
    what ``fn`` returns (move tensors to the CPU).  Each rank sets one
    intra-op thread, joins a ``file://`` rendezvous and builds its
    ``make_data_mesh(device=device)``.  A collective blocked for
    ``collective_timeout`` seconds raises in its rank.  If any rank raises,
    dies or the ranks have not all returned after ``timeout`` seconds, every
    rank is killed and this raises ``RuntimeError`` with the rank's
    traceback."""
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, n, init_method, device,
                               collective_timeout, args, results))
             for r in range(n)]
    deadline = time.monotonic() + timeout
    out, error, started = {}, None, []
    try:
        for p in procs:
            p.start()
            started.append(p)
        while len(out) < n and error is None:
            left = deadline - time.monotonic()
            if left <= 0:
                error = (f"{n - len(out)} of {n} ranks had not returned after "
                         f"{timeout:.0f} s (ranks done: {sorted(out)})")
                break
            try:
                status, rank, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    # a rank's result may still be in the pipe: one more look
                    try:
                        status, rank, value = results.get(timeout=1.0)
                    except queue_mod.Empty:
                        error = (f"rank {dead[0]} died with exit code "
                                 f"{procs[dead[0]].exitcode} and no result")
                        break
                else:
                    continue
            if status == "ok":
                out[rank] = pickle.loads(value)
            else:
                error = f"rank {rank} raised:\n{value}"
    finally:
        for p in started:
            if error is not None and p.is_alive():
                p.kill()
            p.join(timeout=10.0 if error is None else 5.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if error is not None:
        raise RuntimeError(f"spawn_ranks({getattr(fn, '__name__', fn)}, "
                           f"{n}): {error}")
    return [out[r] for r in range(n)]
