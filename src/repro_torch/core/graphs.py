"""CUDA graphs over one step: the port's counterpart of ``jax.jit`` over a
step, and, replayed, of JAX's ``lax.scan`` over a window of steps.

A step is a function ``fn(*args) -> (new_args, out)``: ``args`` is a pytree
whose tensor leaves are the step's state, ``new_args`` has the same
structure, and ``out`` is whatever else the step returns (metrics, tokens).
``StepGraph`` keeps the state in tensors of its own, at fixed addresses:
after ``fn`` it copies every tensor leaf of ``new_args`` that is not
already the state's leaf back into it.

- On a CUDA device the first call runs ``fn`` eagerly on a side stream (the
  warm-up: kernel loading, library handles, cuBLAS workspaces), the second
  captures it into a ``torch.cuda.CUDAGraph`` and every call from then on
  replays the graph.  Every ``torch.Generator`` among the leaves of
  ``args`` is registered with the graph, so a replay draws the numbers an
  eager call draws from the same generator state: the counterpart of JAX's
  ``split_keys``, where fused and unfused runs see identical keys.  A
  capture or replay that fails raises; nothing falls back to the eager
  step.  The capture runs in ``capture_error_mode="thread_local"``: NCCL's
  collectives can be captured (a data mesh's, a model axis'; see
  launch/mesh.py), and NCCL's watchdog thread queries its events while
  another thread captures, which the default "global" mode turns into a
  failed capture.  Only this thread's calls are checked.  The
  communicators the body uses exist by the capture: an NCCL rank binds
  its group to its card, which creates them eagerly, and the warm-up's
  collectives would create any other.  The event pairs that time the
  captured collectives (``launch.mesh.GraphTimes``) are read between
  replays while a ``time_collectives`` is active.
- On a CPU device every call runs the same body eagerly: a CPU has no
  graphs.

``out`` of a replayed graph lives in the graph's memory and is overwritten
by the next replay: read or clone it before the next call.  Kernel launch
counters (each wrapper's ``launches`` attribute) count real launches: the
counts a capture adds are taken back, and each replay adds them again.
Each capture and each replay is a ``graph.capture`` / ``graph.replay``
span (``telemetry/trace.py``) with the graph's ``name``; a second capture
span of one name is a recapture.
"""
from __future__ import annotations

import gc
from typing import Callable, List, Optional

import torch
from torch.utils import _pytree as pytree

from ..telemetry import trace

__all__ = ["StepGraph"]


def launch_counters() -> List:
    """Every kernel wrapper that counts its launches in ``.launches``."""
    from ..kernels.flash_attention import ops as fa_ops
    from ..kernels.ssd_scan import ops as ssd_ops
    from ..kernels.sum_tree import ops as st_ops
    return [fa_ops.flash_attention, fa_ops.flash_attention_decode,
            ssd_ops.ssd_scan, st_ops.sample_proportional,
            st_ops.tree_sample_blocked]


_PLAIN = (bool, int, float, str, type(None))


def is_leaf(x) -> bool:
    """Generators are leaves (pytree would otherwise not know them)."""
    return isinstance(x, torch.Generator)


def _leaves(tree):
    return pytree.tree_leaves(tree, is_leaf=is_leaf)


def _check_like(dst: torch.Tensor, src) -> None:
    """A state leaf keeps its dtype, shape and device: a copy never casts
    or broadcasts."""
    if not isinstance(src, torch.Tensor):
        raise TypeError(f"a {type(src).__name__} for a tensor leaf of the "
                        "state")
    if (src.dtype, src.shape, src.device) != (dst.dtype, dst.shape,
                                              dst.device):
        raise ValueError(f"state leaf {dst.dtype} {tuple(dst.shape)} on "
                         f"{dst.device} got {src.dtype} {tuple(src.shape)} "
                         f"on {src.device}")


def _own(x: torch.Tensor) -> torch.Tensor:
    """A copy of a state leaf for the graph to keep."""
    y = x.detach().clone()
    return y.requires_grad_() if x.requires_grad else y


def copy_into(dst_tree, src_tree) -> None:
    """Copy each tensor leaf of ``src_tree`` into the matching leaf of
    ``dst_tree`` unless they are the same tensor (same dtype, shape and
    device, or raise)."""
    dst, src = _leaves(dst_tree), _leaves(src_tree)
    if len(dst) != len(src):
        raise ValueError(f"state has {len(dst)} leaves, the step returned "
                         f"{len(src)}")
    # inference mode: the state may hold inference tensors (a serving
    # cache) as well as leaves that require grad (an LM's master weights)
    with torch.inference_mode():
        for d, s in zip(dst, src):
            if isinstance(d, torch.Tensor):
                if s is not d:
                    _check_like(d, s)
                    d.copy_(s)


class StepGraph:
    """One step over fixed state tensors; see the module docstring.

    ``step(*args)`` returns ``(new_args, out)``.  The first call copies
    ``args``' tensors into the graph's own state (the caller's are never
    written).  A later call whose tensor leaves are not the state's (a
    restore, state made elsewhere) has them copied in first; its plain
    leaves (Python ints such as a step count) reach ``fn`` on eager calls,
    and its generators and modules must be the first call's
    (``call_adopting`` takes others' generators by their state).
    ``new_args`` holds the state's tensors and the plain leaves ``fn``
    returned: on a replay, those of the capture, which the caller
    advances itself.  ``device`` decides the mode
    (CUDA: warm-up, capture, replay; CPU: eager).  ``pool`` shares a graph
    memory pool with other StepGraphs whose replays never overlap.
    """

    def __init__(self, fn: Callable, *, device, pool=None,
                 name: str = "step"):
        self.fn = fn
        self.device = torch.device(device)
        self.name = name
        self.pool = pool
        self.args = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.calls = 0          # eager warm-up + captured replays
        self.replays = 0
        self._new = None        # new_args of the capture
        self._out = None
        self._deltas = None
        self._times = None      # the captured collectives' event pairs

    # -- the body ---------------------------------------------------------------
    def _body(self):
        new_args, out = self.fn(*self.args)
        copy_into(self.args, new_args)
        return self._restate(new_args), out

    def _restate(self, new_args):
        """The state's tensors (and generators, modules) with ``new_args``'
        plain Python leaves."""
        mine, spec = pytree.tree_flatten(self.args, is_leaf=is_leaf)
        theirs = _leaves(new_args)
        return pytree.tree_unflatten(
            [t if isinstance(m, _PLAIN) else m
             for m, t in zip(mine, theirs)], spec)

    def _set_args(self, args) -> None:
        args = tuple(args)
        if self.args is None:
            # the state is the graph's own copy: the caller's tensors are
            # never written by a later call
            leaves, spec = pytree.tree_flatten(args, is_leaf=is_leaf)
            self.args = pytree.tree_unflatten(
                [_own(x) if isinstance(x, torch.Tensor) else x
                 for x in leaves], spec)
            return
        mine, spec = pytree.tree_flatten(self.args, is_leaf=is_leaf)
        theirs = _leaves(args)
        if len(mine) != len(theirs):
            raise ValueError(f"{self.name}: state has {len(mine)} leaves, "
                             f"the call passed {len(theirs)}")
        kept = []
        for m, t in zip(mine, theirs):
            if isinstance(m, torch.Tensor):
                if t is not m:
                    _check_like(m, t)
                    with torch.inference_mode():
                        m.copy_(t)
                kept.append(m)
            elif isinstance(m, _PLAIN):
                kept.append(t)
            else:
                # a generator, a module of weights: the graph holds them
                if t is not m:
                    raise ValueError(f"{self.name}: a graph runs on the "
                                     f"{type(m).__name__} it was first "
                                     "called with")
                kept.append(m)
        self.args = pytree.tree_unflatten(kept, spec)

    def _warmup(self):
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            result = self._body()
        cur.wait_stream(side)
        torch.cuda.synchronize(self.device)
        return result

    def call_adopting(self, *args):
        """``self(*args)``, where a generator among ``args`` that is not the
        graph's own lends its state: it is copied into the graph's
        generator in its place before the step, and the graph's state is
        copied back into it after.  A new run's generators (a runner run
        again, a sampler state made anew) so reach the graph captured on
        the first run's, and advance as an eager step advances them."""
        if self.args is None:
            return self(*args)
        mine = _leaves(self.args)
        leaves, spec = pytree.tree_flatten(tuple(args), is_leaf=is_leaf)
        if len(mine) != len(leaves):
            raise ValueError(f"{self.name}: state has {len(mine)} leaves, "
                             f"the call passed {len(leaves)}")
        lent = [(t, m) for t, m in zip(leaves, mine)
                if isinstance(t, torch.Generator) and t is not m]
        for theirs, own in lent:
            if theirs.device != own.device:
                raise ValueError(f"{self.name}: a generator on "
                                 f"{theirs.device} for the graph's on "
                                 f"{own.device}")
            own.set_state(theirs.get_state())
        out = self(*pytree.tree_unflatten(
            [m if isinstance(t, torch.Generator) else t
             for t, m in zip(leaves, mine)], spec))
        for theirs, own in lent:
            theirs.set_state(own.get_state())
        return out

    def _capture(self) -> None:
        from ..launch.mesh import capture_times
        gens = [x for x in _leaves(self.args)
                if isinstance(x, torch.Generator)]
        for g in gens:
            if g.device.type != "cuda":
                raise ValueError(f"{self.name}: generator on {g.device} in a "
                                 "graph on the card")
        counters = launch_counters()
        before = [c.launches for c in counters]
        graph = torch.cuda.CUDAGraph()
        for g in gens:
            graph.register_generator_state(g)
        # no garbage collection inside the capture: a collected graph of an
        # earlier step (a reference cycle) would be destroyed mid-capture,
        # which invalidates it (torch.cuda.graph collects just before)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with trace.span("graph.capture", graph=self.name), \
                    capture_times() as times, torch.cuda.graph(
                        graph, pool=self.pool,
                        capture_error_mode="thread_local"):
                new, out = self._body()
        finally:
            if collecting:
                gc.enable()
        self._deltas = [c.launches - b for c, b in zip(counters, before)]
        for c, b in zip(counters, before):
            c.launches = b   # the capture launched nothing
        self.graph, self._new, self._out = graph, new, out
        self._times = times
        if self.pool is None:
            self.pool = graph.pool()

    def __call__(self, *args):
        """Run one step on ``args``; returns ``(new_args, out)``."""
        self._set_args(args)
        self.calls += 1
        if self.device.type != "cuda":
            return self._body()
        if self.calls == 1:
            return self._warmup()
        if self.graph is None:
            self._capture()
        self._times.settle()
        with trace.span("graph.replay", graph=self.name):
            self.graph.replay()
        self._times.replayed()
        self.replays += 1
        for c, d in zip(launch_counters(), self._deltas):
            c.launches += d
        return self._new, self._out
