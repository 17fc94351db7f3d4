"""Roofline terms of a step: its operations and bytes, and the wire bytes
of its collectives.

Counterpart of ``repro/launch/hlo_analysis.py``, under the same name so a
reader finds it.  Eager PyTorch has no HLO: there is no compiled module to
ask for ``cost_analysis()`` and no optimized text to parse.  So:

- ``op_cost(fn, *args)`` runs ``fn`` once under a ``TorchDispatchMode``
  that sees every aten op the step runs (forward, autograd's backward and
  every recompute of a checkpointed block) and counts the FLOPs of the
  products (``torch.utils.flop_counter``'s formulas) and, for every op but
  a view, each input byte once and each output byte once.  On meta tensors
  (``launch/specs.py``) it counts without computing.  Eager runs every op
  on its own, so the bytes are those of unfused ops; XLA's count is of its
  fused module.
- The hand kernels are loaded with ``ctypes`` (``kernels/build.py``), below
  the dispatcher, so no dispatch mode sees them: a count on the card's
  kernel route would miss all attention and SSD work.  ``op_cost`` counts
  the reference route only: on meta (and the CPU) the registry's ``auto``
  resolves to ``ref``, and ``op_cost`` raises where it would resolve to a
  kernel.  The count is therefore the reference's work.  The reference's
  causal attention computes the whole (T, S) score matrix, of which the
  kernel skips the masked half, and writes the scores to memory, where the
  kernel keeps them on chip.
- ``collective_bytes(records)`` applies JAX's ring factors to the
  ``(kind, result_bytes, group_size)`` records that
  ``launch.mesh.record_collectives`` collects from a ``DataMesh``, in
  place of HLO text.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels import registry
from .mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_aten = torch.ops.aten
# allocations that write nothing
_NO_TRAFFIC = {_aten.empty, _aten.empty_strided, _aten.empty_like}


def _tensors(tree) -> list:
    out = []
    for x in pytree.tree_leaves(tree):
        if isinstance(x, torch.nn.Module):
            out.extend(x.parameters())
            out.extend(x.buffers())
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


def _nbytes(tree) -> int:
    seen, n = set(), 0
    for t in _tensors(tree):
        if id(t) not in seen:
            seen.add(id(t))
            n += t.numel() * t.element_size()
    return n


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func.overloadpacket)
        if count is not None:
            self.flops += int(count(*args, **kwargs, out_val=out))
        if not func.is_view and func.overloadpacket not in _NO_TRAFFIC:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def _refuse_kernel_route(args, kwargs) -> None:
    for dev in {t.device for t in _tensors((args, kwargs))}:
        kernels = [op for op in registry.PORTED
                   if registry.backend_for(op, device=dev) == "cuda"]
        if kernels:
            raise ValueError(
                f"op_cost on {dev} tensors would launch the hand kernels of "
                f"{kernels} through ctypes, which no dispatch mode sees: "
                "count on meta tensors (launch/specs.py) or under "
                "kernels.registry.override('ref')")


def op_cost(fn, *args, **kwargs) -> Dict[str, float]:
    """FLOPs and bytes accessed of ``fn(*args, **kwargs)``, counted op by op
    (see the module docstring); ``fn``'s result is dropped."""
    _refuse_kernel_route(args, kwargs)
    with _OpCounter() as counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.flops),
            "bytes accessed": float(counter.bytes)}


def collective_bytes(records: Iterable[Tuple[str, int, int]]
                     ) -> Dict[str, float]:
    """Per-device wire bytes by collective kind (ring factors applied), from
    ``(kind, result_bytes, group_size)`` records: with the result's bytes
    and the group size g,
      all-gather:     operand = result/g -> wire = result*(g-1)/g
      all-reduce:     operand = result   -> wire = 2*result*(g-1)/g
      reduce-scatter: operand = result*g -> wire = result*(g-1)
      all-to-all:     operand = result   -> wire = result*(g-1)/g
      collective-permute:                   wire = result"""
    out = {k: 0.0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for kind, res_bytes, g in records:
        if kind not in out:
            raise ValueError(f"unknown collective {kind!r} "
                             f"(kinds: {_COLLECTIVES})")
        res_bytes, g = float(res_bytes), max(int(g), 1)
        if kind == "all-gather":
            wire = res_bytes * (g - 1) / g
        elif kind == "all-reduce":
            wire = 2.0 * res_bytes * (g - 1) / g
        elif kind == "reduce-scatter":
            wire = res_bytes * (g - 1)
        elif kind == "all-to-all":
            wire = res_bytes * (g - 1) / g
        else:  # collective-permute
            wire = res_bytes
        out[kind] += wire
        counts[kind] += 1
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    out["counts"] = counts
    return out


def roofline_terms(cost: dict, coll, n_chips: int, *,
                   peak_flops=PEAK_FLOPS_BF16, hbm_bw=HBM_BW,
                   link_bw=LINK_BW) -> dict:
    """Three roofline terms in seconds from per-device ``cost`` and
    ``coll`` (``collective_bytes``' dict, or None where the step's
    collectives are not modelled: its terms are then None)."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cbytes = None if coll is None else float(coll.get("total", 0.0))
    t_compute = flops / peak_flops
    t_memory = byts / hbm_bw
    t_collective = None if cbytes is None else cbytes / link_bw
    terms = [("compute", t_compute), ("memory", t_memory)]
    if t_collective is not None:
        terms.append(("collective", t_collective))
    return {
        "flops_per_device": flops,
        "bytes_per_device": byts,
        "collective_bytes_per_device": cbytes,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "bottleneck": max(terms, key=lambda kv: kv[1])[0],
    }
