"""Error-feedback int8 gradient compression for the data-axis all-reduce,
port of ``repro/train/compress.py``.

The all-reduce sends int8 with one f32 scale per tensor; error feedback
(the quantization residual carried to the next step) keeps the update
unbiased over time (the 1-bit-Adam / EF-SGD family).  Gradients and
residuals are lists of tensors in the params' leaf order, as the port's
optimizers take them.

Usage on each rank of a mesh (``launch/mesh.py``):
    grads, ef = cross_pod_allreduce(grads, ef, axis=mesh)
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils import _pytree as pytree

F32 = torch.float32
INT8_MAX = 127.0


class EFState(NamedTuple):
    residual: Any  # same structure as grads, f32


def init_ef(grads_like) -> EFState:
    return EFState(residual=pytree.tree_map(
        lambda g: torch.zeros(g.shape, dtype=F32, device=g.device),
        grads_like))


def _scales(amax):
    """(the scale q is rounded with, the scale deq multiplies by): a
    non-finite amax poisons the second (``ef_quantize``)."""
    scale = torch.clamp(amax, min=1e-12) / INT8_MAX
    return scale, torch.where(torch.isfinite(amax), scale,
                              torch.full_like(scale, float("nan")))


def _round(comp, scale):
    return torch.clamp(torch.round(comp / scale), -INT8_MAX, INT8_MAX).to(
        torch.int8)


def ef_quantize(x, residual):
    """(x + residual) -> (int8 q, scale, new_residual).

    Roundtrip bound: |(x + residual) - q*scale| <= scale elementwise.  A
    non-finite input poisons the SCALE (nan): the int8 cast of nan / inf is
    finite garbage, so without this the dequantized grads would silently
    look plausible; instead deq and the carried residual both go nan and
    the nan_guard sentinel fires downstream.
    """
    comp = x.to(F32) + residual
    q_scale, scale = _scales(torch.amax(torch.abs(comp)))
    q = _round(comp, q_scale)
    deq = q.to(F32) * scale
    return q, scale, comp - deq


def ef_dequantize(q, scale):
    return q.to(F32) * scale


# elements of a leaf that cross_pod_allreduce_ quantizes at once
CHUNK = 2 ** 24


def _chunks(flat):
    return [flat[i:i + CHUNK] for i in range(0, flat.numel(), CHUNK)]


def cross_pod_allreduce_(grads, residual, *, axis, groups=None,
                         model=None) -> list:
    """``cross_pod_allreduce`` IN PLACE on lists of contiguous f32 tensors:
    each gradient becomes the mean of the dequantized sum, each residual
    the new residual; returns ``grads``.  ``ef_quantize``'s arithmetic, a
    leaf ``CHUNK`` elements at a time after one pass for its amax, so a
    1.5 B-parameter gradient needs no copy of itself: the same values bit
    for bit.  ``groups`` (index lists that partition the leaves; None:
    each leaf alone) share one scale a group, the amax over its leaves:
    JAX quantizes a stacked layer leaf with one scale, the port keeps its
    layers apart (``models.convert.jax_leaf_groups``).  ``model``: the
    model axis the leaves are split over (a ``DataMesh``): a scale is the
    amax over the logical leaf, so the groups' amaxes are maxed over it
    (one all-reduce); each rank's residual holds its block."""
    if groups is None:
        groups = [[i] for i in range(len(grads))]
    parts, amaxes = [], []
    for group in groups:
        pieces = [(_chunks(grads[i].view(-1)), _chunks(residual[i].view(-1)))
                  for i in group]
        chunk_max = [torch.amax(torch.abs(a + b))
                     for gs, rs in pieces for a, b in zip(gs, rs)]
        amaxes.append(torch.amax(torch.stack(chunk_max)) if chunk_max else
                      torch.zeros((), dtype=F32,
                                  device=grads[group[0]].device))
        parts.append(pieces)
    if model is not None and amaxes:
        amaxes = list(model.pmax(torch.stack(amaxes)).unbind())
    for pieces, amax in zip(parts, amaxes):
        q_scale, scale = _scales(amax)
        for gs, rs in pieces:
            for a, b in zip(gs, rs):
                comp = a + b
                deq = _round(comp, q_scale).to(F32) * scale
                b.copy_(comp - deq)
                a.copy_(deq)
    n = float(axis.size)
    return [s.div_(n) for s in axis.psum_all_(grads,
                                              int8_scales=len(groups))]


def cross_pod_allreduce(grads, ef: EFState, *, axis) -> tuple:
    """Mean-all-reduce ``grads`` over the mesh ``axis`` (a
    ``launch.mesh.DataMesh``) in int8 with error feedback; returns (grads,
    EFState).

    Each rank contributes q * scale and the sum is the receiver-side f32
    dequantize-and-accumulate, divided by the axis size.  The dequantize
    MUST be f32: the EF residual compensates the f32 deq (``ef_quantize``),
    so a lower-precision value would apply an update the residual never
    sees and the telescoping guarantee (sum applied -> sum true grads)
    would break.  The sum is one all-reduce over every leaf at once (the
    f32 values on gloo, ``DataMesh.psum_all_``); ``cross_pod_allreduce_``
    on copies.
    """
    flat_g, spec = pytree.tree_flatten(grads)
    g = [x.to(F32).clone(memory_format=torch.contiguous_format)
         for x in flat_g]
    r = [x.to(F32).clone(memory_format=torch.contiguous_format)
         for x in pytree.tree_leaves(ef.residual)]
    cross_pod_allreduce_(g, r, axis=axis)
    return (pytree.tree_unflatten(g, spec),
            EFState(residual=pytree.tree_unflatten(r, spec)))


def wire_bytes(grads_like, groups=None) -> dict:
    """Per-step all-reduce payload accounting for one gradient tree: f32
    baseline vs the int8 path (1 byte an element + one f32 scale a tensor,
    or a group of ``cross_pod_allreduce_``'s ``groups``)."""
    leaves = pytree.tree_leaves(grads_like)
    n_elems = sum(int(l.numel()) for l in leaves)
    fp32 = 4 * n_elems
    int8 = n_elems + 4 * (len(leaves) if groups is None else len(groups))
    return {"fp32_bytes": fp32, "int8_bytes": int8,
            "bytes_saved": fp32 - int8,
            "ratio": fp32 / max(int8, 1)}
