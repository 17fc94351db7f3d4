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


def ef_quantize(x, residual):
    """(x + residual) -> (int8 q, scale, new_residual).

    Roundtrip bound: |(x + residual) - q*scale| <= scale elementwise.  A
    non-finite input poisons the SCALE (nan): the int8 cast of nan / inf is
    finite garbage, so without this the dequantized grads would silently
    look plausible; instead deq and the carried residual both go nan and
    the nan_guard sentinel fires downstream.
    """
    comp = x.to(F32) + residual
    amax = torch.amax(torch.abs(comp))
    scale = torch.clamp(amax, min=1e-12) / INT8_MAX
    q = torch.clamp(torch.round(comp / scale), -INT8_MAX, INT8_MAX).to(
        torch.int8)
    scale = torch.where(torch.isfinite(amax), scale,
                        torch.full_like(scale, float("nan")))
    deq = q.to(F32) * scale
    return q, scale, comp - deq


def ef_dequantize(q, scale):
    return q.to(F32) * scale


def cross_pod_allreduce(grads, ef: EFState, *, axis) -> tuple:
    """Mean-all-reduce ``grads`` over the mesh ``axis`` (a
    ``launch.mesh.DataMesh``) in int8 with error feedback; returns (grads,
    EFState).

    Each rank contributes q * scale and the sum is the receiver-side f32
    dequantize-and-accumulate, divided by the axis size.  The dequantize
    MUST be f32: the EF residual compensates the f32 deq (``ef_quantize``),
    so a lower-precision value would apply an update the residual never
    sees and the telescoping guarantee (sum applied -> sum true grads)
    would break.  The sum is one all-reduce over every leaf at once.
    """
    flat_g, spec = pytree.tree_flatten(grads)
    flat_r = pytree.tree_leaves(ef.residual)
    deqs, new_r = [], []
    for g, r in zip(flat_g, flat_r):
        q, scale, res = ef_quantize(g, r)
        deqs.append(q.to(F32) * scale)
        new_r.append(res)
    n = float(axis.size)
    new_g = [s / n for s in axis.psum_all(deqs)]
    return (pytree.tree_unflatten(new_g, spec),
            EFState(residual=pytree.tree_unflatten(new_r, spec)))


def wire_bytes(grads_like) -> dict:
    """Per-step all-reduce payload accounting for one gradient tree: f32
    baseline vs the int8 path (1 byte an element + one f32 scale a
    tensor)."""
    leaves = pytree.tree_leaves(grads_like)
    n_elems = sum(int(l.numel()) for l in leaves)
    fp32 = 4 * n_elems
    int8 = n_elems + 4 * len(leaves)
    return {"fp32_bytes": fp32, "int8_bytes": int8,
            "bytes_saved": fp32 - int8,
            "ratio": fp32 / max(int8, 1)}
