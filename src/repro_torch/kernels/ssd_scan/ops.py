"""Public SSD-scan op: the hand-written CUDA kernel on the card, its plain
version on the CPU, differentiable.

Port of ``repro/kernels/ssd_scan/ops.py``.  ``ssd_scan`` is a
``torch.autograd.Function``, the counterpart of the JAX ``custom_vjp``:

- forward: for CUDA tensors it launches the kernel (``ssd_scan_fwd``) and
  counts the launch in ``ssd_scan.launches``; the launcher raises on what
  the kernel does not take -- there is no fallback on the card.  For CPU
  tensors it computes the plain version, ``models/layers.py::ssd_chunked``.
- backward: recomputes through ``ssd_chunked`` under ``torch.enable_grad()``
  and returns its ``torch.autograd.grad`` -- as JAX, which has no backward
  kernel.

The kernel masks ragged T itself, so the JAX wrapper's dt = 0 padding is
gone (``ssd_chunked`` still pads, with the same result).
"""
from __future__ import annotations

import torch

from .ssd_scan import ssd_scan_fwd


def _ssd_chunked():
    # lazy: models.layers imports this module's package at call time, and
    # ref -> layers -> ops would cycle at import time otherwise
    from ...models.layers import ssd_chunked

    return ssd_chunked


def _on_cpu(*tensors) -> bool:
    """True for CPU tensors, False for CUDA ones; raise for anything else."""
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if all(t.is_cuda for t in tensors):
        return False
    raise ValueError(f"ssd_scan: tensors must all be on the CPU or all on "
                     f"CUDA, got {[str(t.device) for t in tensors]}")


class _SSDScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dt, A, Bmat, Cmat, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, Bmat, Cmat)
        ctx.set_materialize_grads(False)
        if _on_cpu(x, dt, A, Bmat, Cmat):
            return _ssd_chunked()(x, dt, A, Bmat, Cmat, chunk)
        out = ssd_scan_fwd(x, dt, A, Bmat, Cmat, chunk=chunk)
        ssd_scan.launches += 1
        return out

    @staticmethod
    def backward(ctx, gy, gstate):
        inputs = ctx.saved_tensors
        wanted = [i for i, need in enumerate(ctx.needs_input_grad[:5]) if need]
        grads = [None] * 6
        pairs = [(o, g) for o, g in zip((0, 1), (gy, gstate)) if g is not None]
        if not wanted or not pairs:
            return tuple(grads)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(i in wanted)
                      for i, t in enumerate(inputs)]
            outs = _ssd_chunked()(*leaves, ctx.chunk)
            got = torch.autograd.grad([outs[o] for o, _ in pairs],
                                      [leaves[i] for i in wanted],
                                      [g for _, g in pairs],
                                      allow_unused=True)
        for i, g in zip(wanted, got):
            grads[i] = g
        return tuple(grads)


def ssd_scan(x, dt, A, Bmat, Cmat, *, chunk: int = 64):
    """x:(B,T,H,P) dt:(B,T,H) A:(H,)<0  B/C:(B,T,G,N) -> (y, final_state).
    Differentiable (backward through the plain chunked scan)."""
    return _SSDScan.apply(x, dt, A, Bmat, Cmat, chunk)


ssd_scan.launches = 0
