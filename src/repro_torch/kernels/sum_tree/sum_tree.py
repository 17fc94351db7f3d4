"""Stratified proportional sampling over blocked priorities: the plain
PyTorch version of the Pallas TPU kernel
``repro/kernels/sum_tree/sum_tree.py::sample_pallas`` (body
``_sample_kernel``) and the ctypes launcher of its hand-written CUDA port
(``csrc/sum_tree.cu``).

Both compute, for leaves (n_blocks, bs) f32, block sums (n_blocks,) f32 and
positions u (batch,) f32:

    cum   = cumsum(block_sums),  total = cum[-1]
    blk   = min(#{cum <= u}, n_blocks - 1)
    off   = u - (cum[blk - 1] if blk > 0 else 0)
    inner = min(#{cumsum(leaves[blk]) <= off}, bs - 1)
    idx   = blk * bs + inner (int32),  prob = leaves[blk, inner] / max(total, 1e-12)

i.e. the smallest i with cumsum(p)[i] > u, clamped at both levels.

``sample_blocked`` takes CUDA tensors only.  It checks device, dtype, shape
and contiguity, raises on anything else (and on a row longer than
``MAX_BLOCK_SIZE`` or more than ``MAX_BLOCKS`` block sums), allocates idx and
prob with ``torch.empty``, launches on PyTorch's current stream without
synchronising, and raises if the launch reports a CUDA error.  The library
is built with ``nvcc`` and loaded at the first call, never at import.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build

# what csrc/sum_tree.cu takes: one row of leaves per warp (16 a lane), and
# the scanned block sums in 33 KB of shared memory (one pad word every 32)
MAX_BLOCK_SIZE = 512
MAX_BLOCKS = 8192

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build.build(["sum_tree"])["sum_tree"].path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sum_tree_sample.argtypes = [p, p, p, p, p, i, i, i, p]
        lib.sum_tree_sample.restype = i
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def sample_plain(leaves, block_sums, u):
    """The two-level math of ``_sample_kernel`` in plain PyTorch ops."""
    n_blocks, bs = leaves.shape
    cum = torch.cumsum(block_sums, 0)
    total = cum[-1]
    blk = torch.sum(cum[None, :] <= u[:, None], dim=1)
    blk = torch.clamp(blk, max=n_blocks - 1)
    base = torch.where(blk > 0, cum[torch.clamp(blk - 1, min=0)],
                       torch.zeros((), dtype=cum.dtype, device=cum.device))
    off = u - base
    rows = leaves[blk]                                   # (batch, bs)
    cum2 = torch.cumsum(rows, 1)
    inner = torch.sum(cum2 <= off[:, None], dim=1)
    inner = torch.clamp(inner, max=bs - 1)
    idx = blk * bs + inner
    pr = torch.gather(rows, 1, inner[:, None])[:, 0]
    return idx.to(torch.int32), pr / torch.clamp(total, min=1e-12)


def sample_blocked(leaves, block_sums, u):
    """leaves (n_blocks, bs), block_sums (n_blocks,), u (batch,): f32 CUDA
    tensors on one device.  Returns (idx (batch,) int32, prob (batch,) f32)
    from one launch of the CUDA kernel."""
    name = "sum_tree_sample"
    args = {"leaves": leaves, "block_sums": block_sums, "u": u}
    dev = leaves.device
    for arg, t in args.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, got "
                             f"{t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: {arg} on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be torch.float32, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if leaves.dim() != 2 or block_sums.dim() != 1 or u.dim() != 1:
        raise ValueError(f"{name}: want leaves (n_blocks, bs), block_sums "
                         f"(n_blocks,), u (batch,); got {tuple(leaves.shape)}, "
                         f"{tuple(block_sums.shape)}, {tuple(u.shape)}")
    n_blocks, bs = leaves.shape
    if block_sums.shape[0] != n_blocks:
        raise ValueError(f"{name}: {block_sums.shape[0]} block sums for "
                         f"{n_blocks} rows of leaves")
    if not (1 <= bs <= MAX_BLOCK_SIZE):
        raise ValueError(f"{name}: block size {bs} outside 1..{MAX_BLOCK_SIZE}")
    if not (1 <= n_blocks <= MAX_BLOCKS):
        raise ValueError(f"{name}: {n_blocks} blocks outside 1..{MAX_BLOCKS}")
    batch = u.shape[0]
    idx = torch.empty((batch,), dtype=torch.int32, device=dev)
    prob = torch.empty((batch,), dtype=torch.float32, device=dev)
    if batch == 0:
        return idx, prob
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.sum_tree_sample(
            leaves.data_ptr(), block_sums.data_ptr(), u.data_ptr(),
            idx.data_ptr(), prob.data_ptr(), n_blocks, bs, batch,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")
    return idx, prob
