"""ctypes launcher for the hand-written CUDA SSD chunked scan
(``csrc/ssd_scan.cu``), the port of the Pallas TPU kernel
``repro/kernels/ssd_scan/ssd_scan.py::ssd_scan_pallas``.

``ssd_scan_fwd`` takes CUDA tensors only: x, B and C in bf16, dt and A in
f32.  It checks device, dtype, shape and contiguity, raises on anything
else (and on any shape the library is not built for), allocates y and
the final state with ``torch.empty``, launches one kernel on PyTorch's
current stream without synchronising, and raises if the launch reports a
CUDA error.  The library is built with ``nvcc`` and loaded at the
first call, never at import.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build

# The instance the library is built for: mamba2-1.3b (head dim 64, state
# 128, chunk 256; any number of groups that divides the heads).  A config
# that needs another shape adds its instance to csrc/ssd_scan.cu and its
# values here.
HEAD_DIM, D_STATE, CHUNK = 64, 128, 256

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build.build(["ssd_scan"])["ssd_scan"].path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                                     i, p]
        lib.ssd_scan_fwd.restype = i
        lib.ssd_scan_occupancy.argtypes = [i, i, p, p]
        lib.ssd_scan_occupancy.restype = i
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def ssd_scan_fwd(x, dt, A, Bmat, Cmat, *, chunk: int):
    """x:(B,T,H,P) bf16, dt:(B,T,H) f32, A:(H,) f32, B/C:(B,T,G,N) bf16 on
    one CUDA device.  Returns (y (B,T,H,P) bf16, final_state (B,H,P,N) f32).

    ``chunk`` is the chunk length of the scan: 256, or T itself when
    T < 256 (one chunk; the kernel then masks the rows past T, which gives
    the same result)."""
    name = "ssd_scan_fwd"
    args = {"x": x, "dt": dt, "A": A, "B": Bmat, "C": Cmat}
    want = {"x": torch.bfloat16, "dt": torch.float32, "A": torch.float32,
            "B": torch.bfloat16, "C": torch.bfloat16}
    dev = x.device
    for arg, t in args.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, got "
                             f"{t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: {arg} on {t.device}, expected {dev}")
        if t.dtype != want[arg]:
            raise ValueError(f"{name}: {arg} must be {want[arg]}, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if x.dim() != 4 or Bmat.dim() != 4:
        raise ValueError(f"{name}: x and B must be 4-D, got "
                         f"{tuple(x.shape)} {tuple(Bmat.shape)}")
    B, T, H, P = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    if tuple(dt.shape) != (B, T, H) or tuple(A.shape) != (H,) or \
            tuple(Bmat.shape) != (B, T, G, N) or Cmat.shape != Bmat.shape:
        raise ValueError(f"{name}: shapes disagree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bmat.shape)}, C {tuple(Cmat.shape)}")
    if (P, N) != (HEAD_DIM, D_STATE) or G < 1 or H % G:
        raise ValueError(f"{name}: built for head dim {HEAD_DIM}, state "
                         f"{D_STATE} and a number of groups that divides "
                         f"the heads; got P {P}, N {N}, G {G}, H {H}")
    if not (chunk == CHUNK or (chunk == T and T < CHUNK)):
        raise ValueError(f"{name}: built for chunk {CHUNK} (or one chunk "
                         f"of T < {CHUNK}); got chunk {chunk} at T {T}")
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y, state.zero_()
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
            Cmat.data_ptr(), y.data_ptr(), state.data_ptr(), B, T, H, P, G,
            N, CHUNK, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, name, err)
    return y, state


def _raise_on(lib, name: str, err: int) -> None:
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA call failed ({err}: {msg})")


def occupancy(H: int, B: int):
    """(scan blocks one SM holds at once, scan blocks in the grid) at H
    heads and B batch rows: CUDA's occupancy query on the current card, a
    diagnostic that the launch does not use."""
    lib = _library()
    per_sm, grid = ctypes.c_int(), ctypes.c_int()
    _raise_on(lib, "ssd_scan_occupancy", lib.ssd_scan_occupancy(
        H, B, ctypes.byref(per_sm), ctypes.byref(grid)))
    return per_sm.value, grid.value
