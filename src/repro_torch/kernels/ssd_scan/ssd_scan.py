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

# The (head dim P, state N, chunk) instances the library is built for (the
# REPRO_SSD_INSTANCES of csrc/ssd_scan.cu; any number of groups that
# divides the heads): mamba2-1.3b, zamba2-7b, and the smoke mamba2 and
# zamba2 (on the CUDA cores).  A config that needs another shape adds its
# instance there and here.
INSTANCES = frozenset({(64, 128, 256), (64, 64, 256), (16, 16, 8)})

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build.build(["ssd_scan"])["ssd_scan"].path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                                     i, p]
        lib.ssd_scan_fwd.restype = i
        lib.ssd_scan_occupancy.argtypes = [i, i, i, i, i, p, p]
        lib.ssd_scan_occupancy.restype = i
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def ssd_scan_fwd(x, dt, A, Bmat, Cmat, *, chunk: int):
    """x:(B,T,H,P) bf16, dt:(B,T,H) f32, A:(H,) f32, B/C:(B,T,G,N) bf16 on
    one CUDA device.  Returns (y (B,T,H,P) bf16, final_state (B,H,P,N) f32).

    ``chunk`` is the chunk length of the scan: the instance's (256, or 8
    for P 16, N 16), or T itself when T is shorter (one chunk; the kernel
    then masks the rows past T, which gives the same result)."""
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
    built = built_chunk(P, N, chunk, T)
    if built is None or G < 1 or H % G:
        raise ValueError(f"{name}: built for head dim, state and chunk in "
                         f"{sorted(INSTANCES)} (or one chunk of T under the "
                         "instance's) and a number of groups that divides "
                         f"the heads; got P {P}, N {N}, chunk {chunk} at T "
                         f"{T}, G {G}, H {H}")
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y, state.zero_()
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
            Cmat.data_ptr(), y.data_ptr(), state.data_ptr(), B, T, H, P, G,
            N, built, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, name, err)
    return y, state


def built_chunk(P: int, N: int, chunk: int, T: int):
    """The chunk of the built instance that runs a scan of chunk ``chunk``
    over T rows at head dim P and state N -- the instance's own, or one
    short chunk (chunk == T under it) -- or None where none is built."""
    for p, n, q in INSTANCES:
        if (p, n) == (P, N) and (chunk == q or (chunk == T and T < q)):
            return q
    return None


def _raise_on(lib, name: str, err: int) -> None:
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA call failed ({err}: {msg})")


def occupancy(H: int, B: int, P: int = 64, N: int = 128, chunk: int = 256):
    """(scan blocks one SM holds at once, scan blocks in the grid) of the
    (P, N, chunk) instance at H heads and B batch rows: CUDA's occupancy
    query on the current card, a diagnostic that the launch does not
    use."""
    lib = _library()
    per_sm, grid = ctypes.c_int(), ctypes.c_int()
    _raise_on(lib, "ssd_scan_occupancy", lib.ssd_scan_occupancy(
        P, N, chunk, H, B, ctypes.byref(per_sm), ctypes.byref(grid)))
    return per_sm.value, grid.value
