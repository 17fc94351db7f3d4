"""ctypes launchers for the hand-written CUDA flash attention kernel
(``csrc/flash_attention.cu``), the port of the Pallas TPU kernel
``repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas``.

``flash_attn_fwd`` (prefill) and ``flash_attn_decode`` (one query token
against a KV cache) take CUDA bf16 tensors only: they check device, dtype,
shape, contiguity and alignment, raise on anything else, allocate the output
with ``torch.empty``, launch on PyTorch's current stream without
synchronising, and raise if the launch reports a CUDA error.  The library
is built with ``nvcc`` and loaded at the first call, never at import.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import build

# The shapes the library is built for: those of the ported config (gemma2-2b,
# d_head 256, two query heads per KV head).  A config that needs another
# shape adds its instance to csrc/flash_attention.cu and its value here.
HEAD_DIMS = (256,)
DECODE_GROUPS = (2,)

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build.build(["flash_attention"])[
            "flash_attention"].path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attn_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i,
                                       f, i, p]
        lib.flash_attn_fwd.restype = i
        lib.flash_attn_decode.argtypes = [p, p, p, p, p, i, i, i, i, i, f, p]
        lib.flash_attn_decode.restype = i
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name: str, **tensors) -> None:
    dev = None
    for arg, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, got "
                             f"{t.device}")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {arg} on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


def _qkv_checks(name: str, q, k, v) -> None:
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {arg} must be bfloat16, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name}: {arg} must be 4-D, got {tuple(t.shape)}")
    B, _, H, dh = q.shape
    if k.shape != v.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} != v {tuple(v.shape)}")
    if k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch or head dim")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {dh} not in {HEAD_DIMS}")
    if H % k.shape[2]:
        raise ValueError(f"{name}: {H} query heads not a multiple of "
                         f"{k.shape[2]} KV heads")


def _kv_len_checks(name: str, kv_len, B: int) -> None:
    if kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (B,):
        raise ValueError(f"{name}: kv_len must be int32 of shape ({B},), got "
                         f"{kv_len.dtype} {tuple(kv_len.shape)}")


def _raise_on(lib, name: str, err: int) -> None:
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")


def flash_attn_fwd(q, k, v, *, causal: bool = True,
                   window: Optional[int] = None,
                   softcap: Optional[float] = None, q_offset: int = 0,
                   kv_len=None):
    """q: (B, T, H, dh); k, v: (B, S, Hkv, dh) bf16 on one CUDA device;
    kv_len: optional (B,) int32.  Returns (B, T, H, dh) bf16."""
    _qkv_checks("flash_attn_fwd", q, k, v)
    tensors = {"q": q, "k": k, "v": v}
    B, T, H, dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if kv_len is not None:
        _kv_len_checks("flash_attn_fwd", kv_len, B)
        tensors["kv_len"] = kv_len
    _check("flash_attn_fwd", **tensors)
    if window is not None and window < 1:
        raise ValueError(f"flash_attn_fwd: window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attn_fwd: softcap must be > 0, got {softcap}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_len is None else kv_len.data_ptr(), out.data_ptr(),
            B, T, S, H, Hkv, dh, int(causal),
            -1 if window is None else int(window),
            0.0 if softcap is None else float(softcap), int(q_offset),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, "flash_attn_fwd", err)
    return out


def flash_attn_decode(q, k, v, kv_len, *, softcap: Optional[float] = None):
    """q: (B, 1, H, dh); k, v: (B, S, Hkv, dh) bf16 on one CUDA device;
    kv_len: (B,) int32 valid cache slots per sequence.  Returns
    (B, 1, H, dh) bf16."""
    _qkv_checks("flash_attn_decode", q, k, v)
    B, T, H, dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if T != 1:
        raise ValueError(f"flash_attn_decode: one query token per sequence, "
                         f"got T={T}")
    if H // Hkv not in DECODE_GROUPS:
        raise ValueError(f"flash_attn_decode: {H // Hkv} query heads per KV "
                         f"head not in {DECODE_GROUPS}")
    _kv_len_checks("flash_attn_decode", kv_len, B)
    _check("flash_attn_decode", q=q, k=k, v=v, kv_len=kv_len)
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attn_decode: softcap must be > 0, got "
                         f"{softcap}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attn_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), B, S, H, Hkv, dh,
            0.0 if softcap is None else float(softcap),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, "flash_attn_decode", err)
    return out
