"""ctypes launchers for the hand-written CUDA flash attention kernels
(``csrc/flash_attention.cu``), the port of the Pallas TPU kernel
``repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas``.

``flash_attn_fwd`` (prefill) runs ``wgmma`` fed by TMA: a block of 128
query rows, K / V tiles of 64 keys in a two-stage ring, the swizzle a
function of the head dim; the C side builds the tensor maps on every call.
``flash_attn_decode`` (one query token against a KV cache) cuts the cache
into the splits of :func:`decode_split_plan` (a pure function of B, Hkv and
S: it never reads ``kv_len``), one thread-block cluster per (batch, KV
head) that merges its splits in the same launch; up to four query heads a
KV head on the CUDA cores, 8 or more on the tensor cores.  Both take CUDA bf16 tensors only: they check
device, dtype, shape, contiguity and alignment, raise on anything else,
allocate the output with ``torch.empty``, launch one kernel on PyTorch's
current stream without synchronising, and raise if the launch reports a
CUDA error.  The library is built with ``nvcc`` and loaded at the first
call, never at import.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional, Tuple

import torch

from .. import build

# The shapes the library is built for (the instance lists of
# csrc/flash_attention.cu): the head dims of the ported configs and their
# smoke configs for prefill, and each (head dim, query heads a KV head) pair
# of theirs for decode.  A config that needs another shape adds its instance
# there and its value here.  (128, 12) and (128, 24) are granite-34b's
# local group on a 'model' axis of 4 and 2 ranks (its one KV head
# replicated, each rank's 12 / 24 query heads reading it).
HEAD_DIMS = (16, 64, 96, 112, 128, 256)
DECODE_INSTANCES = frozenset({(16, 1), (16, 2), (16, 4), (64, 1), (96, 1),
                              (112, 1), (128, 1), (128, 4), (128, 8),
                              (128, 12), (128, 16), (128, 24), (128, 48),
                              (256, 2)})

# flash_attn_fwd's launch: a block of two consumer warpgroups and one
# producer warpgroup takes 128 query rows of one (batch, head)
FWD_BLOCK_Q = 128
FWD_THREADS = 384

# flash_attn_decode's split over the cache: the H100 has 132 SMs and takes
# three of the kernel's blocks on each, so the plan aims at >= 2 * 132
# blocks; a cluster holds at most 8 blocks (the portable size), and a split
# gets at least DECODE_MIN_CHUNK slots.
DECODE_TARGET_BLOCKS = 2 * 132
DECODE_MAX_SPLIT = 8
DECODE_MIN_CHUNK = 16

_lib = None


@lru_cache(maxsize=None)
def decode_split_plan(B: int, Hkv: int, S: int) -> Tuple[int, int]:
    """(n_split, chunk) of ``flash_attn_decode``: split i of each (batch,
    KV head) takes the cache slots [i * chunk, min((i + 1) * chunk, S)),
    clipped to kv_len on the card.  A pure function of the shapes: it never
    reads kv_len, which would cost a device-to-host sync a call."""
    want = -(-DECODE_TARGET_BLOCKS // max(B * Hkv, 1))
    n_split = max(1, min(DECODE_MAX_SPLIT, want,
                         -(-S // DECODE_MIN_CHUNK)))
    return n_split, -(-S // n_split)


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build.build(["flash_attention"])[
            "flash_attention"].path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attn_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i,
                                       f, i, p]
        lib.flash_attn_fwd.restype = i
        lib.flash_attn_decode.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                          f, p]
        lib.flash_attn_decode.restype = i
        lib.flash_attn_decode_max_clusters.argtypes = [i, i, i, p]
        lib.flash_attn_decode_max_clusters.restype = i
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def decode_max_clusters(n_split: int, dh: int, G: int) -> int:
    """How many clusters of ``n_split`` decode blocks of the ``(dh, G)``
    instance the current card holds at once (CUDA's occupancy query; a
    diagnostic, not used by the launch)."""
    lib = _library()
    n = ctypes.c_int()
    _raise_on(lib, "decode_max_clusters",
              lib.flash_attn_decode_max_clusters(n_split, dh, G,
                                                 ctypes.byref(n)))
    return n.value


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
    if (dh, H // Hkv) not in DECODE_INSTANCES:
        raise ValueError(f"flash_attn_decode: {H // Hkv} query heads per KV "
                         f"head at head dim {dh} not in "
                         f"{sorted(DECODE_INSTANCES)}")
    _kv_len_checks("flash_attn_decode", kv_len, B)
    _check("flash_attn_decode", q=q, k=k, v=v, kv_len=kv_len)
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attn_decode: softcap must be > 0, got "
                         f"{softcap}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    n_split, chunk = decode_split_plan(B, Hkv, S)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attn_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), B, S, H, Hkv, dh, n_split, chunk,
            0.0 if softcap is None else float(softcap),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, "flash_attn_decode", err)
    return out
