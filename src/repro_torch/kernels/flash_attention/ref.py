"""Plain-PyTorch version of the flash attention kernel (GQA, causal, window,
softcap, per-sequence ``kv_len``) — the exact math the CUDA kernel must
reproduce, O(T*S) memory.  Port of ``repro/kernels/flash_attention/ref.py``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

MASK_VALUE = -1e30


def attention_reference(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        q_offset: int = 0,
                        kv_len=None):
    """q: (B, T, H, dh); k, v: (B, S, Hkv, dh).  Positions are absolute:
    q token i sits at q_offset + i; k token j at j.  kv_len: optional (B,)
    valid-length mask (slots >= kv_len[b] ignored).  Returns (B, T, H, dh)
    in q.dtype; scores, softmax and P·V in f32."""
    B, T, H, dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, T, Hkv, G, dh)
    scale = 1.0 / math.sqrt(dh)
    scores = torch.einsum("bqhgd,bshd->bhgqs", qg.float(), k.float()) * scale
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    qpos = q_offset + torch.arange(T, device=q.device)
    kpos = torch.arange(S, device=q.device)
    mask = torch.ones((B, T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= (kpos[None, :] <= qpos[:, None])[None]
    if window is not None:
        mask &= (kpos[None, :] > qpos[:, None] - window)[None]
    if kv_len is not None:
        mask &= kpos[None, None, :] < kv_len.to(q.device)[:, None, None]
    scores = torch.where(mask[:, None, None], scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqs,bshd->bqhgd", probs, v.float())
    return out.reshape(B, T, H, dh).to(q.dtype)
