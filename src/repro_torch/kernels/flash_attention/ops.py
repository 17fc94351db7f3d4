"""Public flash-attention ops: the hand-written CUDA kernel on the card, its
plain version on the CPU.

Port of ``repro/kernels/flash_attention/ops.py``.  ``flash_attention`` is the
differentiable prefill / train-forward op and ``flash_attention_decode`` the
KV-cache decode op (one query token against a partially-filled cache,
per-sequence ``kv_len``; the decode path never needs gradients).  For CUDA
tensors each forward launches its kernel entry point (``flash_attn_fwd`` /
``flash_attn_decode``) and counts the launch in its ``launches`` attribute;
the launcher raises on what the kernel does not take — there is no fallback
on the card.  For CPU tensors each computes ``attention_reference``, so the
call sites stay testable without a GPU.

``flash_attention`` is one ``torch.autograd.Function`` on both devices, the
counterpart of JAX's ``custom_vjp`` (``_fa`` / ``_fa_fwd`` / ``_fa_bwd``): the
forward is the kernel (or, on the CPU, the reference), the residuals are the
inputs ``(q, k, v)`` alone, and the backward differentiates
``attention_reference`` on them.  That backward is the reference's own
design, not a plain version standing in for a missing kernel: the JAX
package has no Pallas backward either (its ``_fa_bwd`` lets XLA
differentiate the oracle), so the kernel's gain is the forward's score
traffic and the backward is the same math on both devices.

The kernel masks ragged T and S itself, so the JAX wrapper's padding
(``_pad_to``) and its non-causal-padding reference fallback are gone.
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attn_decode, flash_attn_fwd
from .ref import attention_reference


def _on_cpu(name: str, *tensors) -> bool:
    """True for CPU tensors, False for CUDA ones; raise for anything else."""
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if all(t.is_cuda for t in tensors):
        return False
    raise ValueError(f"{name}: tensors must all be on the CPU or all on CUDA, "
                     f"got {[str(t.device) for t in tensors]}")


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel on CUDA tensors, ``attention_reference`` on CPU
    ones.  Saves ``(q, k, v)`` only, as JAX's ``_fa_fwd``.  Backward: the
    vjp of ``attention_reference`` on the saved inputs (JAX's ``_fa_bwd``),
    so dk / dv sum over the query heads of each KV head through the
    reference's GQA reshape, and each gradient comes back in its input's
    dtype."""

    @staticmethod
    def forward(ctx, q, k, v, opts):
        causal, window, softcap, q_offset = opts
        ctx.opts = opts
        ctx.save_for_backward(q, k, v)
        if _on_cpu("flash_attention", q, k, v):
            return attention_reference(q, k, v, causal=causal, window=window,
                                       softcap=softcap, q_offset=q_offset)
        out = flash_attn_fwd(q, k, v, causal=causal, window=window,
                             softcap=softcap, q_offset=q_offset)
        flash_attention.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        causal, window, softcap, q_offset = ctx.opts
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = attention_reference(q, k, v, causal=causal, window=window,
                                      softcap=softcap, q_offset=q_offset)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    q_offset: int = 0):
    """Fused GQA attention. q:(B,T,H,dh), k/v:(B,S,Hkv,dh) -> (B,T,H,dh).
    Differentiable: the backward is reference math (``_FlashAttention``)."""
    return _FlashAttention.apply(q, k, v, (causal, window, softcap, q_offset))


flash_attention.launches = 0


def flash_attention_decode(q, k, v, kv_len, *,
                           softcap: Optional[float] = None):
    """Decode attention against a KV cache.  q:(B,1,H,dh),
    k/v:(B,S,Hkv,dh), kv_len:(B,) valid slots per sequence.  Ring-buffer
    (sliding-window) caches pass kv_len=min(len+1, S): slot order carries no
    positional meaning, so validity is the whole mask."""
    kv_len = torch.as_tensor(kv_len, dtype=torch.int32, device=q.device)
    if _on_cpu("flash_attention_decode", q, k, v):
        return attention_reference(q, k, v, causal=False, softcap=softcap,
                                   kv_len=kv_len)
    out = flash_attn_decode(q, k, v, kv_len.contiguous(), softcap=softcap)
    flash_attention_decode.launches += 1
    return out


flash_attention_decode.launches = 0
