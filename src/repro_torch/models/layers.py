"""Neural-net layers of the dense family's serving path, in PyTorch.

Port of ``repro/models/layers.py`` (rmsnorm, RoPE, GQA attention with
sliding window + softcap, KV-cache decode attention, SwiGLU MLP).  Each
layer is an ``nn.Module`` holding parameters named after the JAX leaves;
the math lives in plain functions over (module, tensor) with the JAX
signatures, so the backbone and the serving engine port line for line.

dtype discipline, as in JAX:
- activations run in the compute dtype (bf16 on the card); every weight is
  cast to it right before its product;
- attention scores accumulate in f32 (``preferred_element_type=F32``) and
  the softmax runs in f32; on the ``ref`` path the probabilities are cast to
  ``v.dtype`` before P·V (the kernel keeps them in its own precision);
- ``rmsnorm`` runs in f32 and casts back.

KV caches are updated IN PLACE (JAX returns new arrays): ``attention_decode``
writes the new token's K/V into the cache tensors it is given and returns
the same tensors.  MoE, SSD and cross-attention are not ported yet.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from ..kernels import registry as kernel_registry
from ..kernels.flash_attention.ops import flash_attention, flash_attention_decode

F32 = torch.float32
MASK_VALUE = -1e30


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def _dense_init(shape, in_axis_size, *, generator, device, dtype):
    """N(0, 1/in_axis_size) weights, the scale of the JAX ``_dense_init``."""
    scale = 1.0 / math.sqrt(max(in_axis_size, 1))
    w = torch.randn(shape, generator=generator, device=device, dtype=dtype)
    return nn.Parameter(w.mul_(scale), requires_grad=False)


def _empty(shape, *, device, dtype):
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


class RMSNorm(nn.Module):
    """Leaf ``scale`` (d,), kept in f32."""

    def __init__(self, d: int, *, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device, dtype=F32),
                                  requires_grad=False)


def rmsnorm(params, x, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * params.scale
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(d_head: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=F32,
                                         device=device) / d_head))


def apply_rope(x, positions, theta: float):
    """x: (..., T, H, dh); positions: broadcastable to (..., T)."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, x.device)  # (dh/2,)
    ang = positions[..., None].to(F32) * inv  # (..., T, dh/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, optional sliding window + softcap)
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    """Leaves ``wq`` (D,H,dh), ``wk``/``wv`` (D,Hkv,dh), ``wo`` (H,dh,D)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype, generator=None):
        super().__init__()
        D, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        shapes = {"wq": ((D, H, dh), D), "wk": ((D, Hkv, dh), D),
                  "wv": ((D, Hkv, dh), D), "wo": ((H, dh, D), H * dh)}
        for name, (shape, fan_in) in shapes.items():
            p = (_empty(shape, device=device, dtype=dtype) if generator is None
                 else _dense_init(shape, fan_in, generator=generator,
                                  device=device, dtype=dtype))
            setattr(self, name, p)


def _proj(x, w):
    """x (..., D) @ w (D, *out) in x's dtype -> (..., *out)."""
    out_shape = w.shape[1:]
    y = x @ w.to(x.dtype).reshape(w.shape[0], -1)
    return y.reshape(*x.shape[:-1], *out_shape)


def _out_proj(o, wo):
    """o (B,T,H,dh) @ wo (H,dh,D) -> (B,T,D)."""
    B, T = o.shape[:2]
    return o.reshape(B, T, -1) @ wo.to(o.dtype).reshape(-1, wo.shape[-1])


def _softcap(scores, cap: Optional[float]):
    if cap is None:
        return scores
    return torch.tanh(scores / cap) * cap


def _attend_block(q, k, v, mask, softcap, scale):
    """q:(B,Q,Hkv,G,dh) k/v:(B,S,Hkv,dh) mask:(B|1,1,1,Q,S) -> (B,Q,Hkv,G,dh).

    f32 scores and softmax; the einsum keeps GQA groups without
    materializing repeated KV heads."""
    scores = torch.einsum("bqhgd,bshd->bhgqs", q.float(), k.float()) * scale
    scores = _softcap(scores, softcap)
    scores = torch.where(mask, scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgqs,bshd->bqhgd", probs.to(v.dtype), v)


def multihead_attention(q, k, v, *, q_positions, k_positions,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None, chunk_q: int = 512):
    """Chunked attention (the ``ref`` path). q:(B,Tq,H,dh); k,v:(B,Tk,Hkv,dh).
    positions are absolute token indices (B,T) or (T,).  Returns (B,Tq,H,dh)."""
    B, Tq, H, dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(B, Tq, Hkv, G, dh)
    qpos = q_positions.expand(B, Tq) if q_positions.dim() <= 1 else q_positions
    kpos = k_positions.expand(B, Tk) if k_positions.dim() <= 1 else k_positions

    def mask_for(qp):  # qp: (B, Q) -> (B,1,1,Q,S)
        m = torch.ones((B, 1, 1, qp.shape[1], Tk), dtype=torch.bool,
                       device=q.device)
        if causal:
            m &= kpos[:, None, None, None, :] <= qp[:, None, None, :, None]
        if window is not None:
            m &= kpos[:, None, None, None, :] > qp[:, None, None, :, None] - window
        return m

    if Tq <= chunk_q or Tq % chunk_q != 0:
        return _attend_block(qg, k, v, mask_for(qpos), softcap,
                             scale).reshape(B, Tq, H, dh)
    outs = [_attend_block(qg[:, i:i + chunk_q], k, v,
                          mask_for(qpos[:, i:i + chunk_q]), softcap, scale)
            for i in range(0, Tq, chunk_q)]
    return torch.cat(outs, dim=1).reshape(B, Tq, H, dh)


def attention_train(params, x, cfg: ModelConfig, *, positions=None,
                    causal=True, window=None):
    """Full-sequence self-attention (prefill compute). x:(B,T,D).  Returns
    (y, (k, v)) with the unrepeated K/V heads for the prefill cache.

    Kernel dispatch: the flash kernel covers the contiguous causal layout
    (positions=None, i.e. contiguous from 0); explicit positions and
    non-causal calls stay on the chunked ``ref`` path."""
    B, T, D = x.shape
    q = _proj(x, params.wq)
    k = _proj(x, params.wk)
    v = _proj(x, params.wv)
    contiguous = positions is None
    if positions is None:
        positions = torch.arange(T, device=x.device)
    pos = positions.expand(B, T) if positions.dim() == 1 else positions
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    use_kernel = (kernel_registry.backend_for(
        "attention", site="attention_train", device=x.device) != "ref"
        and contiguous and causal)
    if use_kernel:
        out = flash_attention(q, k.contiguous(), v.contiguous(), causal=True,
                              window=window, softcap=cfg.softcap_attn)
    else:
        out = multihead_attention(q, k, v, q_positions=positions,
                                  k_positions=positions, causal=causal,
                                  window=window, softcap=cfg.softcap_attn,
                                  chunk_q=cfg.attn_chunk_q)
    return _out_proj(out, params.wo), (k, v)


def attention_decode(params, x, cache_k, cache_v, lengths, cfg: ModelConfig,
                     *, window=None):
    """One-token decode against a KV cache.  x:(B,1,D); cache:(B,S,Hkv,dh);
    lengths:(B,) current context length.  Writes the new token's K/V into
    the cache in place and returns (y, cache_k, cache_v).  Sliding-window
    layers use a rolling buffer (S == window)."""
    B = x.shape[0]
    S = cache_k.shape[1]
    q = _proj(x, params.wq)
    k = _proj(x, params.wk)
    v = _proj(x, params.wv)
    pos = lengths[:, None]  # (B,1) absolute position of the new token
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)

    slot = (lengths % S) if window is not None else lengths
    bidx = torch.arange(B, device=x.device)
    cache_k[bidx, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, slot] = v[:, 0].to(cache_v.dtype)

    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    G = H // Hkv
    # Both cache layouts reduce to a pure valid-length mask: slots 0..len are
    # written (dense), or the whole rolling buffer once warm — slot order in
    # the ring carries no positional meaning, so no causal test is needed.
    if window is None:
        kv_len = lengths + 1
    else:
        kv_len = torch.clamp(lengths + 1, max=S)
    dt = x.dtype
    if kernel_registry.backend_for("attention", site="attention_decode",
                                   device=x.device) != "ref":
        out = flash_attention_decode(q, cache_k.to(dt), cache_v.to(dt),
                                     kv_len, softcap=cfg.softcap_attn)
    else:
        qg = q.reshape(B, 1, Hkv, G, dh)
        sidx = torch.arange(S, device=x.device)[None, :]
        mask = (sidx < kv_len[:, None])[:, None, None, None, :]
        out = _attend_block(qg, cache_k.to(dt), cache_v.to(dt), mask,
                            cfg.softcap_attn, 1.0 / math.sqrt(dh))
        out = out.reshape(B, 1, H, dh)
    return _out_proj(out, params.wo), cache_k, cache_v


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    """Leaves ``wi``/``wg`` (D,F), ``wd`` (F,D)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype, generator=None):
        super().__init__()
        D, Fh = cfg.d_model, cfg.d_ff
        shapes = {"wi": ((D, Fh), D), "wg": ((D, Fh), D), "wd": ((Fh, D), Fh)}
        for name, (shape, fan_in) in shapes.items():
            p = (_empty(shape, device=device, dtype=dtype) if generator is None
                 else _dense_init(shape, fan_in, generator=generator,
                                  device=device, dtype=dtype))
            setattr(self, name, p)


def mlp(params, x):
    dt = x.dtype
    h = x @ params.wi.to(dt)
    g = x @ params.wg.to(dt)
    return (F.silu(g) * h) @ params.wd.to(dt)
