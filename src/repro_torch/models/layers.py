"""Neural-net layers of the ported families, in PyTorch.

Port of ``repro/models/layers.py``: rmsnorm, RoPE, GQA attention with
sliding window + softcap, KV-cache decode attention and the SwiGLU MLP (the
dense family's serving and training paths), the mixture of experts with
GShard's capacity-bounded dispatch (the moe family's), and the Mamba-2 SSD
mixer (the ssm family's).  Each layer is an ``nn.Module`` holding
parameters named after the JAX leaves; the math lives in plain functions
over (module, tensor) with the JAX signatures, so the backbones, the serving
engine and the trainer port line for line.

dtype discipline, as in JAX:
- activations run in the compute dtype (bf16 on the card); every weight is
  cast to it right before its product;
- attention scores accumulate in f32 (``preferred_element_type=F32``) and
  the softmax runs in f32; on the ``ref`` path the probabilities are cast to
  ``v.dtype`` before P·V (the kernel keeps them in its own precision);
- ``rmsnorm`` runs in f32 and casts back.

KV caches are updated IN PLACE (JAX returns new arrays): ``attention_decode``
writes the new token's K/V into the cache tensors it is given and returns
the same tensors.  Cross-attention (``attention_train`` with ``x_kv``, and
``cross_attention_decode`` against a frozen source KV) takes the plain path,
as in JAX.

On a 'model' axis of ranks (``models/sharding.py``'s execution half) a
module built inside ``sharding.slicing`` holds this rank's block of each
leaf the rules split (``tp_split``; ``tp_global`` keeps the global shapes)
and its function runs the rank's part: attention its query heads (with
their KV heads: its block where the KV heads divide, else the heads
``h // G`` of its query heads, ``kv_layout``), the MLP and the experts their
block of the hidden width, the SSD its heads (with every B / C channel of
the conv, and the gated norm's mean of squares summed over the axis).  A
replicated input enters through ``tp_copy`` and a row-parallel product
leaves through ``tp_reduce``; the kernels run on the local heads.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import sharding as shd
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
def _dense_init(shape, in_axis_size, *, generator, device, dtype,
                name: str = ""):
    """N(0, 1/in_axis_size) weights, the scale of the JAX ``_dense_init``.
    Inside ``sharding.slicing`` the whole leaf is drawn (the same stream)
    and this rank's block of leaf ``name`` kept."""
    scale = 1.0 / math.sqrt(max(in_axis_size, 1))
    w = torch.randn(shape, generator=generator, device=device, dtype=dtype)
    w.mul_(scale)
    slicer = shd.current_slicer()
    if slicer is not None:
        w = slicer.slice(name, w)
    return nn.Parameter(w, requires_grad=False)


def _empty(shape, *, device, dtype, name: str = ""):
    """An uninitialised leaf (this rank's block inside
    ``sharding.slicing``)."""
    slicer = shd.current_slicer()
    if slicer is not None:
        shape = slicer.local_shape(name, shape)
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


def _add_matrices(module, shapes, *, device, dtype, generator):
    """Register each ``name: (shape, fan_in)`` of ``shapes`` on ``module``:
    N(0, 1/fan_in) drawn from ``generator`` in dict order, or uninitialised
    when ``generator`` is None (weights loaded afterwards).  Inside
    ``sharding.slicing`` each leaf is this rank's block: ``module.tp_global``
    maps a split leaf to its global shape, and ``module.tp_split`` says
    whether any is split (the module then runs its rank's part)."""
    module.tp_global = getattr(module, "tp_global", {})
    for name, (shape, fan_in) in shapes.items():
        setattr(module, name,
                _empty(shape, device=device, dtype=dtype, name=name)
                if generator is None
                else _dense_init(shape, fan_in, generator=generator,
                                 device=device, dtype=dtype, name=name))
        if tuple(getattr(module, name).shape) != tuple(shape):
            module.tp_global[name] = tuple(shape)
    module.tp_split = bool(module.tp_global)


def _model_axis(params):
    """The model axis a module built as a rank's block runs on; None for
    a module of whole leaves."""
    if not getattr(params, "tp_split", False):
        return None
    m = shd.model_axis()
    if m is None:
        raise RuntimeError(
            f"{type(params).__name__} holds one model rank's block of its "
            "leaves but no model axis is installed (launch.mesh.install_2d)")
    return m


class RMSNorm(nn.Module):
    """Leaf ``scale`` (d,), kept in f32."""

    def __init__(self, d: int, *, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device, dtype=F32),
                                  requires_grad=False)


def rmsnorm(params, x, eps: float = 1e-6):
    return _rmsnorm_scale(params.scale, x, eps)


def _rmsnorm_scale(scale, x, eps: float = 1e-6):
    """``rmsnorm`` with a bare scale (JAX: ``rmsnorm({"scale": s}, x)``)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


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
        _add_matrices(self, shapes, device=device, dtype=dtype,
                      generator=generator)


def kv_layout(cfg: ModelConfig, tp: int = 1, index: int = 0):
    """(query heads, first KV head, KV heads) that model rank ``index`` of
    ``tp`` computes: every head on one rank or where the query heads do not
    divide (the rules replicate the attention); its block of each where
    the KV heads divide; else the KV heads ``h // G`` its query heads read,
    a local group of ``min(G, H / tp)``.  A layout where neither the group
    nor the rank's query heads divide the other raises."""
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    if tp <= 1 or H % tp:
        return H, 0, Hkv
    Hl = H // tp
    if Hkv % tp == 0:
        return Hl, index * (Hkv // tp), Hkv // tp
    G = H // Hkv
    if G % Hl and Hl % G:
        raise ValueError(f"{cfg.name}: {Hl} query heads a rank of {tp} and "
                         f"groups of {G} split a KV head's group unevenly")
    return Hl, index * Hl // G, max(Hl // G, 1)


def _kv_weights(params, cfg, m):
    """(wk, wv) of the KV heads this rank computes: its leaves where they
    are its block or whole on one rank, else the columns of the KV heads
    its query heads read."""
    if m is None:
        return params.wk, params.wv
    _, k0, nk = kv_layout(cfg, m.size, m.index)
    if params.wk.shape[1] == nk:
        return params.wk, params.wv
    return params.wk[:, k0:k0 + nk], params.wv[:, k0:k0 + nk]


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
                    causal=True, window=None, x_kv=None, kv_positions=None):
    """Full-sequence attention (training / prefill compute). x:(B,T,D).
    Returns (y, (k, v)) with the unrepeated K/V heads for the prefill cache.
    ``x_kv`` (B,S,D) is a cross-attention source: K / V come from it, no
    RoPE on q or k, no causal mask (its positions ``kv_positions``, default
    0..S-1, reach only a window).

    Kernel dispatch, JAX's rule: the flash kernel covers causal
    self-attention over contiguous positions (positions=None, i.e.
    contiguous from 0); explicit positions, non-causal and cross-attention
    calls stay on the chunked ``ref`` path.  Both routes are
    differentiable: the kernel route through ``flash_attention``'s
    ``autograd.Function`` (the kernel needs contiguous K / V; its backward
    is reference math, as JAX's ``custom_vjp``), the ``ref`` route through
    plain autograd."""
    B, T, D = x.shape
    m = _model_axis(params)
    if m is not None:
        x = shd.tp_copy(x)
        x_kv = None if x_kv is None else shd.tp_copy(x_kv)
    src = x if x_kv is None else x_kv
    wk, wv = _kv_weights(params, cfg, m)
    q = _proj(x, params.wq)
    k = _proj(src, wk)
    v = _proj(src, wv)
    contiguous = positions is None
    if positions is None:
        positions = torch.arange(T, device=x.device)
    cross = x_kv is not None
    if cross:
        kv_pos = kv_positions if kv_positions is not None else \
            torch.arange(src.shape[1], device=x.device)
    else:
        kv_pos = positions
        pos = positions.expand(B, T) if positions.dim() == 1 else positions
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    use_kernel = (kernel_registry.backend_for(
        "attention", site="attention_train", device=x.device) != "ref"
        and contiguous and causal and not cross)
    if use_kernel:
        out = flash_attention(q, k.contiguous(), v.contiguous(), causal=True,
                              window=window, softcap=cfg.softcap_attn)
    else:
        out = multihead_attention(q, k, v, q_positions=positions,
                                  k_positions=kv_pos,
                                  causal=causal and not cross, window=window,
                                  softcap=cfg.softcap_attn,
                                  chunk_q=cfg.attn_chunk_q)
    y = _out_proj(out, params.wo)
    return (y if m is None else shd.tp_reduce(y)), (k, v)


def attention_decode(params, x, cache_k, cache_v, lengths, cfg: ModelConfig,
                     *, window=None):
    """One-token decode against a KV cache.  x:(B,1,D); cache:(B,S,Hkv,dh);
    lengths:(B,) current context length.  Writes the new token's K/V into
    the cache in place and returns (y, cache_k, cache_v).  Sliding-window
    layers use a rolling buffer (S == window)."""
    B = x.shape[0]
    S = cache_k.shape[1]
    m = _model_axis(params)
    if m is not None:
        x = shd.tp_copy(x)
    wk, wv = _kv_weights(params, cfg, m)
    q = _proj(x, params.wq)
    k = _proj(x, wk)
    v = _proj(x, wv)
    pos = lengths[:, None]  # (B,1) absolute position of the new token
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)

    slot = (lengths % S) if window is not None else lengths
    bidx = torch.arange(B, device=x.device)
    cache_k[bidx, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, slot] = v[:, 0].to(cache_v.dtype)

    H, Hkv, dh = q.shape[2], cache_k.shape[2], cfg.d_head
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
    y = _out_proj(out, params.wo)
    return (y if m is None else shd.tp_reduce(y)), cache_k, cache_v


def cross_attention_decode(params, x, cross_k, cross_v, cfg: ModelConfig):
    """Decode-time cross-attention against a precomputed (frozen) source KV
    (B,S,Hkv,dh): every slot valid, no RoPE, no softcap; the plain path, as
    in JAX.  x:(B,1,D) -> (B,1,D)."""
    B = x.shape[0]
    dt = x.dtype
    m = _model_axis(params)
    if m is not None:
        x = shd.tp_copy(x)
    H, Hkv, dh = params.wq.shape[1], cross_k.shape[2], cfg.d_head
    qg = _proj(x, params.wq).reshape(B, 1, Hkv, H // Hkv, dh)
    S = cross_k.shape[1]
    mask = torch.ones((B, 1, 1, 1, S), dtype=torch.bool, device=x.device)
    out = _attend_block(qg, cross_k.to(dt), cross_v.to(dt), mask, None,
                        1.0 / math.sqrt(dh))
    y = _out_proj(out.reshape(B, 1, H, dh), params.wo)
    return y if m is None else shd.tp_reduce(y)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    """Leaves ``wi``/``wg`` (D,F), ``wd`` (F,D); F is ``d_ff`` (default
    ``cfg.d_ff``), as JAX's ``init_mlp``."""

    def __init__(self, cfg: ModelConfig, *, device, dtype, generator=None,
                 d_ff=None):
        super().__init__()
        D, Fh = cfg.d_model, d_ff or cfg.d_ff
        shapes = {"wi": ((D, Fh), D), "wg": ((D, Fh), D), "wd": ((Fh, D), Fh)}
        _add_matrices(self, shapes, device=device, dtype=dtype,
                      generator=generator)


def mlp(params, x, reduce: bool = True):
    """SwiGLU; on a model axis this rank's block of the hidden width, its
    partial output summed over the axis (``reduce=False``: left partial,
    for a caller that sums it with another partial first)."""
    m = _model_axis(params)
    if m is not None:
        x = shd.tp_copy(x)
    dt = x.dtype
    h = x @ params.wi.to(dt)
    g = x @ params.wg.to(dt)
    y = (F.silu(g) * h) @ params.wd.to(dt)
    return y if m is None or not reduce else shd.tp_reduce(y)


# ---------------------------------------------------------------------------
# MoE: router + capacity-based grouped dispatch (GShard-style, scatter form)
# ---------------------------------------------------------------------------
class MoE(nn.Module):
    """Leaves ``router`` (D,E), ``experts_wi``/``experts_wg`` (E,D,Fe),
    ``experts_wd`` (E,Fe,D), and ``shared`` (an ``MLP`` of width
    ``n_shared_experts * d_ff_expert``) when the config has shared
    experts, as JAX's ``init_moe``.  On a model axis the router, top-k and
    dispatch run whole on every rank (``TP_REPLICATED_USE``), the experts
    on the rank's block of their hidden width."""

    TP_REPLICATED_USE = ("router",)

    def __init__(self, cfg: ModelConfig, *, device, dtype, generator=None):
        super().__init__()
        D, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
        shapes = {"router": ((D, E), D), "experts_wi": ((E, D, Fe), D),
                  "experts_wg": ((E, D, Fe), D),
                  "experts_wd": ((E, Fe, D), Fe)}
        _add_matrices(self, shapes, device=device, dtype=dtype,
                      generator=generator)
        if cfg.n_shared_experts:
            self.shared = MLP(cfg, device=device, dtype=dtype,
                              generator=generator,
                              d_ff=cfg.n_shared_experts * Fe)


_ROUTING: list = []  # the active record_routing lists, innermost last


@contextmanager
def record_routing():
    """Collect the routing of every ``moe`` call made inside the block: a
    list with one ``(experts, kept)`` pair a call, in call order, each
    (B, T, K) (int64 expert ids, bool kept under the capacity).  A probe
    for the checks that compare two routes on the same inputs; the model
    never reads it."""
    calls: list = []
    _ROUTING.append(calls)
    try:
        yield calls
    finally:
        _ROUTING.pop()


def top_k(x, k: int):
    """The ``k`` largest entries along the last dim and their indices, in
    descending order, ties to the lower index (``jax.lax.top_k``'s rule;
    ``torch.topk`` promises no order among ties, a stable sort does)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe(params, x, cfg: ModelConfig, groups: int = 1, no_drop: bool = False,
        capacity_factor: Optional[float] = None):
    """x:(B,T,D) -> (y, aux), JAX's ``moe`` op for op.  Tokens flatten to
    (G, S_g, D) dispatch groups; each routed expert takes at most
    C = min(max(ceil(S_g K / E cf), 1), S_g K) tokens of a group (S_g K under
    ``no_drop``, the exact decode), in GShard's order: positions within an
    expert by a cumsum over (choice, token) in k-major order, overflow
    dropped.  Router logits in the compute dtype, then softmax and top-k in
    f32, the top-k weights renormalised (floor 1e-9); scatter into (G,E,C,D),
    the grouped SwiGLU, the gather weighted by weight x keep, plus the shared
    experts; ``aux`` is GShard's load-balance loss E * sum_e(frac_e *
    mean_gate_e)."""
    B, T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    S_total = B * T
    G = groups if S_total % groups == 0 else 1
    S_g = S_total // G
    cf = capacity_factor if capacity_factor is not None else \
        cfg.capacity_factor
    C = max(int(math.ceil(S_g * K / E * cf)), 1)
    C = min(C, S_g * K)
    if no_drop:
        C = S_g * K

    dt = x.dtype
    xf = x.reshape(G, S_g, D)
    logits = (xf @ params.router.to(dt)).float()
    gates = torch.softmax(logits, dim=-1)  # (G,S,E)
    top_w, top_e = top_k(gates, K)  # (G,S,K)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    # position of each (choice, token) within its expert: cumsum of one-hots
    # in (k-major, token-minor) assignment order -- GShard's
    # (G,S,K,E) int64, F.one_hot's values; by comparison, since one_hot
    # reads the ids' range on the host for a CPU tensor
    onehot = (top_e[..., None] == torch.arange(E, device=x.device)).long()
    ordered = onehot.transpose(1, 2).reshape(G, K * S_g, E)
    # the scan runs along the innermost dim (CUDA's outer-dim integer scan
    # took 7.8 ms a layer at 32 768 x 60); integer sums are exact either way
    pos_in_e = torch.cumsum(ordered.transpose(1, 2).contiguous(),
                            dim=-1).transpose(1, 2) - 1
    pos_flat = (pos_in_e * ordered).sum(-1).reshape(G, K, S_g)
    keep = pos_flat < C
    eidx = top_e.transpose(1, 2)  # (G,K,S)
    wgt = top_w.transpose(1, 2)
    pos_clip = torch.clamp(pos_flat, max=C - 1)
    gidx = torch.arange(G, device=x.device)[:, None, None].expand_as(eidx)
    if _ROUTING:
        _ROUTING[-1].append((top_e.reshape(B, T, K),
                             keep.transpose(1, 2).reshape(B, T, K)))

    # scatter: a kept (choice, token) owns its slot; a dropped one adds its
    # zeros to slot C-1 of its expert, so the sums are exact in any order
    contrib = xf[:, None] * keep[..., None].to(dt)  # (G,K,S,D)
    expert_in = torch.zeros((G, E, C, D), dtype=dt, device=x.device)
    expert_in.index_put_((gidx, eidx, pos_clip), contrib, accumulate=True)
    # on a model axis: the replicated dispatch and combine weights enter
    # the rank's block of the experts (f), whose partial outputs are
    # summed once, with the shared experts' (g)
    split = _model_axis(params) is not None
    combine = wgt * keep
    if split:
        expert_in = shd.tp_copy(expert_in)
        combine = shd.tp_copy(combine)

    h = torch.einsum("gecd,edf->gecf", expert_in, params.experts_wi.to(dt))
    g = torch.einsum("gecd,edf->gecf", expert_in, params.experts_wg.to(dt))
    h = F.silu(g) * h
    expert_out = torch.einsum("gecf,efd->gecd", h, params.experts_wd.to(dt))

    # gather back: y[s] = sum_k w * expert_out[e_k, p_k]
    o = expert_out[gidx, eidx, pos_clip]  # (G,K,S,D)
    y = torch.sum(o * combine[..., None].to(o.dtype), dim=1)
    y = y.reshape(B, T, D)

    if cfg.n_shared_experts:
        # the shared width is a multiple of the experts': split with them
        y = y + mlp(params.shared, x, reduce=not split)
    if split:
        y = shd.tp_reduce(y)

    # GShard aux load-balance loss: E * mean_e(frac_tokens_e * mean_gate_e)
    frac = torch.mean(onehot.float().sum(2), dim=(0, 1)) / K  # (E,)
    mgate = torch.mean(gates, dim=(0, 1))
    aux = E * torch.sum(frac * mgate)
    return y, aux


# ---------------------------------------------------------------------------
# Mamba2 / SSD block
# ---------------------------------------------------------------------------
class SSD(nn.Module):
    """Leaves ``wz``/``wx`` (D,H,P), ``wB``/``wC`` (D,G,N), ``wdt`` (D,H),
    ``A_log``/``dt_bias`` (H,), ``conv_w`` (K, H*P + 2*G*N), ``norm_scale``
    (H*P,), ``out_proj`` (H,P,D).  Matrices (and ``conv_w``) in ``dtype``;
    ``A_log``, ``dt_bias`` and ``norm_scale`` in f32, as JAX keeps them."""

    def __init__(self, cfg: ModelConfig, *, device, dtype, generator=None):
        super().__init__()
        D = cfg.d_model
        H, Pd, G, N = (cfg.ssm_n_heads, cfg.ssm_headdim, cfg.ssm_n_groups,
                       cfg.d_state)
        Kc = cfg.conv_kernel
        conv_dim = H * Pd + 2 * G * N
        shapes = {"wz": ((D, H, Pd), D), "wx": ((D, H, Pd), D),
                  "wB": ((D, G, N), D), "wC": ((D, G, N), D),
                  "wdt": ((D, H), D), "conv_w": ((Kc, conv_dim), Kc),
                  "out_proj": ((H, Pd, D), H * Pd)}
        _add_matrices(self, shapes, device=device, dtype=dtype,
                      generator=generator)

        def f32(t):
            return nn.Parameter(t, requires_grad=False)

        self.A_log = f32(torch.log(torch.linspace(1.0, 16.0, H, dtype=F32,
                                                  device=device)))
        self.dt_bias = f32(torch.zeros(H, dtype=F32, device=device))
        self.norm_scale = f32(torch.ones(H * Pd, dtype=F32, device=device))


def _causal_conv1d(x, w, state=None):
    """Depthwise causal conv. x:(B,T,C), w:(K,C); state:(B,K-1,C) or None.
    Returns y:(B,T,C), new_state:(B,K-1,C)."""
    K = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    T = x.shape[1]
    wd = w.to(x.dtype)
    y = xp[:, 0:T] * wd[0]
    for i in range(1, K):
        y = y + xp[:, i:i + T] * wd[i]
    new_state = xp[:, -(K - 1):] if K > 1 else state
    return F.silu(y), new_state


def _ssd_proj(params, u, cfg: ModelConfig):
    z = _proj(u, params.wz)
    x = _proj(u, params.wx)
    Bs = _proj(u, params.wB)
    Cs = _proj(u, params.wC)
    dt = _proj(u, params.wdt)
    return z, x, Bs, Cs, dt


class _SSDPart:
    """The part of an SSD mixer one rank runs: its heads ``[h0, h0 + H)``
    of ``H_all`` (all of them with no model axis), the B / C groups they
    read ``[g0, g0 + G)``, and the replicated leaves cut to them (the
    conv's x channels of its heads and every B / C channel, ``A_log`` /
    ``dt_bias`` / ``norm_scale`` of its heads)."""

    def __init__(self, params, cfg: ModelConfig):
        self.m = _model_axis(params)
        H_all, Pd = cfg.ssm_n_heads, cfg.ssm_headdim
        G_all, N = cfg.ssm_n_groups, cfg.d_state
        self.H, self.H_all, self.Pd = params.wz.shape[1], H_all, Pd
        self.h0 = 0 if self.m is None else self.m.index * self.H
        per_g = H_all // G_all
        if self.m is not None and self.H % per_g and per_g % self.H:
            raise ValueError(f"{cfg.name}: {self.H} SSD heads a rank split "
                             f"groups of {per_g} heads unevenly")
        self.g0 = self.h0 // per_g
        self.G = max(self.H // per_g, 1)
        conv_w = params.conv_w
        self.A_log, self.dt_bias = params.A_log, params.dt_bias
        self.norm_scale = params.norm_scale
        if self.m is not None:
            xs = slice(self.h0 * Pd, (self.h0 + self.H) * Pd)
            conv_w = torch.cat([conv_w[:, xs], conv_w[:, H_all * Pd:]], 1)
            hs = slice(self.h0, self.h0 + self.H)
            self.A_log, self.dt_bias = self.A_log[hs], self.dt_bias[hs]
            self.norm_scale = self.norm_scale[xs]
        self.conv_w = conv_w
        self.GN = G_all * N

    def groups(self, t):
        """This rank's groups of B or C (..., G_all, N)."""
        if self.m is None:
            return t
        return t[..., self.g0:self.g0 + self.G, :]

    def norm(self, y):
        """The gated RMSNorm over every head's channels: the mean of
        squares summed over the model axis (forward and backward)."""
        if self.m is None:
            return _rmsnorm_scale(self.norm_scale, y)
        yf = y.float()
        ss = shd.tp_allsum(torch.sum(yf * yf, dim=-1, keepdim=True))
        var = ss / (self.H_all * self.Pd)
        return (yf * torch.rsqrt(var + 1e-6) * self.norm_scale).to(y.dtype)

    def out(self, y):
        return y if self.m is None else shd.tp_reduce(y)


def ssd_chunked(x, dt, A, Bs, Cs, chunk: int, state=None,
                intra_bf16: bool = False):
    """SSD (Mamba-2 state-space dual) forward, a loop over chunks.

    x:(B,T,H,P) dt:(B,T,H) A:(H,) negative  Bs,Cs:(B,T,G,N).
    Returns y:(B,T,H,P) in x.dtype, final_state:(B,H,P,N) f32.  Ragged T is
    padded with dt = 0 rows, which add nothing to the state.  This is the
    plain version of the SSD kernel (``kernels/ssd_scan``) and the math its
    backward differentiates.
    """
    B_, T, H, Pd = x.shape
    G, N = Bs.shape[2], Bs.shape[3]
    rep = H // G
    Q = min(chunk, T)
    T_orig = T
    if T % Q:  # pad the tail with dt=0 tokens (no state contribution)
        pad = Q - T % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bs = F.pad(Bs, (0, 0, 0, 0, 0, pad))
        Cs = F.pad(Cs, (0, 0, 0, 0, 0, pad))
        T = T + pad
    nC = T // Q
    if state is None:
        state = torch.zeros((B_, H, Pd, N), dtype=F32, device=x.device)
    # intra-chunk compute dtype: bf16 halves the (B,Q,Q,H) traffic of the
    # scores / L / M chain; the inter-chunk state recurrence stays f32
    idt = torch.bfloat16 if intra_bf16 else F32
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    tri = tri[None, :, :, None]
    zero = torch.zeros((), dtype=idt, device=x.device)
    ys = []
    for c in range(nC):
        sl = slice(c * Q, (c + 1) * Q)
        xq, dtq, Bq, Cq = x[:, sl], dt[:, sl], Bs[:, sl], Cs[:, sl]
        dA = dtq.float() * A  # (B,Q,H) negative
        cum = torch.cumsum(dA, dim=1)  # (B,Q,H)
        # L[q,k] = exp(cum_q - cum_k) for q >= k.  Zero the masked (q<k)
        # entries BEFORE exp: they are positive and can overflow, and
        # where-after-exp leaks 0*inf = NaN into the backward.
        cum_i = cum.to(idt)
        Ldiff = torch.where(tri, cum_i[:, :, None, :] - cum_i[:, None, :, :],
                            zero)
        L = torch.where(tri, torch.exp(Ldiff), zero)
        # C.B^T once per group, repeated over the group's heads (the same
        # products as JAX's repeat-then-einsum)
        scores = torch.einsum("bqgn,bkgn->bqkg", Cq.to(idt), Bq.to(idt))
        scores = scores.repeat_interleave(rep, dim=3)  # (B,Q,K,H)
        M = scores * L * dtq.to(idt)[:, None, :, :]
        y_diag = torch.einsum("bqkh,bkhp->bqhp", M.float(), xq.to(idt).float())
        # inter-chunk: contribution of the incoming state
        Ch = Cq.float().repeat_interleave(rep, dim=2)  # (B,Q,H,N)
        Bh = Bq.float().repeat_interleave(rep, dim=2)
        decay_out = torch.exp(cum)  # (B,Q,H)
        y_off = torch.einsum("bqhn,bhpn->bqhp", Ch, state) * decay_out[..., None]
        # state update
        decay_last = torch.exp(cum[:, -1:, :] - cum)  # (B,Q,H)
        w = (decay_last * dtq.float())[..., None]  # (B,Q,H,1)
        state = state * torch.exp(cum[:, -1, :])[..., None, None] + \
            torch.einsum("bqhn,bqhp->bhpn", Bh * w, xq.float())
        ys.append((y_diag + y_off).to(x.dtype))
    y = torch.cat(ys, dim=1)
    return y[:, :T_orig], state


def ssd_block_train(params, u, cfg: ModelConfig, conv_state=None,
                    ssm_state=None):
    """Full mamba2 mixer over a sequence. u:(B,T,D) -> y:(B,T,D),
    (conv_st, ssm_st)."""
    B_, T, D = u.shape
    part = _SSDPart(params, cfg)
    if part.m is not None:
        u = shd.tp_copy(u)
    H, Pd, G, N = part.H, cfg.ssm_headdim, cfg.ssm_n_groups, cfg.d_state
    z, x, Bs, Cs, dt = _ssd_proj(params, u, cfg)
    # conv over [x, B, C]
    xBC = torch.cat([x.reshape(B_, T, H * Pd), Bs.reshape(B_, T, G * N),
                     Cs.reshape(B_, T, G * N)], dim=-1)
    xBC, conv_state = _causal_conv1d(xBC, part.conv_w, conv_state)
    x = xBC[..., : H * Pd].reshape(B_, T, H, Pd)
    Bs = part.groups(xBC[..., H * Pd: H * Pd + G * N].reshape(B_, T, G, N))
    Cs = part.groups(xBC[..., H * Pd + G * N:].reshape(B_, T, G, N))
    dt = F.softplus(dt.float() + part.dt_bias)
    A = -torch.exp(part.A_log)
    # Kernel dispatch: the SSD kernel covers the zero-initial-state train
    # shape in f32.  Chunked-prefill continuation (ssm_state) and the
    # bf16-intra knob (a ref-path traffic optimization the kernel subsumes)
    # stay on the plain chunked scan.  (The JAX ``cfg.unroll`` dry-run
    # variants have no counterpart here: the port always loops.)
    if (kernel_registry.backend_for("ssd", site="ssd_block_train",
                                    device=u.device) != "ref"
            and ssm_state is None and not cfg.unroll and not cfg.ssd_bf16):
        # lazy: kernels.ssd_scan.ref imports this module
        from ..kernels.ssd_scan.ops import ssd_scan

        y, ssm_state = ssd_scan(x.contiguous(), dt.contiguous(), A,
                                Bs.contiguous(), Cs.contiguous(),
                                chunk=min(cfg.ssd_chunk, T))
    else:
        y, ssm_state = ssd_chunked(x, dt, A, Bs, Cs, cfg.ssd_chunk, ssm_state,
                                   intra_bf16=cfg.ssd_bf16)
    y = y.reshape(B_, T, H * Pd) * F.silu(z.reshape(B_, T, H * Pd))
    y = part.norm(y)
    return part.out(_out_proj(y.reshape(B_, T, H, Pd), params.out_proj)), \
        (conv_state, ssm_state)


def ssd_block_decode(params, u, conv_state, ssm_state, cfg: ModelConfig):
    """Single-token mamba2 step. u:(B,1,D); ssm_state:(B,H,P,N) f32.
    Returns (y (B,1,D), (conv_state, ssm_state)) -- new tensors; the
    caller writes them back into its cache."""
    B_ = u.shape[0]
    part = _SSDPart(params, cfg)
    if part.m is not None:
        u = shd.tp_copy(u)
    H, Pd, G, N = part.H, cfg.ssm_headdim, cfg.ssm_n_groups, cfg.d_state
    z, x, Bs, Cs, dt = _ssd_proj(params, u, cfg)
    xBC = torch.cat([x.reshape(B_, 1, H * Pd), Bs.reshape(B_, 1, G * N),
                     Cs.reshape(B_, 1, G * N)], dim=-1)
    xBC, conv_state = _causal_conv1d(xBC, part.conv_w, conv_state)
    x = xBC[..., : H * Pd].reshape(B_, H, Pd)
    Bs = part.groups(xBC[..., H * Pd: H * Pd + G * N].reshape(B_, G, N))
    Cs = part.groups(xBC[..., H * Pd + G * N:].reshape(B_, G, N))
    dt = F.softplus(dt.float() + part.dt_bias)[:, 0]  # (B,H)
    A = -torch.exp(part.A_log)
    rep = H // Bs.shape[1]
    Bh = Bs.repeat_interleave(rep, dim=1).float()  # (B,H,N)
    Ch = Cs.repeat_interleave(rep, dim=1).float()
    dA = torch.exp(dt * A)  # (B,H)
    ssm_state = ssm_state * dA[..., None, None] + torch.einsum(
        "bhn,bhp->bhpn", Bh * dt[..., None], x.float())
    y = torch.einsum("bhn,bhpn->bhp", Ch, ssm_state)  # (B,H,P)
    y = y.reshape(B_, 1, H * Pd).to(u.dtype) * F.silu(z.reshape(B_, 1, H * Pd))
    y = part.norm(y)
    out = part.out(_out_proj(y.reshape(B_, 1, H, Pd), params.out_proj))
    return out, (conv_state, ssm_state)

