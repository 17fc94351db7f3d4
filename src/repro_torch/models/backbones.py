"""Backbones of every family, in PyTorch.

Port of ``repro/models/backbones.py``: dense (gemma2's local/global layer
pairs with ``alt_local_global``, plain dense without), moe (attention + a
mixture of experts a layer: qwen2-moe, mixtral), ssm (mamba2), hybrid
(zamba2: superblocks of ``attn_every`` Mamba-2 layers, each followed by ONE
shared attention block held once, then the tail layers), vlm
(llama-3.2-vision: superblocks of ``cross_every - 1`` self layers and one
layer that cross-attends to image tokens) and encdec (whisper: a
bidirectional encoder over frame embeddings, decoder blocks of self-,
cross-attention and MLP), each on both paths: the training forward and the
serving prefill / decode step.

- ``LM`` is an ``nn.Module`` with the JAX leaves as parameters.  The JAX
  params stack each superblock's leaves with a leading dim; here layer
  ``2i`` / ``2i+1`` of ``LM.layers`` holds superblock ``i``'s ``local`` /
  ``global`` layer (layer ``i`` for plain dense), and each ``lax.scan`` over
  superblocks is a Python loop.
  A moe ``LM`` holds one ``MoELayer`` (leaves ``attn_norm``, ``attn``,
  ``moe_norm``, ``moe``) per layer, an ssm ``LM`` one ``SSMLayer`` (leaves
  ``norm``, ``ssd``).  A hybrid ``LM`` holds the superblocks' Mamba-2 layers
  in ``layers`` (superblock ``i``'s at ``i * attn_every ..``), the tail's in
  ``tail_blocks`` and the shared block in ``shared_attn`` (a
  ``DenseLayer``); a vlm ``LM`` holds every layer in superblock order in
  ``layers`` (the last of each superblock is its cross layer); an encdec
  ``LM`` holds its decoder blocks (``EncDecLayer``) in ``layers`` and the
  encoder's ``DenseLayer``s and final norm in ``encoder``.
- ``init_cache``, ``embed``, ``lm_logits``, ``value_out``, ``prefill``,
  ``decode_step``, ``encoder_forward`` and ``forward_train`` are plain
  functions with the JAX signatures (plus an explicit ``device`` where they
  allocate).  Cache leaves keep the JAX layout -- K/V ``(n, B, S, Hkv,
  dh)``, SSM conv ``(n, B, K-1, conv_dim)`` and state ``(n, B, H, P, N)``
  f32, cross K/V ``(n_sb, B, S_src, Hkv, dh)``, ``lengths`` ``(B,)`` int32
  -- and are updated IN PLACE: ``prefill`` and ``decode_step`` write into
  the tensors of the cache they are given and return a new dict holding
  those same tensors plus a new ``lengths`` (a prefill whose source is
  longer or shorter than the cache's cross K/V returns new ones, as JAX
  replaces the leaf).
- ``forward_train``: with ``cfg.remat`` each superblock (and each tail or
  encoder layer) is checkpointed with ``torch.utils.checkpoint``
  (non-reentrant), the counterpart of ``jax.checkpoint`` over the scanned
  superblocks.
- The sharding constraints sit at JAX's call sites: ``constrain_res`` on
  the residual stream of the training forward and the prefill,
  ``constrain_cache_kv`` on the K/V caches a decode step writes.  They
  check the installed mesh's rules and move nothing
  (``sharding.constrain``).  The moe dispatch splits into
  ``shd.n_batch_shards()`` groups, as JAX's (1 inside a rank of
  ``install_2d``'s mesh and with no mesh).  ``cache_pspecs`` keeps JAX's
  cache sharding rules (the dry run's per-device bytes read them).
- On a 'model' axis of ranks (``install_2d`` of a ``Mesh2D`` whose model
  extent is above 1) ``init_lm`` draws every leaf whole from the
  generator, as on one device, and keeps this rank's block of it, leaf by
  leaf (``sharding.slicing``): the sharded model is the unsharded one
  exactly.  ``embed`` is a vocab-parallel lookup (this rank's rows, the
  others masked, summed over the axis) and ``lm_logits`` a vocab-parallel
  product whose logits are gathered over the axis: every rank holds the
  full (B, T, V) logits, as the sampler and the loss read them.  The
  residual stream and the norms stay replicated; ``init_cache`` holds the
  rank's KV heads (``layers.kv_layout``) and SSD heads.
"""
from __future__ import annotations

import math
import struct
from typing import Any, Dict

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import sharding as shd
from .config import ModelConfig
from .layers import (
    F32,
    MLP,
    SSD,
    Attention,
    MoE,
    RMSNorm,
    _dense_init,
    _empty,
    _model_axis,
    attention_decode,
    attention_train,
    cdtype,
    cross_attention_decode,
    kv_layout,
    mlp,
    moe,
    rmsnorm,
    ssd_block_decode,
    ssd_block_train,
)

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")


def _res_spec(seq_shard: bool = True):
    """Residual stream (B, T, D): batch over the dp axes; seq over the tp
    axis (sequence-parallel activations)."""
    return shd.P(shd.dp_axes(), shd.tp_axis() if seq_shard else None, None)


def constrain_res(x, cfg: ModelConfig):
    T = x.shape[1]
    tp = shd.tp_size()
    if tp > 1 and T % tp == 0 and T >= tp:
        return shd.constrain(x, _res_spec(True))
    return shd.constrain(x, _res_spec(False))


def superblock_layout(cfg: ModelConfig):
    """Returns (n_superblocks, layers_per_block, tail_layers)."""
    f = cfg.family
    if f not in PORTED_FAMILIES:
        raise ValueError(f"unknown family {f!r} (known: {PORTED_FAMILIES})")
    if f == "dense" and cfg.alt_local_global:
        if cfg.n_layers % 2:
            raise ValueError("alt_local_global needs an even n_layers")
        return cfg.n_layers // 2, 2, 0
    if f == "hybrid":
        return (cfg.n_layers // cfg.attn_every, cfg.attn_every,
                cfg.n_layers % cfg.attn_every)
    if f == "vlm":
        if cfg.n_layers % cfg.cross_every:
            raise ValueError(f"vlm needs n_layers {cfg.n_layers} to be a "
                             f"multiple of cross_every {cfg.cross_every}")
        return cfg.n_layers // cfg.cross_every, cfg.cross_every, 0
    return cfg.n_layers, 1, 0  # encdec: decoder blocks; the encoder apart


class DenseLayer(nn.Module):
    """One pre-norm attention + SwiGLU layer (post-norms when cfg.post_norm)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.attn_norm = RMSNorm(cfg.d_model, device=device)
        self.attn = Attention(cfg, **kw)
        self.mlp_norm = RMSNorm(cfg.d_model, device=device)
        self.mlp = MLP(cfg, **kw)
        if cfg.post_norm:
            self.attn_post_norm = RMSNorm(cfg.d_model, device=device)
            self.mlp_post_norm = RMSNorm(cfg.d_model, device=device)


class MoELayer(nn.Module):
    """One pre-norm attention + mixture-of-experts layer (JAX's
    ``_init_moe_layer``)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.attn_norm = RMSNorm(cfg.d_model, device=device)
        self.attn = Attention(cfg, **kw)
        self.moe_norm = RMSNorm(cfg.d_model, device=device)
        self.moe = MoE(cfg, **kw)


class SSMLayer(nn.Module):
    """One pre-norm mamba2 layer: leaves ``norm`` and ``ssd``."""

    def __init__(self, cfg: ModelConfig, *, device, dtype, generator=None):
        super().__init__()
        self.norm = RMSNorm(cfg.d_model, device=device)
        self.ssd = SSD(cfg, device=device, dtype=dtype, generator=generator)


class EncDecLayer(nn.Module):
    """One encoder-decoder decoder block (JAX's encdec superblock): leaves
    ``self_norm``, ``self_attn``, ``cross_norm``, ``cross_attn``,
    ``mlp_norm``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, *, device, dtype, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.self_norm = RMSNorm(cfg.d_model, device=device)
        self.self_attn = Attention(cfg, **kw)
        self.cross_norm = RMSNorm(cfg.d_model, device=device)
        self.cross_attn = Attention(cfg, **kw)
        self.mlp_norm = RMSNorm(cfg.d_model, device=device)
        self.mlp = MLP(cfg, **kw)


class Encoder(nn.Module):
    """The encdec family's bidirectional encoder: ``blocks`` (one
    ``DenseLayer`` each of ``n_enc_layers``) and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, *, device, dtype, generator=None):
        super().__init__()
        self.blocks = nn.ModuleList(
            DenseLayer(cfg, device=device, dtype=dtype, generator=generator)
            for _ in range(cfg.n_enc_layers))
        self.final_norm = RMSNorm(cfg.d_model, device=device)


class LM(nn.Module):
    """Leaves ``tok_embed`` (Vp,D), ``layers``, ``final_norm``, ``lm_head``
    (D,Vp), ``value_head`` (D,1); hybrid adds ``tail_blocks`` and
    ``shared_attn``, encdec ``encoder``.  Matrices are stored in ``dtype``,
    norm scales in f32.  On a model axis (``sharding.slicing``)
    ``tok_embed`` / ``lm_head`` hold this rank's vocab rows / columns
    (``tp_split``); the value head reads the replicated hidden state."""

    TP_REPLICATED_USE = ("value_head",)

    def __init__(self, cfg: ModelConfig, *, device, dtype, generator=None):
        super().__init__()
        n_sb, per_block, tail = superblock_layout(cfg)
        Vp, D = cfg.padded_vocab, cfg.d_model
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.tp_global = {}

        def mat(name, shape, fan_in):
            if generator is None:
                w = _empty(shape, device=device, dtype=dtype, name=name)
            else:
                w = _dense_init(shape, fan_in, generator=generator,
                                device=device, dtype=dtype, name=name)
            if tuple(w.shape) != tuple(shape):
                self.tp_global[name] = tuple(shape)
            return w

        self.tok_embed = mat("tok_embed", (Vp, D), D)
        layer = {"ssm": SSMLayer, "hybrid": SSMLayer, "moe": MoELayer,
                 "encdec": EncDecLayer}.get(cfg.family, DenseLayer)
        self.layers = nn.ModuleList(layer(cfg, **kw)
                                    for _ in range(n_sb * per_block))
        if cfg.family == "hybrid":
            self.tail_blocks = nn.ModuleList(SSMLayer(cfg, **kw)
                                             for _ in range(tail))
            self.shared_attn = DenseLayer(cfg, **kw)
        if cfg.family == "encdec":
            self.encoder = Encoder(cfg, **kw)
        self.final_norm = RMSNorm(D, device=device)
        self.lm_head = mat("lm_head", (D, Vp), D)
        self.value_head = mat("value_head", (D, 1), D)
        self.tp_split = bool(self.tp_global)


def layer_windows(cfg: ModelConfig):
    """Attention window of each layer: gemma2 alternates local (window) and
    global (None) layers; plain dense layers all use cfg.window."""
    if cfg.alt_local_global:
        return [cfg.window if i % 2 == 0 else None for i in range(cfg.n_layers)]
    return [cfg.window] * cfg.n_layers


def _cache_slot(cfg: ModelConfig, i: int):
    """(k name, v name, superblock index) of layer i's cache."""
    if cfg.alt_local_global:
        kind = "local" if i % 2 == 0 else "global"
        return f"k_{kind}", f"v_{kind}", i // 2
    return "k", "v", i


def init_lm(cfg: ModelConfig, *, device, generator: torch.Generator,
            dtype=None, requires_grad: bool = False) -> LM:
    """Random full model: matrices N(0, 1/fan_in) in ``dtype`` (default the
    compute dtype) drawn from ``generator`` on ``device``, norm scales 1
    (SSM ``A_log`` = log(linspace(1, 16, H)), ``dt_bias`` 0).  Training asks
    for f32 master weights with ``requires_grad=True``.  On an installed
    model axis each leaf is drawn whole and this rank's block kept (the
    peak is one leaf)."""
    with shd.slicing(cfg):
        lm = LM(cfg, device=device, dtype=dtype or cdtype(cfg),
                generator=generator)
    return lm.requires_grad_(requires_grad)


# ---------------------------------------------------------------------------
# embed / logits
# ---------------------------------------------------------------------------
def _rounded(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype`` (nearest, ties to even), as a Python
    float, without making a tensor."""
    if dtype == torch.float64:
        return v
    (bits,) = struct.unpack("<I", struct.pack("<f", v))
    if dtype == torch.bfloat16:
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
        return struct.unpack("<f", struct.pack("<I", bits))[0]
    if dtype == torch.float16:
        return struct.unpack("<e", struct.pack("<e", v))[0]
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def embed(params, tokens, cfg: ModelConfig):
    m = _model_axis(params)
    if m is None:
        x = params.tok_embed.index_select(0, tokens.reshape(-1))
        x = x.reshape(*tokens.shape, -1).to(cdtype(cfg))
    else:
        # vocab-parallel: this rank's rows, zeros for the others' tokens,
        # summed over the axis (one nonzero a token: exact)
        n = params.tok_embed.shape[0]
        local = tokens.reshape(-1).long() - m.index * n
        mine = (local >= 0) & (local < n)
        x = params.tok_embed.index_select(0, torch.where(mine, local, 0))
        x = (x * mine[:, None].to(x.dtype)).reshape(*tokens.shape, -1)
        x = shd.tp_reduce(x.to(cdtype(cfg)))
    if cfg.family == "encdec" or cfg.softcap_logits is not None:
        # gemma / whisper scale: sqrt(d_model) rounded to x's dtype, as a
        # Python float (a scalar tensor made here would be a copy from the
        # host, which a CUDA graph refuses); the product is formed in f32
        # either way, so it is the one a 0-d tensor of x's dtype gives
        x = x * _rounded(math.sqrt(cfg.d_model), x.dtype)
    return x


def lm_logits(params, hidden, cfg: ModelConfig):
    """hidden (..., D) -> logits (..., Vp); on a model axis each rank's
    vocab columns, gathered over the axis (every rank holds them all)."""
    m = _model_axis(params)
    if m is not None:
        hidden = shd.tp_copy(hidden)
    logits = hidden @ params.lm_head.to(hidden.dtype)
    if cfg.softcap_logits is not None:
        logits = torch.tanh(logits / cfg.softcap_logits) * cfg.softcap_logits
    return logits if m is None else shd.tp_gather(logits, -1)


def value_out(params, hidden):
    """hidden (..., T, D) -> value (..., T) in f32."""
    return (hidden.float() @ params.value_head.float())[..., 0]


# ---------------------------------------------------------------------------
# Training path
# ---------------------------------------------------------------------------
def _dense_layer_train(p, x, cfg: ModelConfig, *, window=None,
                       positions=None, x_kv=None, causal=True):
    """One dense layer over a sequence; returns (x, (k, v)), the layer's
    unrepeated K/V heads for the prefill cache.  positions=None (contiguous
    from 0) with causal self-attention is eligible for the flash kernel."""
    h = rmsnorm(p.attn_norm, x)
    a, kv = attention_train(p.attn, h, cfg, positions=positions,
                            causal=causal, window=window, x_kv=x_kv)
    if cfg.post_norm:
        a = rmsnorm(p.attn_post_norm, a)
    x = constrain_res(x + a, cfg)
    h = rmsnorm(p.mlp_norm, x)
    m = mlp(p.mlp, h)
    if cfg.post_norm:
        m = rmsnorm(p.mlp_post_norm, m)
    return constrain_res(x + m, cfg), kv


def _moe_layer_train(p, x, cfg: ModelConfig, *, window=None):
    """One moe layer over a sequence (JAX's ``_moe_layer_train``, and the
    moe branch of its prefill's ``attn_capture``): capacity-bounded dispatch
    in ``shd.n_batch_shards()`` groups.  Returns (x, aux, (k, v))."""
    h = rmsnorm(p.attn_norm, x)
    a, kv = attention_train(p.attn, h, cfg, positions=None, window=window)
    x = constrain_res(x + a, cfg)
    h = rmsnorm(p.moe_norm, x)
    m, aux = moe(p.moe, h, cfg, groups=shd.n_batch_shards())
    return constrain_res(x + m, cfg), aux, kv


def _ssm_layer_train(p, x, cfg: ModelConfig):
    h = rmsnorm(p.norm, x)
    y, _ = ssd_block_train(p.ssd, h, cfg)
    return constrain_res(x + y, cfg)


def _encdec_layer_train(p, x, enc_out, cfg: ModelConfig):
    """One encdec decoder block: causal self-attention (kernel-eligible),
    cross-attention to the encoder output (plain), MLP.  Returns (x,
    (k, v) of the self-attention, (k, v) of the cross-attention)."""
    h = rmsnorm(p.self_norm, x)
    a, kv = attention_train(p.self_attn, h, cfg)
    x = constrain_res(x + a, cfg)
    h = rmsnorm(p.cross_norm, x)
    a, xkv = attention_train(p.cross_attn, h, cfg, x_kv=enc_out,
                             causal=False)
    x = constrain_res(x + a, cfg)
    h = rmsnorm(p.mlp_norm, x)
    return constrain_res(x + mlp(p.mlp, h), cfg), kv, xkv


def apply_superblock_train(x, cfg: ModelConfig, ctx, *layers):
    """One superblock forward (JAX's ``apply_superblock_train``, its block
    params as the superblock's layer modules): gemma2's local then global
    layer, or one plain dense, moe, ssm or encdec layer; hybrid's Mamba-2
    layers then the shared attention block; vlm's self layers then its
    cross layer.  ``ctx`` is (shared block, image tokens, encoder output).
    Returns (x, aux)."""
    shared, img, enc_out = ctx
    zero = torch.zeros((), dtype=F32, device=x.device)
    f = cfg.family
    if f == "ssm":
        return _ssm_layer_train(layers[0], x, cfg), zero
    if f == "moe":
        return _moe_layer_train(layers[0], x, cfg, window=cfg.window)[:2]
    if f == "hybrid":
        for lp in layers:
            x = _ssm_layer_train(lp, x, cfg)
        return _dense_layer_train(shared, x, cfg)[0], zero
    if f == "vlm":
        for lp in layers[:-1]:
            x = _dense_layer_train(lp, x, cfg)[0]
        # cross-attention to the image tokens (non-causal self-attention
        # over the text when there are none, as JAX)
        return _dense_layer_train(layers[-1], x, cfg, x_kv=img,
                                  causal=False)[0], zero
    if f == "encdec":
        return _encdec_layer_train(layers[0], x, enc_out, cfg)[0], zero
    if cfg.alt_local_global:
        local, glob = layers
        x, _ = _dense_layer_train(local, x, cfg, window=cfg.window)
        return _dense_layer_train(glob, x, cfg)[0], zero
    return _dense_layer_train(layers[0], x, cfg, window=cfg.window)[0], zero


def _maybe_checkpoint(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, checkpointed (non-reentrant) under ``cfg.remat`` when
    gradients are on: JAX's ``jax.checkpoint(body)``."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _encoder_layer(x, pos, cfg: ModelConfig, lp):
    return _dense_layer_train(lp, x, cfg, positions=pos, causal=False)[0]


def encoder_forward(params, frames, cfg: ModelConfig):
    """The whisper-style bidirectional encoder over precomputed frame
    embeddings (the conv frontend is a stub, as in JAX).  frames:
    (B, S_enc, D) -> (B, S_enc, D).  Explicit positions, so every layer
    takes the plain attention path."""
    if frames is None:
        raise ValueError("encoder_forward: the encdec family needs "
                         "enc_frames (B, S_enc, D)")
    x = constrain_res(frames.to(cdtype(cfg)), cfg)
    pos = torch.arange(frames.shape[1], device=x.device)
    for lp in params.encoder.blocks:
        x = _maybe_checkpoint(cfg, _encoder_layer, x, pos, cfg, lp)
    return rmsnorm(params.encoder.final_norm, x)


def forward_train(params, tokens, cfg: ModelConfig, *, img=None,
                  enc_frames=None):
    """tokens:(B,T) -> (hidden (B,T,D) in the compute dtype, aux scalar f32:
    the sum of the moe layers' load-balance losses, 0 for the other
    families).  img: (B,I,D) image-token embeddings (vlm); enc_frames:
    (B,S,D) frame embeddings (encdec).

    With ``cfg.remat`` each superblock's activations are dropped after its
    forward and recomputed in the backward (``torch.utils.checkpoint``,
    non-reentrant), so every attention kernel and SSD scan of an update
    runs twice."""
    n_sb, per_block, _ = superblock_layout(cfg)
    x = constrain_res(embed(params, tokens, cfg), cfg)
    enc_out = encoder_forward(params, enc_frames, cfg) \
        if cfg.family == "encdec" else None
    if img is not None:
        img = img.to(cdtype(cfg))
    ctx = (getattr(params, "shared_attn", None), img, enc_out)
    aux = torch.zeros((), dtype=F32, device=x.device)
    for i in range(n_sb):
        layers = params.layers[i * per_block:(i + 1) * per_block]
        x, a = _maybe_checkpoint(cfg, apply_superblock_train, x, cfg, ctx,
                                 *layers)
        aux = aux + a
    for lp in getattr(params, "tail_blocks", ()):
        x = _maybe_checkpoint(cfg, _ssm_layer_train, lp, x, cfg)
    x = rmsnorm(params.final_norm, x)
    return x, aux


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, B: int, S: int, *, device, img_len: int = 0,
               enc_len: int = 0, dtype=None):
    """Allocate the serving cache for a batch of B sequences, max context S;
    vlm / encdec cross K/V hold ``max(img_len, 1)`` / ``max(enc_len, 1)``
    source positions, as JAX's."""
    dt = dtype or cdtype(cfg)
    n_sb, _, tail = superblock_layout(cfg)
    m = shd.model_axis()
    tp, idx = (1, 0) if m is None else (m.size, m.index)
    Hkv, dh = kv_layout(cfg, tp, idx)[2], cfg.d_head
    f = cfg.family
    cache: Dict[str, Any] = {
        "lengths": torch.zeros((B,), dtype=torch.int32, device=device)}

    def kv(n, s):
        return (torch.zeros((n, B, s, Hkv, dh), dtype=dt, device=device),
                torch.zeros((n, B, s, Hkv, dh), dtype=dt, device=device))

    def ssm_states(n):
        Hs, Pd, G, N = (cfg.ssm_n_heads, cfg.ssm_headdim, cfg.ssm_n_groups,
                        cfg.d_state)
        if Hs % tp == 0:   # the rank's heads (the rules split them)
            Hs //= tp
        conv_dim = Hs * Pd + 2 * G * N
        return (torch.zeros((n, B, cfg.conv_kernel - 1, conv_dim), dtype=dt,
                            device=device),
                torch.zeros((n, B, Hs, Pd, N), dtype=F32, device=device))

    Sw = min(cfg.window or S, S)
    if f == "ssm":
        cache["conv"], cache["ssm"] = ssm_states(n_sb)
    elif f == "hybrid":
        cache["conv"], cache["ssm"] = ssm_states(n_sb * cfg.attn_every)
        cache["k"], cache["v"] = kv(n_sb, S)  # the shared block's sites
        if tail:
            cache["tail_conv"], cache["tail_ssm"] = ssm_states(tail)
    elif f == "vlm":
        cache["k"], cache["v"] = kv(n_sb * (cfg.cross_every - 1), S)
        cache["cross_k"], cache["cross_v"] = kv(n_sb, max(img_len, 1))
    elif f == "encdec":
        cache["k"], cache["v"] = kv(n_sb, S)
        cache["cross_k"], cache["cross_v"] = kv(n_sb, max(enc_len, 1))
    elif cfg.alt_local_global:
        cache["k_local"], cache["v_local"] = kv(n_sb, Sw)
        cache["k_global"], cache["v_global"] = kv(n_sb, S)
    else:
        cache["k"], cache["v"] = kv(n_sb, Sw)
    return cache


def _kv_cache_spec(cfg: ModelConfig, B: int, S: int):
    """PartitionSpec for a stacked (n_sb, B, S, Hkv, dh) cache."""
    dp, tpax, tp = shd.dp_axes(), shd.tp_axis(), shd.tp_size()
    ndp = shd.n_batch_shards()
    b_ax = dp if (ndp > 1 and B % ndp == 0) else None
    if tp > 1 and cfg.n_kv_heads % tp == 0:
        h_ax, s_ax = tpax, None
    elif tp > 1 and S % tp == 0:
        h_ax, s_ax = None, tpax
    else:
        h_ax, s_ax = None, None
    if b_ax is None and ndp > 1 and S % (ndp * max(tp, 1)) == 0 \
            and s_ax == tpax:
        s_ax = tuple(dp) + (tpax,)
    elif b_ax is None and ndp > 1 and S % ndp == 0 and s_ax is None:
        s_ax = dp
    return shd.P(None, b_ax, s_ax, h_ax, None)


def constrain_cache_kv(x, cfg: ModelConfig):
    """Constrain a stacked (n_sb, B, S, Hkv, dh) K/V cache to its spec."""
    return shd.constrain(x, _kv_cache_spec(cfg, x.shape[1], x.shape[2]))


def cache_pspecs(cfg: ModelConfig, cache) -> Dict[str, Any]:
    """``{leaf: PartitionSpec}`` for a cache, JAX's rules: K/V by
    ``_kv_cache_spec``, SSM conv / state batch over the dp axes and heads /
    channels over tp, ``lengths`` over dp (the sharding rules only; the
    port places nothing)."""
    dp = shd.dp_axes()
    ndp = shd.n_batch_shards()
    tp = shd.tp_size()

    def spec(name, leaf):
        if name == "lengths":
            return shd.P(dp if ndp > 1 and leaf.shape[0] % ndp == 0
                         else None)
        if leaf.dim() == 5 and name in ("k", "v", "k_local", "v_local",
                                        "k_global", "v_global", "cross_k",
                                        "cross_v"):
            return _kv_cache_spec(cfg, leaf.shape[1], leaf.shape[2])
        # ssm conv/state: (n, B, ...) -- batch over dp, heads over tp
        b_ax = dp if (ndp > 1 and leaf.shape[1] % ndp == 0) else None
        if leaf.dim() == 5:  # ssm state (n,B,H,P,N)
            h_ax = shd.tp_axis() if tp > 1 and leaf.shape[2] % tp == 0 \
                else None
            return shd.P(None, b_ax, h_ax, None, None)
        if leaf.dim() == 4:  # conv state (n,B,K-1,C)
            c_ax = shd.tp_axis() if tp > 1 and leaf.shape[3] % tp == 0 \
                else None
            return shd.P(None, b_ax, None, c_ax)
        return shd.P(*([None] * leaf.dim()))

    return {name: spec(name, leaf) for name, leaf in cache.items()}


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------
def _dense_layer_decode(p, x, ck, cv, lengths, cfg, *, window=None):
    h = rmsnorm(p.attn_norm, x)
    a, nk, nv = attention_decode(p.attn, h, ck, cv, lengths, cfg, window=window)
    if cfg.post_norm:
        a = rmsnorm(p.attn_post_norm, a)
    x = x + a
    h = rmsnorm(p.mlp_norm, x)
    m = mlp(p.mlp, h)
    if cfg.post_norm:
        m = rmsnorm(p.mlp_post_norm, m)
    return x + m, nk, nv


def _moe_layer_decode(p, x, ck, cv, lengths, cfg, *, window=None):
    h = rmsnorm(p.attn_norm, x)
    a, nk, nv = attention_decode(p.attn, h, ck, cv, lengths, cfg, window=window)
    x = x + a
    h = rmsnorm(p.moe_norm, x)
    # exact (no-drop) dispatch by default; capacity-bounded when the config
    # sets decode_capacity_factor
    if cfg.decode_capacity_factor > 0:
        m, _ = moe(p.moe, h, cfg, groups=1,
                   capacity_factor=cfg.decode_capacity_factor)
    else:
        m, _ = moe(p.moe, h, cfg, groups=1, no_drop=True)
    return x + m, nk, nv


def decode_step(params, cache, tokens, cfg: ModelConfig, *, active=None):
    """One decode token for the whole batch.  tokens:(B,) int32.
    Returns (hidden (B,1,D), new_cache); the K/V tensors are updated in
    place and shared with ``cache``.

    ``active`` ((B,) bool, optional) is the continuous-batching slot mask:
    retired slots keep stepping but their ``lengths`` are NOT bumped — their
    outputs are dead and their cache slot is fully overwritten by the next
    ``write_prefill_at`` (serving/slots.py) before reuse."""
    lengths = cache["lengths"]
    x = embed(params, tokens[:, None], cfg)
    new_cache = dict(cache)
    f = cfg.family
    n_sb, per_block, _ = superblock_layout(cfg)
    if f == "ssm":
        for i, lp in enumerate(params.layers):
            x = _ssm_step(lp, x, cache["conv"][i], cache["ssm"][i], cfg)
    elif f == "hybrid":
        for i in range(n_sb):
            for j in range(i * per_block, (i + 1) * per_block):
                x = _ssm_step(params.layers[j], x, cache["conv"][j],
                              cache["ssm"][j], cfg)
            # the shared block at site i: site i's cache only
            x, _, _ = _dense_layer_decode(params.shared_attn, x,
                                          cache["k"][i], cache["v"][i],
                                          lengths, cfg)
        for t, lp in enumerate(getattr(params, "tail_blocks", ())):
            x = _ssm_step(lp, x, cache["tail_conv"][t], cache["tail_ssm"][t],
                          cfg)
        for k in ("k", "v"):
            new_cache[k] = constrain_cache_kv(cache[k], cfg)
    elif f == "vlm":
        ns = per_block - 1
        for i in range(n_sb):
            for j in range(ns):
                x, _, _ = _dense_layer_decode(
                    params.layers[i * per_block + j], x,
                    cache["k"][i * ns + j], cache["v"][i * ns + j], lengths,
                    cfg)
            # the cross layer against the frozen image K/V
            cp = params.layers[i * per_block + ns]
            h = rmsnorm(cp.attn_norm, x)
            x = x + cross_attention_decode(cp.attn, h, cache["cross_k"][i],
                                           cache["cross_v"][i], cfg)
            h = rmsnorm(cp.mlp_norm, x)
            x = x + mlp(cp.mlp, h)
    elif f == "encdec":
        for i, lp in enumerate(params.layers):
            h = rmsnorm(lp.self_norm, x)
            a, _, _ = attention_decode(lp.self_attn, h, cache["k"][i],
                                       cache["v"][i], lengths, cfg)
            x = x + a
            h = rmsnorm(lp.cross_norm, x)
            x = x + cross_attention_decode(lp.cross_attn, h,
                                           cache["cross_k"][i],
                                           cache["cross_v"][i], cfg)
            h = rmsnorm(lp.mlp_norm, x)
            x = x + mlp(lp.mlp, h)
    else:
        layer_fn = _moe_layer_decode if f == "moe" else _dense_layer_decode
        for i, (lp, window) in enumerate(zip(params.layers,
                                             layer_windows(cfg))):
            kn, vn, sb = _cache_slot(cfg, i)
            x, _, _ = layer_fn(lp, x, cache[kn][sb], cache[vn][sb], lengths,
                               cfg, window=window)
        # JAX constrains the caches its scan wrote whole: the global pair
        # of gemma2's alternating layers, every layer's otherwise
        for k in (("k_global", "v_global") if cfg.alt_local_global
                  else ("k", "v")):
            new_cache[k] = constrain_cache_kv(cache[k], cfg)
    bump = 1 if active is None else active.to(torch.int32)
    new_cache["lengths"] = lengths + bump
    x = rmsnorm(params.final_norm, x)
    return x, new_cache


def _ssm_step(p, x, conv, ssm, cfg: ModelConfig):
    """One Mamba-2 layer's decode step; writes its conv / SSM state
    (``conv`` / ``ssm``, views into the cache) in place."""
    h = rmsnorm(p.norm, x)
    y, (ncs, nss) = ssd_block_decode(p.ssd, h, conv, ssm, cfg)
    conv.copy_(ncs)
    ssm.copy_(nss)
    return x + y


# ---------------------------------------------------------------------------
# Prefill: full-sequence forward that also fills the cache
# ---------------------------------------------------------------------------
def _fill_kv(cache_k, cache_v, k, v, window):
    """Write prefill K/V (B,T,Hkv,dh) into a fresh cache (B,S,Hkv,dh), in
    place."""
    S = cache_k.shape[1]
    T = k.shape[1]
    if window is not None and S == window and T > S:
        k, v = k[:, -S:], v[:, -S:]
        # rolling buffer: slot i holds absolute position p where p % S == i
        roll = (T - S) % S
        cache_k.copy_(torch.roll(k, roll, dims=1))
        cache_v.copy_(torch.roll(v, roll, dims=1))
        return cache_k, cache_v
    Tw = min(T, S)
    cache_k[:, :Tw] = k[:, :Tw]
    cache_v[:, :Tw] = v[:, :Tw]
    return cache_k, cache_v


def _ssm_prefill(p, x, conv, ssm, cfg: ModelConfig):
    """One Mamba-2 layer over the prompt from the cache's state (the plain
    chunked scan, as JAX); writes the new conv / SSM state in place."""
    h = rmsnorm(p.norm, x)
    y, (ncs, nss) = ssd_block_train(p.ssd, h, cfg, conv_state=conv,
                                    ssm_state=ssm)
    conv.copy_(ncs)
    ssm.copy_(nss)
    return x + y


def prefill(params, tokens, cfg: ModelConfig, cache, *, img=None,
            enc_frames=None):
    """Run the full-sequence forward, returning (last_hidden (B,1,D), cache).

    The cache must be freshly initialized (lengths == 0); its tensors are
    filled in place.  The ssm and hybrid families pass each Mamba-2 layer's
    cache state into ``ssd_block_train``, so their scan is the plain chunked
    one, as in JAX (the SSD kernel covers the zero-state training shape
    only); the hybrid shared block writes site i's K/V only.  vlm / encdec
    take ``img`` / ``enc_frames`` as ``forward_train`` and store the cross
    layers' source K/V as new ``cross_k`` / ``cross_v`` leaves of the
    source's length (JAX replaces those leaves)."""
    B, T = tokens.shape
    x = constrain_res(embed(params, tokens, cfg), cfg)
    new_cache = dict(cache)
    f = cfg.family
    n_sb, per_block, _ = superblock_layout(cfg)
    dt = cdtype(cfg)
    if f == "ssm":
        for i, lp in enumerate(params.layers):
            x = _ssm_prefill(lp, x, cache["conv"][i], cache["ssm"][i], cfg)
    elif f == "hybrid":
        for i in range(n_sb):
            for j in range(i * per_block, (i + 1) * per_block):
                x = _ssm_prefill(params.layers[j], x, cache["conv"][j],
                                 cache["ssm"][j], cfg)
            x, (k, v) = _dense_layer_train(params.shared_attn, x, cfg)
            _fill_kv(cache["k"][i], cache["v"][i], k, v, None)
        for t, lp in enumerate(getattr(params, "tail_blocks", ())):
            x = _ssm_prefill(lp, x, cache["tail_conv"][t],
                             cache["tail_ssm"][t], cfg)
    elif f == "vlm":
        if img is not None:
            img = img.to(dt)
        ns = per_block - 1
        cks, cvs = [], []
        for i in range(n_sb):
            for j in range(ns):
                x, (k, v) = _dense_layer_train(
                    params.layers[i * per_block + j], x, cfg)
                _fill_kv(cache["k"][i * ns + j], cache["v"][i * ns + j], k, v,
                         None)
            cp = params.layers[i * per_block + ns]
            h = rmsnorm(cp.attn_norm, x)
            a, (ik, iv) = attention_train(cp.attn, h, cfg, causal=False,
                                          x_kv=img)
            x = x + a
            h = rmsnorm(cp.mlp_norm, x)
            x = x + mlp(cp.mlp, h)
            cks.append(ik)
            cvs.append(iv)
        new_cache["cross_k"] = torch.stack(cks).to(dt)
        new_cache["cross_v"] = torch.stack(cvs).to(dt)
    elif f == "encdec":
        enc_out = encoder_forward(params, enc_frames, cfg)
        cks, cvs = [], []
        for i, lp in enumerate(params.layers):
            x, (k, v), (xk, xv) = _encdec_layer_train(lp, x, enc_out, cfg)
            _fill_kv(cache["k"][i], cache["v"][i], k, v, None)
            cks.append(xk)
            cvs.append(xv)
        new_cache["cross_k"] = torch.stack(cks).to(dt)
        new_cache["cross_v"] = torch.stack(cvs).to(dt)
    else:
        for i, (lp, window) in enumerate(zip(params.layers,
                                             layer_windows(cfg))):
            if f == "moe":
                x, _, (k, v) = _moe_layer_train(lp, x, cfg, window=window)
            else:
                x, (k, v) = _dense_layer_train(lp, x, cfg, window=window)
            kn, vn, sb = _cache_slot(cfg, i)
            _fill_kv(cache[kn][sb], cache[vn][sb], k, v, window)
    new_cache["lengths"] = cache["lengths"] + T
    x_last = rmsnorm(params.final_norm, x[:, -1:, :])
    return x_last, new_cache
