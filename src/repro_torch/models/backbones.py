"""Backbones of the ported families, in PyTorch.

Port of three families of ``repro/models/backbones.py``, dense (gemma2's
local/global layer pairs with ``alt_local_global``, plain dense without),
moe (attention + a mixture of experts a layer: qwen2-moe, mixtral) and ssm
(mamba2), each on both paths: the training forward and the serving
prefill / decode step.

- ``LM`` is an ``nn.Module`` with the JAX leaves as parameters.  The JAX
  params stack each superblock's leaves with a leading dim; here layer
  ``2i`` / ``2i+1`` of ``LM.layers`` holds superblock ``i``'s ``local`` /
  ``global`` layer (layer ``i`` for plain dense), and each ``lax.scan`` over
  superblocks is a Python loop.
  A moe ``LM`` holds one ``MoELayer`` (leaves ``attn_norm``, ``attn``,
  ``moe_norm``, ``moe``) per layer, an ssm ``LM`` one ``SSMLayer`` (leaves
  ``norm``, ``ssd``).
- ``init_cache``, ``embed``, ``lm_logits``, ``value_out``, ``prefill``,
  ``decode_step`` and ``forward_train`` are plain functions with the JAX
  signatures (plus an explicit ``device`` where they allocate).  Cache
  leaves keep the JAX layout — K/V ``(n_sb, B, S, Hkv, dh)``, SSM conv
  ``(n_sb, B, K-1, conv_dim)`` and state ``(n_sb, B, H, P, N)`` f32,
  ``lengths`` ``(B,)`` int32 — and are updated IN PLACE: ``prefill`` and
  ``decode_step`` write into the tensors of the cache they are given and
  return a new dict holding those same tensors plus a new ``lengths``.
- ``forward_train``: with ``cfg.remat`` each superblock is checkpointed
  with ``torch.utils.checkpoint`` (non-reentrant), the counterpart of
  ``jax.checkpoint`` over the scanned superblocks.
- Single-device only: the JAX sharding constraints are identities on one
  device and are dropped, and the moe dispatch has one group (JAX's
  ``groups=shd.n_batch_shards()``; the argument is kept for the
  distributed half).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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
    attention_decode,
    attention_train,
    cdtype,
    mlp,
    moe,
    rmsnorm,
    ssd_block_decode,
    ssd_block_train,
)

PORTED_FAMILIES = ("dense", "moe", "ssm")


def superblock_layout(cfg: ModelConfig):
    """Returns (n_superblocks, layers_per_block, tail_layers)."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported to "
                                  f"repro_torch yet (ported: "
                                  f"{PORTED_FAMILIES}; the others are ROADMAP "
                                  "Queue 1 items 10c and 10d)")
    if cfg.family == "dense" and cfg.alt_local_global:
        if cfg.n_layers % 2:
            raise ValueError("alt_local_global needs an even n_layers")
        return cfg.n_layers // 2, 2, 0
    return cfg.n_layers, 1, 0


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


class LM(nn.Module):
    """Leaves ``tok_embed`` (Vp,D), ``layers``, ``final_norm``, ``lm_head``
    (D,Vp), ``value_head`` (D,1).  Matrices are stored in ``dtype``, norm
    scales in f32."""

    def __init__(self, cfg: ModelConfig, *, device, dtype, generator=None):
        super().__init__()
        superblock_layout(cfg)  # rejects unported families
        Vp, D = cfg.padded_vocab, cfg.d_model

        def mat(shape, fan_in):
            if generator is None:
                return _empty(shape, device=device, dtype=dtype)
            return _dense_init(shape, fan_in, generator=generator,
                               device=device, dtype=dtype)

        self.tok_embed = mat((Vp, D), D)
        layer = {"ssm": SSMLayer, "moe": MoELayer}.get(cfg.family,
                                                       DenseLayer)
        self.layers = nn.ModuleList(
            layer(cfg, device=device, dtype=dtype, generator=generator)
            for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(D, device=device)
        self.lm_head = mat((D, Vp), D)
        self.value_head = mat((D, 1), D)


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
    for f32 master weights with ``requires_grad=True``."""
    lm = LM(cfg, device=device, dtype=dtype or cdtype(cfg),
            generator=generator)
    return lm.requires_grad_(requires_grad)


# ---------------------------------------------------------------------------
# embed / logits
# ---------------------------------------------------------------------------
def embed(params, tokens, cfg: ModelConfig):
    x = params.tok_embed.index_select(0, tokens.reshape(-1))
    x = x.reshape(*tokens.shape, -1).to(cdtype(cfg))
    if cfg.softcap_logits is not None:  # gemma scale
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def lm_logits(params, hidden, cfg: ModelConfig):
    logits = hidden @ params.lm_head.to(hidden.dtype)
    if cfg.softcap_logits is not None:
        logits = torch.tanh(logits / cfg.softcap_logits) * cfg.softcap_logits
    return logits


def value_out(params, hidden):
    """hidden (..., T, D) -> value (..., T) in f32."""
    return (hidden.float() @ params.value_head.float())[..., 0]


# ---------------------------------------------------------------------------
# Training path
# ---------------------------------------------------------------------------
def _dense_layer_train(p, x, cfg: ModelConfig, *, window=None):
    """One dense layer over a sequence; returns (x, (k, v)), the layer's
    unrepeated K/V heads for the prefill cache."""
    h = rmsnorm(p.attn_norm, x)
    # positions=None: contiguous from 0, eligible for the flash kernel
    a, kv = attention_train(p.attn, h, cfg, positions=None, window=window)
    if cfg.post_norm:
        a = rmsnorm(p.attn_post_norm, a)
    x = x + a
    h = rmsnorm(p.mlp_norm, x)
    m = mlp(p.mlp, h)
    if cfg.post_norm:
        m = rmsnorm(p.mlp_post_norm, m)
    return x + m, kv


def _moe_layer_train(p, x, cfg: ModelConfig, *, window=None, groups=1):
    """One moe layer over a sequence (JAX's ``_moe_layer_train``, and the
    moe branch of its prefill's ``attn_capture``): capacity-bounded dispatch
    in ``groups`` groups.  Returns (x, aux, (k, v))."""
    h = rmsnorm(p.attn_norm, x)
    a, kv = attention_train(p.attn, h, cfg, positions=None, window=window)
    x = x + a
    h = rmsnorm(p.moe_norm, x)
    m, aux = moe(p.moe, h, cfg, groups=groups)
    return x + m, aux, kv


def _ssm_layer_train(p, x, cfg: ModelConfig):
    h = rmsnorm(p.norm, x)
    y, _ = ssd_block_train(p.ssd, h, cfg)
    return x + y


def _superblock_train(x, cfg: ModelConfig, *layers):
    """One superblock forward (JAX's ``apply_superblock_train`` of the
    ported families): gemma2's local then global layer, or one plain dense
    or ssm layer; a moe layer returns (x, aux)."""
    if cfg.family == "ssm":
        return _ssm_layer_train(layers[0], x, cfg)
    if cfg.family == "moe":
        return _moe_layer_train(layers[0], x, cfg, window=cfg.window)[:2]
    if cfg.alt_local_global:
        local, glob = layers
        x, _ = _dense_layer_train(local, x, cfg, window=cfg.window)
        return _dense_layer_train(glob, x, cfg)[0]
    return _dense_layer_train(layers[0], x, cfg, window=cfg.window)[0]


def forward_train(params, tokens, cfg: ModelConfig):
    """tokens:(B,T) -> (hidden (B,T,D) in the compute dtype, aux scalar f32:
    the sum of the moe layers' load-balance losses, 0 for the other
    families).

    With ``cfg.remat`` each superblock's activations are dropped after its
    forward and recomputed in the backward (``torch.utils.checkpoint``,
    non-reentrant), so every attention kernel and SSD scan of an update
    runs twice."""
    n_sb, per_block, _ = superblock_layout(cfg)
    x = embed(params, tokens, cfg)
    aux = torch.zeros((), dtype=F32, device=x.device)
    for i in range(n_sb):
        layers = params.layers[i * per_block:(i + 1) * per_block]
        if cfg.remat and torch.is_grad_enabled():
            out = checkpoint(_superblock_train, x, cfg, *layers,
                             use_reentrant=False)
        else:
            out = _superblock_train(x, cfg, *layers)
        if cfg.family == "moe":
            x, a = out
            aux = aux + a
        else:
            x = out
    x = rmsnorm(params.final_norm, x)
    return x, aux


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, B: int, S: int, *, device, dtype=None):
    """Allocate the serving cache for a batch of B sequences, max context S."""
    dt = dtype or cdtype(cfg)
    n_sb, _, _ = superblock_layout(cfg)
    Hkv, dh = cfg.n_kv_heads, cfg.d_head
    cache: Dict[str, Any] = {
        "lengths": torch.zeros((B,), dtype=torch.int32, device=device)}
    if cfg.family == "ssm":
        Hs, Pd, G, N = (cfg.ssm_n_heads, cfg.ssm_headdim, cfg.ssm_n_groups,
                        cfg.d_state)
        conv_dim = Hs * Pd + 2 * G * N
        cache["conv"] = torch.zeros((n_sb, B, cfg.conv_kernel - 1, conv_dim),
                                    dtype=dt, device=device)
        cache["ssm"] = torch.zeros((n_sb, B, Hs, Pd, N), dtype=F32,
                                   device=device)
        return cache

    def kv(s):
        return (torch.zeros((n_sb, B, s, Hkv, dh), dtype=dt, device=device),
                torch.zeros((n_sb, B, s, Hkv, dh), dtype=dt, device=device))

    Sl = min(cfg.window or S, S)
    if cfg.alt_local_global:
        cache["k_local"], cache["v_local"] = kv(Sl)
        cache["k_global"], cache["v_global"] = kv(S)
    else:
        cache["k"], cache["v"] = kv(Sl)
    return cache


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
    if cfg.family == "ssm":
        for i, lp in enumerate(params.layers):
            h = rmsnorm(lp.norm, x)
            y, (ncs, nss) = ssd_block_decode(lp.ssd, h, cache["conv"][i],
                                             cache["ssm"][i], cfg)
            cache["conv"][i].copy_(ncs)
            cache["ssm"][i].copy_(nss)
            x = x + y
    else:
        layer_fn = _moe_layer_decode if cfg.family == "moe" else \
            _dense_layer_decode
        for i, (lp, window) in enumerate(zip(params.layers,
                                             layer_windows(cfg))):
            kn, vn, sb = _cache_slot(cfg, i)
            x, _, _ = layer_fn(lp, x, cache[kn][sb], cache[vn][sb], lengths,
                               cfg, window=window)
    bump = 1 if active is None else active.to(torch.int32)
    new_cache["lengths"] = lengths + bump
    x = rmsnorm(params.final_norm, x)
    return x, new_cache


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


def prefill(params, tokens, cfg: ModelConfig, cache):
    """Run the full-sequence forward, returning (last_hidden (B,1,D), cache).

    The cache must be freshly initialized (lengths == 0); its tensors are
    filled in place.  The ssm family passes each layer's cache state into
    ``ssd_block_train``, so its scan is the plain chunked one, as in JAX
    (the SSD kernel covers the zero-state training shape only)."""
    B, T = tokens.shape
    x = embed(params, tokens, cfg)
    new_cache = dict(cache)
    if cfg.family == "ssm":
        for i, lp in enumerate(params.layers):
            h = rmsnorm(lp.norm, x)
            y, (ncs, nss) = ssd_block_train(lp.ssd, h, cfg,
                                            conv_state=cache["conv"][i],
                                            ssm_state=cache["ssm"][i])
            cache["conv"][i].copy_(ncs)
            cache["ssm"][i].copy_(nss)
            x = x + y
    else:
        for i, (lp, window) in enumerate(zip(params.layers,
                                             layer_windows(cfg))):
            if cfg.family == "moe":
                x, _, (k, v) = _moe_layer_train(lp, x, cfg, window=window)
            else:
                x, (k, v) = _dense_layer_train(lp, x, cfg, window=window)
            kn, vn, sb = _cache_slot(cfg, i)
            _fill_kv(cache[kn][sb], cache[vn][sb], k, v, window)
    new_cache["lengths"] = cache["lengths"] + T
    x_last = rmsnorm(params.final_norm, x[:, -1:, :])
    return x_last, new_cache
