"""Model configuration for the backbone zoo.

One dataclass covers all 10 assigned families (dense / moe / ssm / hybrid /
encdec / vlm); family-specific fields are ignored where inapplicable.  The
agent's model is a backbone + head(s): policy logits over the action space
(vocab for token MDPs) and a value head — the paper's Model abstraction at
modern scale.

The PyTorch port keeps its own copy of ``repro/models/config.py``'s
``pad_vocab`` and ``ModelConfig`` so that it imports nothing of the JAX
package; the two must stay field-for-field identical (the parity tests build
one from the other's fields).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


def pad_vocab(v: int, multiple: int = 128) -> int:
    return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm

    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 64
    d_ff: int = 1024
    vocab: int = 1000

    # attention flavor
    rope_theta: float = 10_000.0
    window: Optional[int] = None          # sliding-window size (mixtral, gemma2 local)
    alt_local_global: bool = False        # gemma2: alternate local/global layers
    softcap_attn: Optional[float] = None  # gemma2 50.0
    softcap_logits: Optional[float] = None  # gemma2 30.0
    post_norm: bool = False               # gemma2: post-sublayer RMSNorm

    # moe
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25

    # ssm (mamba2 / SSD)
    d_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_n_groups: int = 1
    conv_kernel: int = 4
    ssd_chunk: int = 256

    # hybrid (zamba2): shared attention block applied every k mamba blocks
    attn_every: int = 6

    # vlm (llama-3.2-vision): 1 cross-attn layer per group of self-attn layers
    cross_every: int = 5                  # superblock = (cross_every-1) self + 1 cross
    n_img_tokens: int = 0

    # encdec (whisper)
    n_enc_layers: int = 0
    enc_len: int = 1500                   # precomputed frame embeddings (stub frontend)

    # numerics / lowering
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    attn_chunk_q: int = 512               # q-block size for chunked (flash-style jnp) attention
    remat: bool = True                    # activation checkpoint each scanned block
    unroll: bool = False                  # python-loop layers/chunks instead of lax.scan
    #   (dry-run cost-variant lowering: XLA cost_analysis counts while bodies
    #    ONCE, so roofline variants lower unrolled 1/2-superblock models)

    # ---- beyond-paper perf knobs (§Perf hillclimb; defaults = baseline) ----
    cast_weights_bf16: bool = False       # cast params shard-local BEFORE the
    #   FSDP all-gather: halves weight-gather + grad-reduce wire bytes
    ssd_bf16: bool = False                # SSD intra-chunk (L/scores/M) in
    #   bf16; inter-chunk state stays f32 — halves the dominant HBM traffic
    decode_capacity_factor: float = 0.0   # >0: capacity-bounded MoE decode
    #   dispatch (C = ceil(B*K/E * cf)) instead of exact no-drop C = B*K;
    #   cuts dense-dispatch expert compute by ~E/(K*cf)

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab)

    @property
    def d_inner(self) -> int:  # ssm
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def n_params(self) -> int:
        """Analytic parameter count (matches init; used for 6·N·D roofline)."""
        D, V = self.d_model, self.padded_vocab
        n = V * D  # tok embed
        n += D * V  # lm head (untied)

        def attn_params():
            return D * self.n_heads * self.d_head * 2 + D * self.n_kv_heads * self.d_head * 2

        def mlp_params(ff):
            return 3 * D * ff

        def ssm_params():
            H, P, G, N = self.ssm_n_heads, self.ssm_headdim, self.ssm_n_groups, self.d_state
            p = D * H * P * 2                    # wz, wx
            p += D * G * N * 2                   # wB, wC
            p += D * H                           # wdt
            p += H * 2                           # A_log, dt_bias
            p += (H * P + 2 * G * N) * self.conv_kernel  # depthwise conv
            p += H * P                           # gated rmsnorm scale
            p += H * P * D                       # out proj
            return p

        if self.family == "dense":
            n += self.n_layers * (attn_params() + mlp_params(self.d_ff))
        elif self.family == "moe":
            per = attn_params()
            per += D * self.n_experts  # router
            per += self.n_experts * 3 * D * self.d_ff_expert
            per += self.n_shared_experts * 3 * D * self.d_ff_expert
            n += self.n_layers * per
        elif self.family == "ssm":
            n += self.n_layers * ssm_params()
        elif self.family == "hybrid":
            n += self.n_layers * ssm_params()
            n += attn_params() + mlp_params(self.d_ff)  # one shared attn+mlp block
        elif self.family == "vlm":
            n_cross = self.n_layers // self.cross_every
            n_self = self.n_layers - n_cross
            n += n_self * (attn_params() + mlp_params(self.d_ff))
            n += n_cross * (attn_params() + mlp_params(self.d_ff))
        elif self.family == "encdec":
            n += self.n_enc_layers * (attn_params() + mlp_params(self.d_ff))
            # decoder: self-attn + cross-attn + mlp
            n += self.n_layers * (2 * attn_params() + mlp_params(self.d_ff))
        # norms (scales) — negligible but counted
        n += self.n_layers * 2 * D + D
        return n

    def n_active_params(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.n_params()
        D = self.d_model
        dense_total = self.n_params()
        all_expert = self.n_layers * self.n_experts * 3 * D * self.d_ff_expert
        active_expert = self.n_layers * self.top_k * 3 * D * self.d_ff_expert
        return dense_total - all_expert + active_expert



@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell of the dry-run matrix."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)
