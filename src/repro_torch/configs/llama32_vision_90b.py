"""llama-3.2-vision-90b [vlm] — cross-attn image layers every 5th layer.
100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
Vision frontend is a STUB: input_specs provides precomputed patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision (90B variant); unverified]

Copied field for field from the JAX package's
``src/repro/configs/llama32_vision_90b.py``
(``config`` at line 8, ``smoke_config`` at line 25)"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        n_layers=100,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_head=128,
        d_ff=28672,
        vocab=128256,
        rope_theta=500_000.0,
        cross_every=5,          # superblock: 4 self + 1 cross -> 20 cross layers
        n_img_tokens=1600,      # stub patch embeddings (B, 1600, D)
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama-vision-smoke",
        family="vlm",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab=256,
        cross_every=2,          # 2 superblocks of (1 self + 1 cross)
        n_img_tokens=8,
        remat=False,
        attn_chunk_q=16,
    )
