"""phi3-mini-3.8b [dense] — RoPE SwiGLU, MHA-as-GQA (kv=32).
32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064.
[arXiv:2404.14219; unverified]

Copied field for field from the JAX package's
``src/repro/configs/phi3_mini_3p8b.py``
(``config`` at line 7, ``smoke_config`` at line 21)."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_head=96,
        d_ff=8192,
        vocab=32064,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=128,
        vocab=256,
        remat=False,
        attn_chunk_q=16,
    )
