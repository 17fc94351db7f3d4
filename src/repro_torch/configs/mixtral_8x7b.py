"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention (4096).
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
[arXiv:2401.04088; hf]

Copied field for field from the JAX package's
``src/repro/configs/mixtral_8x7b.py``
(``config`` at line 7, ``smoke_config`` at line 27)."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=14336,
        vocab=32000,
        rope_theta=1_000_000.0,
        window=4096,            # SWA: rolling KV buffer at decode
        n_experts=8,
        top_k=2,
        n_shared_experts=0,
        d_ff_expert=14336,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab=256,
        window=16,
        n_experts=4,
        top_k=2,
        n_shared_experts=0,
        d_ff_expert=128,
        remat=False,
        attn_chunk_q=16,
    )
