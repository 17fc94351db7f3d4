"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4.
24L d_model=2048 16H (kv=16) d_ff_expert=1408 vocab=151936.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

Copied field for field from the JAX package's
``src/repro/configs/qwen2_moe_a2p7b.py``
(``config`` at line 7, ``smoke_config`` at line 25)."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_head=128,
        d_ff=1408,
        vocab=151936,
        n_experts=60,
        top_k=4,
        n_shared_experts=4,     # shared ffn width = 4 * 1408 = 5632
        d_ff_expert=1408,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=96,
        vocab=256,
        n_experts=8,
        top_k=2,
        n_shared_experts=1,
        d_ff_expert=96,
        remat=False,
        attn_chunk_q=16,
    )
