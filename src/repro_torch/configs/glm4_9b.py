"""glm4-9b [dense] — RoPE, GQA kv=2.
40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
[hf:THUDM/glm-4-9b; hf]

Copied field for field from the JAX package's
``src/repro/configs/glm4_9b.py``
(``config`` at line 7, ``smoke_config`` at line 21)."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        d_head=128,
        d_ff=13696,
        vocab=151552,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="glm4-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab=256,
        remat=False,
        attn_chunk_q=16,
    )
