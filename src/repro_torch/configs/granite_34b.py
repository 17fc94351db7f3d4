"""granite-34b [dense] — llama-arch code model, MQA (kv=1), 88 layers.
88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
[arXiv:2405.04324; unverified]

Copied field for field from the JAX package's
``src/repro/configs/granite_34b.py``
(``config`` at line 7, ``smoke_config`` at line 21)."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-34b",
        family="dense",
        n_layers=88,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,           # MQA: KV replicated under TP
        d_head=128,
        d_ff=24576,
        vocab=49152,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_head=16,
        d_ff=128,
        vocab=256,
        remat=False,
        attn_chunk_q=16,
    )
