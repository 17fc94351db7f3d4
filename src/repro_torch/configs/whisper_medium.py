"""whisper-medium [audio/encdec] — encoder-decoder; conv frontend STUBBED
(input_specs provides precomputed frame embeddings (B, 1500, D)).
24L enc + 24L dec, d_model=1024 16H (kv=16) d_ff=4096 vocab=51865 (pad 51968).
[arXiv:2212.04356; unverified]

Copied field for field from the JAX package's
``src/repro/configs/whisper_medium.py``
(``config`` at line 8, ``smoke_config`` at line 24)"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="encdec",
        n_layers=24,            # decoder layers
        n_enc_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_head=64,
        d_ff=4096,
        vocab=51865,
        enc_len=1500,           # stub frame embeddings
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        family="encdec",
        n_layers=2,
        n_enc_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=128,
        vocab=256,
        enc_len=12,
        remat=False,
        attn_chunk_q=16,
    )
