"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention block applied
periodically (the shared block's params are reused at every site; each site
has its own KV cache).  81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64.  81 = 13 superblocks x 6 mamba + shared-attn, + 3 tail mamba.
[arXiv:2411.15242; unverified]

Copied field for field from the JAX package's
``src/repro/configs/zamba2_7b.py``
(``config`` at line 9, ``smoke_config`` at line 30)"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_head=112,
        d_ff=14336,
        vocab=32000,
        d_state=64,
        ssm_headdim=64,
        ssm_expand=2,           # d_inner = 7168 -> 112 ssm heads
        ssm_n_groups=1,
        conv_kernel=4,
        ssd_chunk=256,
        attn_every=6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke",
        family="hybrid",
        n_layers=5,             # 2 superblocks x 2 + 1 tail
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=128,
        vocab=256,
        d_state=16,
        ssm_headdim=16,
        ssm_expand=2,
        ssm_n_groups=1,
        conv_kernel=4,
        ssd_chunk=8,
        attn_every=2,
        remat=False,
        attn_chunk_q=16,
    )
