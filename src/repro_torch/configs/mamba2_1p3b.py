"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.
48L d_model=2048 vocab=50280 (padded 50304), ssm_state=128.
[arXiv:2405.21060; unverified]"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=0, n_kv_heads=0, d_head=0, d_ff=0,
        vocab=50280,
        d_state=128,
        ssm_headdim=64,
        ssm_expand=2,       # d_inner = 4096 -> 64 ssm heads
        ssm_n_groups=1,
        conv_kernel=4,
        ssd_chunk=256,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=0, n_kv_heads=0, d_head=0, d_ff=0,
        vocab=256,
        d_state=16,
        ssm_headdim=16,
        ssm_expand=2,       # d_inner = 128 -> 8 ssm heads
        ssm_n_groups=1,
        conv_kernel=4,
        ssd_chunk=8,
        remat=False,
    )
