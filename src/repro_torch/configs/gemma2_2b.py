"""gemma2-2b [dense] — alternating local(4096-window)/global attention,
attn softcap 50, final-logit softcap 30, post-sublayer norms, embed scaling.
26L d_model=2304 8H (GQA kv=4, d_head=256) d_ff=9216 vocab=256000.
[arXiv:2408.00118; hf]"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        family="dense",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        d_head=256,
        d_ff=9216,
        vocab=256000,
        window=4096,
        alt_local_global=True,  # superblock = (local, global) pair -> 13 blocks
        softcap_attn=50.0,
        softcap_logits=30.0,
        post_norm=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-smoke",
        family="dense",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab=256,
        window=16,
        alt_local_global=True,
        softcap_attn=50.0,
        softcap_logits=30.0,
        post_norm=True,
        remat=False,
        attn_chunk_q=16,
    )
