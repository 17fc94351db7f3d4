"""Meta-device stand-ins for every model input (dry run, no allocation).

Port of ``repro/launch/specs.py``.  A tensor on ``torch.device("meta")``
has a shape and a dtype and no storage: the port's counterpart of
``jax.eval_shape`` / ``ShapeDtypeStruct``.  Ops on meta tensors compute
their output's shape and dtype and nothing else, so the port's own steps
run on these specs at full width and depth.

  train   -> train_step(params, opt_state, batch)
  prefill -> prefill(params, tokens, cfg, cache [, img / enc_frames])
  decode  -> decode_step(params, cache, tokens, cfg)

``param_specs(cfg, kind)`` gives the dtypes that path runs with: f32
master weights that require grad for ``train`` (JAX's leaves are f32 too),
matrices in the compute dtype (bf16) for ``prefill`` / ``decode``, as
``launch/serve.py`` holds them; norm scales and the SSM's ``A_log`` /
``dt_bias`` stay f32 on both.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..models import backbones as bb
from ..models.config import ModelConfig, ShapeCell
from ..models.layers import cdtype

META = torch.device("meta")
F32, I32, BF16 = torch.float32, torch.int32, torch.bfloat16


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    B, T = cell.global_batch, cell.seq_len
    batch = {
        "tokens": _spec((B, T), I32),
        "actions": _spec((B, T), I32),
        "logp_old": _spec((B, T), F32),
        "advantage": _spec((B, T), F32),
        "return_": _spec((B, T), F32),
    }
    if cfg.family == "vlm":
        batch["img_embed"] = _spec((B, cfg.n_img_tokens, cfg.d_model), BF16)
    if cfg.family == "encdec":
        batch["enc_frames"] = _spec((B, cfg.enc_len, cfg.d_model), BF16)
    return batch


def cache_specs(cfg: ModelConfig, B: int, S: int):
    """The serving cache of ``init_cache`` on the meta device."""
    return bb.init_cache(cfg, B, S, device=META, img_len=cfg.n_img_tokens,
                         enc_len=cfg.enc_len)


def prefill_specs(cfg: ModelConfig, cell: ShapeCell):
    B, T = cell.global_batch, cell.seq_len
    kw = {"tokens": _spec((B, T), I32), "cache": cache_specs(cfg, B, T)}
    if cfg.family == "vlm":
        kw["img"] = _spec((B, cfg.n_img_tokens, cfg.d_model), BF16)
    if cfg.family == "encdec":
        kw["enc_frames"] = _spec((B, cfg.enc_len, cfg.d_model), BF16)
    return kw


def decode_specs(cfg: ModelConfig, cell: ShapeCell):
    B, S = cell.global_batch, cell.seq_len
    return {"tokens": _spec((B,), I32), "cache": cache_specs(cfg, B, S)}


def param_specs(cfg: ModelConfig, kind: str = "train") -> bb.LM:
    """An ``LM`` on the meta device with the dtypes of the ``kind`` path
    (see the module docstring).  Built with no generator, so nothing is
    drawn; ``init_lm`` on a real device draws as before."""
    if kind == "train":
        return bb.LM(cfg, device=META, dtype=F32).requires_grad_(True)
    if kind in ("prefill", "decode"):
        return bb.LM(cfg, device=META, dtype=cdtype(cfg))
    raise ValueError(f"unknown cell kind {kind!r} (train | prefill | decode)")
