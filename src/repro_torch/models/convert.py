"""Load the JAX package's parameters into the PyTorch port's modules.

``params_from_jax`` takes the nested dict that ``repro.models.backbones
.init_lm`` returns, converted leaf by leaf to numpy by the caller, and fills
an ``LM``.  The stacked superblock leaves ``blocks/...`` (leading dim
``n_sb``) go to ``LM.layers``: for gemma2's local/global pairs,
``blocks/local/...[i]`` to layer ``2i`` and ``blocks/global/...[i]`` to
layer ``2i+1``; for plain dense and for mamba2 (``blocks/norm/scale``,
``blocks/ssd/{wz,wx,wB,wC,wdt,A_log,dt_bias,conv_w,norm_scale,out_proj}``),
``blocks/...[i]`` to layer ``i``.  Matrices are stored in ``dtype``; norm
scales and the SSM's ``A_log`` / ``dt_bias`` in f32.  JAX casts every
weight to the compute dtype right before its product, so storing the
matrices in the compute dtype computes the same thing for serving; training
asks for f32 master weights with ``requires_grad=True``.

``rl_params_from_jax`` carries the parameter pytree of a small RL model
(``repro.models.rl_models``: the Q, PG and continuous models, and
``make_recurrent_q`` with its ``lstm/{wx,wh,b}``) into the port's
``models/rl_models.py``, whose params are the same nested dicts and lists
of arrays: a leaf-for-leaf copy into f32 tensors.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .backbones import LM, superblock_layout
from .config import ModelConfig


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, name + "/"))
        else:
            out[name] = np.asarray(v)
    return out


def params_from_jax(np_params: Dict, cfg: ModelConfig, *, device,
                    dtype=torch.float32, requires_grad: bool = False) -> LM:
    """JAX ``init_lm`` params (nested dict of numpy arrays) -> ``LM``.
    Raises if a leaf is missing, unexpected, or of the wrong shape."""
    n_sb, per_block, _ = superblock_layout(cfg)
    leaves = _flatten(np_params)
    lm = LM(cfg, device=device, dtype=dtype)
    targets = {}  # jax leaf name -> list of (torch param, index or None)
    for name, p in lm.named_parameters():
        if name.startswith("layers."):
            _, idx, rest = name.split(".", 2)
            i = int(idx)
            if cfg.alt_local_global:
                jax_name = f"blocks/{'local' if i % 2 == 0 else 'global'}/"
            else:
                jax_name = "blocks/"
            jax_name += rest.replace(".", "/")
            targets.setdefault(jax_name, []).append((p, i // per_block))
        else:
            targets.setdefault(name.replace(".", "/"), []).append((p, None))
    missing = sorted(set(targets) - set(leaves))
    extra = sorted(set(leaves) - set(targets))
    if missing or extra:
        raise ValueError(f"params_from_jax: missing leaves {missing}, "
                         f"unexpected leaves {extra}")
    with torch.no_grad():
        for jax_name, dests in targets.items():
            src = leaves[jax_name]
            for p, sb in dests:
                val = src if sb is None else src[sb]
                if sb is not None and src.shape[0] != n_sb:
                    raise ValueError(f"{jax_name}: leading dim {src.shape[0]}"
                                     f" != {n_sb} superblocks")
                if tuple(val.shape) != tuple(p.shape):
                    raise ValueError(f"{jax_name}: shape {val.shape} != "
                                     f"{tuple(p.shape)}")
                p.copy_(torch.from_numpy(np.array(val)))
    return lm.requires_grad_(requires_grad)


def rl_params_from_jax(np_params, *, device="cpu"):
    """JAX RL-model params (nested dicts / lists of numpy arrays, the layout
    of ``rl_models``' ``init``) -> the same tree of f32 tensors on
    ``device``."""
    return pytree.tree_map(
        lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,
                               device=device), np_params)
