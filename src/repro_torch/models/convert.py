"""Load the JAX package's parameters into the PyTorch port's modules.

``params_from_jax`` takes the nested dict that ``repro.models.backbones
.init_lm`` returns, converted leaf by leaf to numpy by the caller, and fills
an ``LM``.  The stacked superblock leaves ``blocks/...`` (leading dim
``n_sb``) go to ``LM.layers``: for gemma2's local/global pairs,
``blocks/local/...[i]`` to layer ``2i`` and ``blocks/global/...[i]`` to
layer ``2i+1``; for plain dense, for moe (``blocks/{attn_norm,moe_norm}
/scale``, ``blocks/attn/...``, ``blocks/moe/{router,experts_wi,experts_wg,
experts_wd}`` and, with shared experts, ``blocks/moe/shared/{wi,wg,wd}``)
and for mamba2 (``blocks/norm/scale``,
``blocks/ssd/{wz,wx,wB,wC,wdt,A_log,dt_bias,conv_w,norm_scale,out_proj}``),
``blocks/...[i]`` to layer ``i``.  The hybrid family's
``blocks/mamba/...[i, j]`` (stacked (n_sb, attn_every, ...)) goes to layer
``i * attn_every + j``, ``tail_blocks/...[t]`` to ``tail_blocks[t]`` and
``shared_attn/...`` (held once, not per block) to ``shared_attn``; the vlm
family's ``blocks/self/...[i, j]`` (stacked (n_sb, cross_every - 1, ...))
to layer ``i * cross_every + j`` and ``blocks/cross/...[i]`` to layer
``i * cross_every + cross_every - 1``; the encdec family's decoder leaves
``blocks/{self_norm,self_attn,cross_norm,cross_attn,mlp_norm,mlp}/...[i]``
to layer ``i``, ``encoder/blocks/...[i]`` to ``encoder.blocks[i]`` and
``encoder/final_norm/scale`` to ``encoder.final_norm``.  Matrices are
stored in ``dtype``; norm scales and the SSM's ``A_log`` / ``dt_bias`` in
f32.  JAX casts every weight to the compute dtype right before its
product, so storing the
matrices in the compute dtype computes the same thing for serving; training
asks for f32 master weights with ``requires_grad=True``.

``params_to_jax`` is its inverse: the port's tensors, named as in
``LM.named_parameters()`` (the params themselves, or an optimizer's moments
in the params' order), stacked back into JAX's nested dict, so a
checkpoint written from the port has JAX's layout (``train/checkpoint.py``).

On a 'model' axis of ranks (``mesh=``, default the installed one:
``models/sharding.py``) ``params_from_jax`` gives this rank its block of
each leaf the rules split, and ``params_to_jax(specs=, mesh=)`` gathers
the blocks back into the global leaves (every rank of the axis calls it).

``rl_params_from_jax`` carries the parameter pytree of a small RL model
(``repro.models.rl_models``: the Q, PG and continuous models, and
``make_recurrent_q`` with its ``lstm/{wx,wh,b}``) into the port's
``models/rl_models.py``, whose params are the same nested dicts and lists
of arrays: a leaf-for-leaf copy into f32 tensors.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import sharding as shd
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


def _jax_leaf(name: str, cfg: ModelConfig):
    """(JAX leaf name, index into its stacked leading dims -- a tuple -- or
    None) of the port's parameter ``name``."""
    parts = name.split(".")
    if parts[0] in ("layers", "tail_blocks") or parts[:2] == ["encoder",
                                                                 "blocks"]:
        k = 2 if parts[0] == "encoder" else 1
        i, rest = int(parts[k]), "/".join(parts[k + 1:])
        if parts[0] != "layers":
            return "/".join(parts[:k]) + "/" + rest, (i,)
        _, per_block, _ = superblock_layout(cfg)
        sb, j = divmod(i, per_block)
        if cfg.family == "hybrid":
            return f"blocks/mamba/{rest}", (sb, j)
        if cfg.family == "vlm":
            if j == per_block - 1:
                return f"blocks/cross/{rest}", (sb,)
            return f"blocks/self/{rest}", (sb, j)
        if cfg.alt_local_global:
            return f"blocks/{'local' if j == 0 else 'global'}/{rest}", (sb,)
        return f"blocks/{rest}", (sb,)
    return name.replace(".", "/"), None


def jax_ndim(name: str, ndim: int, cfg: ModelConfig) -> int:
    """The rank of the JAX leaf that holds the port's parameter ``name``
    (of rank ``ndim``): its own plus the stacked superblock dims."""
    idx = _jax_leaf(name, cfg)[1]
    return ndim + (len(idx) if idx is not None else 0)


def jax_leaf_groups(names: Iterable[str], cfg: ModelConfig) -> list:
    """The port's parameters (``names``, in order) grouped by the JAX leaf
    that stacks them: a list of index lists, in order of first appearance.
    JAX's int8 gradient compression keeps one scale a (stacked) leaf."""
    groups: Dict[str, list] = {}
    for i, name in enumerate(names):
        groups.setdefault(_jax_leaf(name, cfg)[0], []).append(i)
    return list(groups.values())


def params_from_jax(np_params: Dict, cfg: ModelConfig, *, device,
                    dtype=torch.float32, requires_grad: bool = False,
                    mesh=None) -> LM:
    """JAX ``init_lm`` params (nested dict of numpy arrays) -> ``LM``.
    Raises if a leaf is missing, unexpected, or of the wrong shape.
    ``mesh``: the model axis whose rank's blocks to keep (default: the
    installed one, if any)."""
    leaves = _flatten(np_params)
    with shd.slicing(cfg, mesh) as slicer:
        lm = LM(cfg, device=device, dtype=dtype)
    targets = {}  # jax leaf name -> list of (name, torch param, index)
    for name, p in lm.named_parameters():
        jax_name, idx = _jax_leaf(name, cfg)
        targets.setdefault(jax_name, []).append((name, p, idx))
    missing = sorted(set(targets) - set(leaves))
    extra = sorted(set(leaves) - set(targets))
    if missing or extra:
        raise ValueError(f"params_from_jax: missing leaves {missing}, "
                         f"unexpected leaves {extra}")
    with torch.no_grad():
        for jax_name, dests in targets.items():
            src = leaves[jax_name]
            lead = _stacked_dims([idx for _, _, idx in dests])
            if tuple(src.shape[:len(lead)]) != lead:
                raise ValueError(f"{jax_name}: leading dims "
                                 f"{src.shape[:len(lead)]} != {lead}")
            for name, p, idx in dests:
                val = src if idx is None else src[idx]
                if slicer is not None:
                    val = slicer.slice(name, val)
                if tuple(val.shape) != tuple(p.shape):
                    raise ValueError(f"{jax_name}: shape {val.shape} != "
                                     f"{tuple(p.shape)}")
                p.copy_(torch.from_numpy(np.array(val)))
    return lm.requires_grad_(requires_grad)


def params_to_jax(named: Iterable[Tuple[str, torch.Tensor]],
                  cfg: ModelConfig, *, specs=None, mesh=None) -> Dict:
    """The inverse of ``params_from_jax``: ``(name, tensor)`` pairs named as
    in ``LM.named_parameters()`` -> JAX's nested dict, each superblock leaf
    stacked over its superblocks (new tensors; the others are the given
    ones, detached).  With ``specs`` ({name: PartitionSpec},
    ``sharding.param_pspecs``) and a model axis ``mesh`` each tensor is a
    rank's block, gathered to its global value first."""
    stacks: Dict[str, dict] = {}
    tree: Dict = {}
    for name, t in named:
        if specs is not None and mesh is not None:
            t = shd.gather_leaf(name, t.detach(), specs[name], mesh)
        jax_name, idx = _jax_leaf(name, cfg)
        if idx is None:
            _set(tree, jax_name, t.detach())
        else:
            stacks.setdefault(jax_name, {})[idx] = t.detach()
    for jax_name, parts in stacks.items():
        lead = _stacked_dims(list(parts))
        stacked = torch.stack([parts[i] for i in sorted(parts)])
        _set(tree, jax_name, stacked.reshape(*lead, *stacked.shape[1:]))
    return tree


def _stacked_dims(indices) -> tuple:
    """The leading dims of a stacked leaf from the indices of its parts
    (every index of the grid present once; () for an unstacked leaf)."""
    if indices[0] is None:
        return ()
    return tuple(max(ix[d] for ix in indices) + 1
                 for d in range(len(indices[0])))


def _set(tree: Dict, path: str, value) -> None:
    *parents, leaf = path.split("/")
    for part in parents:
        tree = tree.setdefault(part, {})
    tree[leaf] = value


def _get(tree: Dict, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def params_of_jax(tree: Dict, names: Iterable[str],
                  cfg: ModelConfig) -> List[torch.Tensor]:
    """The tensors of JAX's nested dict ``tree`` in the order of ``names``
    (``LM.named_parameters()`` names): views of its leaves, a superblock
    leaf indexed at the parameter's superblock."""
    out = []
    for name in names:
        jax_name, idx = _jax_leaf(name, cfg)
        leaf = _get(tree, jax_name)
        out.append(leaf if idx is None else leaf[idx])
    return out


def rl_params_from_jax(np_params, *, device="cpu"):
    """JAX RL-model params (nested dicts / lists of numpy arrays, the layout
    of ``rl_models``' ``init``) -> the same tree of f32 tensors on
    ``device``."""
    return pytree.tree_map(
        lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,
                               device=device), np_params)
