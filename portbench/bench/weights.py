"""Weights and environment tables made from ``--seed`` on the device.

The benchmark makes every input itself and hands the same tensors to the
program and to the reference.  Matrices are drawn in a few large calls of
one generator on the card, in the dtype each leaf is held in, into one flat
buffer a dtype; each leaf is a view of its buffer, scaled in place.  Leaves
are taken in sorted name order, so the draw does not depend on the order a
model registers them.  One init serves every configuration:

- the token embedding is N(0, 1);
- the projections that write the residual stream (``out_proj``, ``wo``,
  ``wd``) read every dim but the last, and are scaled by
  1/sqrt(fan_in x writes), where ``writes`` counts the residual writes of
  a pass: one a Mamba-2 layer, two a site of a hybrid's shared block
  (GPT-2's rescaling).  A deep random model's stream then stays steady, as
  a trained model's does; with unscaled branches a rounding of the weights
  moves the last layer's logits by several units;
- every other matrix reads its first dim: 1/sqrt(shape[0]);
- ``A_log`` is log(linspace(1, 16)) and ``dt_bias`` puts softplus(dt_bias)
  log-evenly over Mamba's published dt range [0.001, 0.1]; every other
  vector is ones.
"""
from __future__ import annotations

import math

import torch

CHUNK = 1 << 28
RESIDUAL_WRITERS = ("out_proj", "wo", "wd")
A_RANGE = (1.0, 16.0)
DT_RANGE = (1e-3, 1e-1)


def sub_seed(seed: int, stream: int) -> int:
    """A seed for one stream of a run's draws (weights, sampling, ...)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019
            * (stream + 1)) % (1 << 63)


def residual_writes(model: dict) -> int:
    """Writes to the residual stream in one pass: a Mamba-2 layer writes
    once, a site of a hybrid's shared block twice (attention, MLP)."""
    n = model["n_layers"]
    if model["family"] == "hybrid":
        n += 2 * (model["n_layers"] // model["attn_every"])
    return n


def matrix_scale(name: str, shape, writes: int) -> float:
    if name.endswith("tok_embed"):
        return 1.0
    if name.endswith(RESIDUAL_WRITERS):
        return 1.0 / math.sqrt(math.prod(shape[:-1]) * writes)
    return 1.0 / math.sqrt(shape[0])


def vector(name: str, shape, dt, device):
    if name.endswith("A_log"):
        return torch.log(torch.linspace(*A_RANGE, shape[0], dtype=torch.float32,
                                        device=device)).to(dt)
    if name.endswith("dt_bias"):
        # the inverse of softplus at dt spaced log-evenly over DT_RANGE
        d = torch.logspace(math.log10(DT_RANGE[0]), math.log10(DT_RANGE[1]),
                           shape[0], dtype=torch.float32, device=device)
        return (d + torch.log(-torch.expm1(-d))).to(dt)
    return torch.ones(shape, dtype=dt, device=device)


def make_weights(shapes: dict, model: dict, seed: int, device) -> dict:
    """{name: (shape, dtype)} of ``model``'s leaves -> {name: tensor}
    drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 0))
    writes = residual_writes(model)
    names = sorted(shapes)
    out = {}
    for dt in sorted({shapes[n][1] for n in names
                      if len(shapes[n][0]) >= 2}, key=str):
        mats = [n for n in names
                if len(shapes[n][0]) >= 2 and shapes[n][1] == dt]
        total = sum(math.prod(shapes[n][0]) for n in mats)
        flat = torch.empty(total, dtype=dt, device=device)
        for o in range(0, total, CHUNK):
            flat[o:o + CHUNK].normal_(generator=gen)
        o = 0
        for n in mats:
            shape = shapes[n][0]
            k = math.prod(shape)
            out[n] = flat[o:o + k].view(shape).mul_(
                matrix_scale(n, shape, writes))
            o += k
    for n in names:
        shape, dt = shapes[n]
        if len(shape) < 2:
            out[n] = vector(n, shape, dt, device)
    return out


def leaf_shapes(module) -> dict:
    return {n: (tuple(p.shape), p.dtype) for n, p in module.named_parameters()}


def install(module, weights: dict, requires_grad: bool) -> None:
    """Put ``weights`` in place of ``module``'s parameters (no copy)."""
    for mname, mod in module.named_modules():
        for pname in list(mod._parameters):
            full = f"{mname}.{pname}" if mname else pname
            mod._parameters[pname] = torch.nn.Parameter(
                weights[full], requires_grad=requires_grad)


def chain_logp(seed: int, vocab: int, device, block: int = 4096):
    """The token MDP's transition log-probs (V, V) f32: rows of
    log_softmax(z), z ~ N(0, 1), drawn from ``seed`` on the device and
    normalised in place a block of rows at a time."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    chain = torch.empty((vocab, vocab), dtype=torch.float32, device=device)
    flat = chain.view(-1)
    for o in range(0, flat.numel(), CHUNK):
        flat[o:o + CHUNK].normal_(generator=gen)
    for r in range(0, vocab, block):
        rows = chain[r:r + block]
        rows.sub_(torch.logsumexp(rows, dim=1, keepdim=True))
    return chain
