"""Dry run: count every (arch x shape x mesh) cell on the meta device.

Counterpart of ``repro/launch/dryrun.py``.  JAX lowers and compiles each
cell's step for a production mesh of 512 forced host devices; the port
runs its own step (the PPO update, the prefill, the decode step) once at
full width and depth on ``launch/specs.py``'s meta tensors, under
``hlo_analysis.op_cost``.  A run that completes is the pass that JAX's
lower + compile gave.  Eager runs every loop iteration, so the count is
exact in depth and microbatches with no extrapolation.

Per cell:
- ``memory.argument_bytes`` / ``output_bytes``: the bytes of the step's
  inputs / outputs that one device holds under ``models/sharding.py``'s
  rules on the production mesh (``launch.mesh.make_production_mesh``).
  ``temp_bytes`` / ``peak_bytes`` are null: the meta device has no
  allocator.
- ``roofline``: per-device FLOPs and bytes are the global count divided by
  ``n_chips``, which assumes an ideal split of the work; H100 constants
  (``launch/mesh.py``).  The count is the reference route's work
  (``hlo_analysis``'s docstring).
- ``collectives_by_kind`` / ``collectives_by_axis`` and
  ``t_collective_s`` (wire bytes over ``LINK_BW``) of a train or prefill
  cell: one rank's step runs once more on meta tensors, on the rank's
  blocks of every leaf the rules split over 'model' and its slice of the
  batch (the global batch over the dp axes), with
  ``launch.mesh.RecordingMesh``es standing for the axes: they record one
  rank's wire bytes and send nothing.  The 'model' axis records the
  layers' f / g all-reduces, the logits' all-gather, the split-use leaves'
  gradient sums and the logical norm (``models/sharding.py``'s execution
  half); a train cell's optimizer is ``cross_replica`` over the dp axes:
  the rank's f32 gradient (``compress=None``), or its int8 payload and one
  scale a JAX (stacked) leaf on the outermost axis
  (``run_cell(compress="int8_ef")``, ``compress.wire_bytes``).  The rank
  runs its batch as one microbatch: the wire bytes of a step do not
  depend on how its rows split into microbatches (the counts do).
  Decode cells: null.
- ``model_flops`` (6 N tokens for train, 2 N tokens for prefill, 2 N a
  sequence for decode, N the active parameters) and ``useful_flops_ratio``
  (model_flops over the counted FLOPs) as in JAX.

Usage:
  python -m repro_torch.launch.dryrun --arch mamba2-1.3b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Callable, List, Optional, Tuple

import torch

from ..algos.pg.ppo import make_lm_ppo_train_step
from ..configs import ARCH_IDS, get_config, resolve, skipped_cells
from ..models import backbones as bb
from ..models import sharding as shd
from ..models.config import SHAPES
from ..models.convert import jax_leaf_groups
from ..train.optim import CrossReplicaState, adam, cross_replica
from . import mesh as mesh_lib
from . import specs as specs_lib
from .hlo_analysis import collective_bytes, op_cost, roofline_terms

COLLECTIVES_SCOPE = (
    "one rank's step: the 'model' axis' f / g all-reduces, logits "
    "all-gather, split-use gradient sums and norm, and (train) the "
    "gradient all-reduce over the dp axes (cross_replica) of the rank's "
    "blocks")

# gradient-accumulation microbatches per arch for train_4k (memory knob)
DEFAULT_MICRO = {
    "llama32_vision_90b": 16,
    "granite_34b": 8,
    "mixtral_8x7b": 8,
    "zamba2_7b": 4,
    "glm4_9b": 4,
    "qwen2_moe_a2p7b": 2,
    "gemma2_2b": 2,
    "phi3_mini_3p8b": 2,
    "mamba2_1p3b": 2,
    "whisper_medium": 2,
}

# archs whose TP-only bf16 weights exceed ~4 GB/chip: FSDP the serving path too
SERVE_FSDP = {"llama32_vision_90b", "granite_34b", "mixtral_8x7b"}


@dataclasses.dataclass
class Step:
    """A cell's step: ``fn(*args)``, and the partition spec of each input
    and output tensor (``in_specs(args)`` / ``out_specs(outputs)`` list
    ``(tensor, PartitionSpec)`` pairs); ``collectives()`` (train and
    prefill cells) returns ``{axis: records}`` of one rank's step on the
    mesh (``rank_collectives``)."""
    fn: Callable
    args: tuple
    in_specs: Callable
    out_specs: Callable
    collectives: Optional[Callable] = None


def _batch_pspec(leaf, dp):
    if leaf.dim() == 0:
        return shd.P()
    return shd.P(dp, *([None] * (leaf.dim() - 1)))


def sharded_bytes(pairs, mesh) -> int:
    """Bytes one device holds of ``(tensor, PartitionSpec)`` pairs (a dim
    that does not divide is padded up, as XLA pads it)."""
    total = 0
    for t, spec in pairs:
        n, k = t.numel() * t.element_size(), shd.shard_count(spec, mesh)
        total += -(-n // k)
    return total


def _param_pairs(params, pspecs):
    return [(p, pspecs[name]) for name, p in params.named_parameters()]


def _data_axes():
    """The installed mesh's dp axes as ``RecordingMesh``es (outermost
    first), or None without a mesh."""
    mesh = shd.get_global_mesh()
    if mesh is None or not shd.dp_axes():
        return None
    return tuple(mesh_lib.RecordingMesh(axis=a, size=mesh.shape[a])
                 for a in shd.dp_axes())


@dataclasses.dataclass(frozen=True, eq=False)
class RankView:
    """One rank's view of a production mesh for ``rank_collectives``: the
    mesh's axes, and a ``RecordingMesh`` standing for its 'model' axis
    (what ``install_2d`` of a ``Mesh2D`` gives the sharding rules)."""
    mesh: Any
    model: Any

    @property
    def shape(self) -> dict:
        return self.mesh.shape

    @property
    def axis_names(self) -> tuple:
        return self.mesh.axis_names


def rank_collectives(cfg, cell, *, compress=None) -> dict:
    """``{axis: records}`` of one rank's train or prefill step on the
    installed production mesh (see the module docstring): its blocks of
    the leaves, its slice of the batch, one microbatch."""
    mesh, dp = shd.get_global_mesh(), shd.dp_axes()
    n_dp = math.prod(mesh.shape[a] for a in dp)
    local = dataclasses.replace(cell, global_batch=max(
        cell.global_batch // n_dp, 1))
    axes = tuple(mesh_lib.RecordingMesh(axis=a, size=mesh.shape[a])
                 for a in dp)
    view = RankView(mesh, mesh_lib.RecordingMesh(axis="model",
                                                 size=mesh.shape["model"]))
    prev = (shd.get_global_mesh(), shd.dp_axes(), shd.tp_axis())
    shd.set_global_mesh(view, dp_axes=(), tp_axis="model")
    try:
        kind = "train" if cell.kind == "train" else "prefill"
        with shd.slicing(cfg):
            params = specs_lib.param_specs(cfg, kind)
        if cell.kind == "train":
            opt = cross_replica(
                adam(1e-4, grad_clip=1.0), axes,
                compress=compress if axes else None,
                ef_shards=axes[0].size if axes else 1,
                scale_groups=jax_leaf_groups(
                    [n for n, _ in params.named_parameters()], cfg),
                model=shd.model_split(params, cfg))
            fn = make_lm_ppo_train_step(
                cfg, opt, img_len=cfg.n_img_tokens if cfg.family == "vlm"
                else 0, enc_len=cfg.enc_len if cfg.family == "encdec" else 0,
                param_pspecs=shd.param_pspecs(params, cfg))
            args = (params, opt.init(list(params.parameters())),
                    specs_lib.train_batch_specs(cfg, local))
        else:
            fn = prefill_fn(cfg)
            kw = specs_lib.prefill_specs(cfg, local)
            args = (params, kw["cache"], kw["tokens"],
                    *[kw[k] for k in ("img", "enc_frames") if k in kw])
        names = ("model",) + tuple(dp)
        with contextlib.ExitStack() as stack:
            records = {a: stack.enter_context(mesh_lib.record_collectives(a))
                       for a in names}
            fn(*args)
        return records
    finally:
        shd.set_global_mesh(prev[0], dp_axes=prev[1], tp_axis=prev[2])


def build_train(cfg, aid, cell, *, n_micro, compress=None) -> Step:
    dp = shd.dp_axes()
    opt = adam(1e-4, grad_clip=1.0)
    params = specs_lib.param_specs(cfg, "train")
    axes = _data_axes()
    if axes is not None:
        opt = cross_replica(
            opt, axes, compress=compress, ef_shards=axes[0].size,
            scale_groups=jax_leaf_groups(
                [n for n, _ in params.named_parameters()], cfg))
    p_pspecs = shd.param_pspecs(params, cfg, fsdp_axes=dp)
    leaf_specs = list(p_pspecs.values())
    train_step = make_lm_ppo_train_step(
        cfg, opt, n_microbatches=n_micro,
        img_len=cfg.n_img_tokens if cfg.family == "vlm" else 0,
        enc_len=cfg.enc_len if cfg.family == "encdec" else 0,
        param_pspecs=p_pspecs)
    opt_state = opt.init(list(params.parameters()))
    batch = specs_lib.train_batch_specs(cfg, cell)

    def state_pairs(params, opt_state):
        extra = []
        if isinstance(opt_state, CrossReplicaState):
            # a rank's residual slice, (1,) + its param's shape
            extra = [(r, shd.P(None, *sp)) for r, sp in
                     zip(opt_state.ef.residual, leaf_specs)] + [
                (opt_state.shard_grad_norm, shd.P()),
                (opt_state.ef_err_norm, shd.P())]
            opt_state = opt_state.inner
        return (_param_pairs(params, p_pspecs) + [(opt_state.step, shd.P())]
                + list(zip(opt_state.mu, leaf_specs))
                + list(zip(opt_state.nu, leaf_specs)) + extra)

    def collectives():
        return rank_collectives(cfg, cell, compress=compress)

    def in_specs(args):
        params, opt_state, batch = args
        return state_pairs(params, opt_state) + [
            (x, _batch_pspec(x, dp)) for x in batch.values()]

    def out_specs(out):
        params, opt_state, metrics = out
        return state_pairs(params, opt_state) + [
            (m, shd.P()) for m in metrics.values()]

    return Step(train_step, (params, opt_state, batch), in_specs, out_specs,
                collectives if axes is not None else None)


def _serve_pairs(cfg, aid, params):
    fsdp = shd.dp_axes() if aid in SERVE_FSDP else None
    return _param_pairs(params, shd.param_pspecs(params, cfg,
                                                 fsdp_axes=fsdp))


def _cache_pairs(cfg, cache):
    specs = bb.cache_pspecs(cfg, cache)
    return [(cache[k], specs[k]) for k in cache]


def build_decode(cfg, aid, cell) -> Step:
    dp = shd.dp_axes()

    @torch.no_grad()
    def serve_step(params, cache, tokens):
        hidden, cache = bb.decode_step(params, cache, tokens, cfg)
        logits = bb.lm_logits(params, hidden, cfg)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), cache

    params = specs_lib.param_specs(cfg, "decode")
    kw = specs_lib.decode_specs(cfg, cell)
    B = cell.global_batch
    ndp = shd.n_batch_shards()
    tok_pspec = shd.P(dp) if B % ndp == 0 and ndp > 1 else shd.P()

    def in_specs(args):
        params, cache, tokens = args
        return (_serve_pairs(cfg, aid, params) + _cache_pairs(cfg, cache)
                + [(tokens, tok_pspec)])

    def out_specs(out):
        tok, cache = out
        return [(tok, tok_pspec)] + _cache_pairs(cfg, cache)

    return Step(serve_step, (params, kw["cache"], kw["tokens"]), in_specs,
                out_specs)


def prefill_fn(cfg):
    """A prefill cell's step: the prompt into the cache, the last token's
    greedy choice."""

    @torch.no_grad()
    def prefill_step(params, cache, tokens, *extra):
        kw = {}
        if cfg.family == "vlm":
            kw["img"] = extra[0]
        if cfg.family == "encdec":
            kw["enc_frames"] = extra[0]
        hidden, cache = bb.prefill(params, tokens, cfg, cache, **kw)
        logits = bb.lm_logits(params, hidden, cfg)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), cache

    return prefill_step


def build_prefill(cfg, aid, cell) -> Step:
    dp = shd.dp_axes()
    prefill_step = prefill_fn(cfg)
    params = specs_lib.param_specs(cfg, "prefill")
    kw = specs_lib.prefill_specs(cfg, cell)
    extra = [kw[k] for k in ("img", "enc_frames") if k in kw]

    def in_specs(args):
        params, cache, *inputs = args
        return (_serve_pairs(cfg, aid, params) + _cache_pairs(cfg, cache)
                + [(x, _batch_pspec(x, dp)) for x in inputs])

    def out_specs(out):
        tok, cache = out
        return [(tok, shd.P(dp))] + _cache_pairs(cfg, cache)

    return Step(prefill_step, (params, kw["cache"], kw["tokens"], *extra),
                in_specs, out_specs, lambda: rank_collectives(cfg, cell))


def build_step(cfg, aid, cell, n_micro, compress=None) -> Step:
    if cell.kind == "train":
        return build_train(cfg, aid, cell, n_micro=n_micro,
                           compress=compress)
    if cell.kind == "prefill":
        return build_prefill(cfg, aid, cell)
    return build_decode(cfg, aid, cell)


def count_step(step: Step) -> Tuple[dict, object, float]:
    """(global cost, outputs, seconds): ``step`` run once under the op
    counter."""
    out = []
    t0 = time.perf_counter()
    cost = op_cost(lambda *a: out.append(step.fn(*a)), *step.args)
    return cost, out[0], time.perf_counter() - t0


def cell_model_flops(cfg, cell) -> int:
    """JAX's ``model_flops``: 6 (train) or 2 (serve) x active parameters x
    tokens.  It counts the embedding and the lm_head at every position,
    where a prefill applies the lm_head to the last one only."""
    tokens = cell.tokens if cell.kind != "decode" else cell.global_batch
    mult = 6 if cell.kind == "train" else 2
    return mult * cfg.n_active_params() * tokens


def run_cell(arch: str, cell, *, multi_pod: bool = False, n_micro=None,
             save_dir=None, verbose=True, cfg=None, mesh=None,
             counted=None, compress=None):
    """One cell on the production mesh (``mesh`` in its place where given,
    ``cfg`` in place of the arch's config).  ``counted``: a list that
    carries the cell's count from one mesh to the next (the count does not
    depend on the mesh: a ``RecordingMesh``'s results are its inputs):
    empty, the step is counted and its ``count_step`` result appended;
    else ``counted[0]`` is reused.  ``compress``: the train cells'
    gradient all-reduce in int8 with error feedback."""
    aid = resolve(arch)
    cfg = cfg or get_config(arch)
    mesh = mesh or mesh_lib.make_production_mesh(multi_pod=multi_pod)
    n_micro = n_micro or DEFAULT_MICRO.get(aid, 2)
    prev = (shd.get_global_mesh(), shd.dp_axes(), shd.tp_axis())
    mesh_lib.install(mesh)
    try:
        step = build_step(cfg, aid, cell, n_micro, compress)
        if counted is None:
            counted = []
        if not counted:
            counted.append(count_step(step))
        cost, out, t_trace = counted[0]
        coll = by_axis = None
        if step.collectives is not None:
            per_axis = step.collectives()
            coll = collective_bytes([r for recs in per_axis.values()
                                     for r in recs])
            by_axis = {a: collective_bytes(recs)["total"]
                       for a, recs in per_axis.items()}
        memory = {
            "argument_bytes": sharded_bytes(step.in_specs(step.args), mesh),
            "output_bytes": sharded_bytes(step.out_specs(out), mesh),
            "temp_bytes": None,
            "peak_bytes": None,
        }
    finally:
        shd.set_global_mesh(prev[0], dp_axes=prev[1], tp_axis=prev[2])

    n_chips = mesh.size
    roof = roofline_terms({"flops": cost["flops"] / n_chips,
                           "bytes accessed": cost["bytes accessed"] / n_chips},
                          coll, n_chips)
    model_flops = cell_model_flops(cfg, cell)
    result = {
        "arch": aid, "shape": cell.name, "kind": cell.kind,
        "mesh": "x".join(map(str, mesh.axis_sizes)), "n_chips": n_chips,
        "n_micro": n_micro if cell.kind == "train" else None,
        "t_trace_s": round(t_trace, 1),
        "memory": memory,
        "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
        "roofline": roof,
        "collectives_by_kind": None if coll is None else {
            k: coll[k] for k in ("all-gather", "all-reduce",
                                 "reduce-scatter", "all-to-all",
                                 "collective-permute")},
        "collectives_by_axis": by_axis,
        "collectives_scope": None if coll is None else (
            f"{COLLECTIVES_SCOPE}; compress={compress}"),
        "model_flops": model_flops,
        "useful_flops_ratio": (model_flops / cost["flops"]
                               if cost["flops"] else None),
    }
    if verbose:
        arg = memory["argument_bytes"] / 2**30
        print(f"[OK] {aid:22s} {cell.name:12s} mesh={result['mesh']:8s} "
              f"trace={t_trace:6.1f}s arg={arg:7.2f}GiB "
              f"bottleneck={roof['bottleneck']:10s} "
              f"t=(c {roof['t_compute_s']:.2e}|m {roof['t_memory_s']:.2e}"
              f"|n {_seconds(roof['t_collective_s'])})s "
              f"useful={result['useful_flops_ratio']:.2f}",
              flush=True)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fn = f"{aid}__{cell.name}__{result['mesh']}.json"
        with open(os.path.join(save_dir, fn), "w") as f:
            json.dump(result, f, indent=1)
    return result


def _seconds(t) -> str:
    return "-" if t is None else f"{t:.2e}"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--micro", type=int, default=None)
    ap.add_argument("--out", default="build/dryrun_results")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if (args.all or not args.arch) else [args.arch]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[
        args.mesh]

    n_ok = n_fail = n_skip = 0
    t0 = time.perf_counter()
    for arch in archs:
        for cell in SHAPES:
            if args.shape and cell.name != args.shape:
                continue
            if cell in skipped_cells(arch):
                print(f"[SKIP] {arch:22s} {cell.name:12s} "
                      f"(long-context inapplicable: full attention)",
                      flush=True)
                n_skip += 1
                continue
            counted = []
            for mp in meshes:
                try:
                    run_cell(arch, cell, multi_pod=mp, n_micro=args.micro,
                             save_dir=args.out, counted=counted)
                    n_ok += 1
                except Exception as e:  # noqa: BLE001 - reported per cell
                    n_fail += 1
                    print(f"[FAIL] {arch} {cell.name} multi_pod={mp}: {e}",
                          flush=True)
                    traceback.print_exc()
    print(f"\ndry-run complete: {n_ok} ok, {n_fail} failed, {n_skip} "
          f"skipped in {time.perf_counter() - t0:.1f} s")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
