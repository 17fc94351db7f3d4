"""The port's dry run (``repro_torch/launch/dryrun.py``) and its counter
(``repro_torch/launch/hlo_analysis.py``) against the JAX package's
``repro/launch/{dryrun,hlo_analysis}.py``, on the CPU, at smoke size.

Tolerances:
- ``op_cost`` on meta tensors equals ``op_cost`` on real CPU tensors
  exactly (FLOPs and bytes), for every smoke config's train, prefill and
  decode step;
- a dense smoke config's product FLOPs equal an analytic count exactly
  (the reference attention computes the whole (T, S) score matrix);
- beside JAX's ``xla_cost`` of the same step (the JAX config unrolled, so
  XLA counts every layer), the port's FLOPs lie in a band measured on
  glm4's smoke config: prefill 0.91, train 0.84, decode 0.61 of XLA's
  (the bands below have a margin of about 0.05 each side).  The port
  counts the products only; XLA also counts every elementwise op (masks,
  softmax, norms, RoPE, the optimizer), which weighs most in a decode
  step, whose products are smallest.  Bytes are not compared: eager moves
  the bytes of unfused ops, XLA those of its fused module;
- ``collective_bytes`` equals JAX's HLO parser exactly on synthetic HLO
  lines of each kind, and a 2-rank gloo A2C step records its gradient
  all-reduce at 2(g-1)/g of its payload, which is the gradient's f32
  bytes (``compress.wire_bytes``' ``fp32_bytes``) with and without int8
  error feedback;
- ``run_cell`` writes JAX's result keys (``t_trace_s`` for JAX's
  ``t_lower_s`` / ``t_compile_s``, null where the module docstring says)
  and its ``argument_bytes`` equal, exactly, the bytes computed from JAX's
  ``eval_shape`` specs, ``param_pspecs`` and ``cache_pspecs`` on the
  16x16 production mesh (the serving specs at the port's serving dtypes:
  matrices bf16, norms f32).
"""
import ast
import dataclasses
import json
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_ranks as R  # noqa: E402
from repro.algos.pg.ppo import make_lm_ppo_train_step as jax_train_step  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import backbones as jbb  # noqa: E402
from repro.models import sharding as jshd  # noqa: E402
from repro.train import compress as jcompress  # noqa: E402
from repro.train.optim import OptState as JOptState  # noqa: E402
from repro.train.optim import adam as jax_adam  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.launch import dryrun, hlo_analysis  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import backbones as tbb  # noqa: E402
from repro_torch.models import sharding as tshd  # noqa: E402
from repro_torch.models.config import ShapeCell  # noqa: E402
from repro_torch.train.compress import wire_bytes  # noqa: E402
from repro_torch.train.optim import adam  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SMALL = {"train": ShapeCell("smoke_train", 32, 16, "train"),
         "prefill": ShapeCell("smoke_prefill", 64, 16, "prefill"),
         "decode": ShapeCell("smoke_decode", 64, 16, "decode")}
KINDS = ("train", "prefill", "decode")
F32_LEAVES = ("scale", "A_log", "dt_bias", "norm_scale")
# port FLOPs / XLA FLOPs on glm4's smoke config (measured 0.91 / 0.84 /
# 0.61; the module docstring says why they differ)
XLA_BAND = {"prefill": (0.85, 0.96), "train": (0.78, 0.90),
            "decode": (0.55, 0.67)}


@pytest.fixture(autouse=True)
def no_global_mesh():
    jshd.set_global_mesh(None)
    tshd.set_global_mesh(None)
    yield
    jshd.set_global_mesh(None)
    tshd.set_global_mesh(None)


# ---------------------------------------------------------------------------
# op_cost
# ---------------------------------------------------------------------------

def _fill(t, cfg, gen):
    if t.dtype in (torch.int32, torch.int64):
        return torch.randint(0, cfg.vocab, tuple(t.shape), generator=gen,
                             dtype=t.dtype)
    return (torch.randn(tuple(t.shape), generator=gen) * 0.1).to(t.dtype)


# the op_cost comparisons run the steps on the CPU too: smaller cells
OP_CELLS = {"train": ShapeCell("op_train", 16, 4, "train"),
            "prefill": ShapeCell("op_prefill", 32, 4, "prefill"),
            "decode": ShapeCell("op_decode", 32, 4, "decode")}


def real_args(step, cfg, kind):
    """The step's inputs on the CPU: drawn weights, a fresh cache."""
    gen = torch.Generator().manual_seed(0)
    if kind == "train":
        params = tbb.init_lm(cfg, device="cpu", generator=gen,
                             dtype=torch.float32, requires_grad=True)
        opt_state = adam(1e-4).init(list(params.parameters()))
        batch = {k: _fill(v, cfg, gen) for k, v in step.args[2].items()}
        return params, opt_state, batch
    params = tbb.init_lm(cfg, device="cpu", generator=gen)
    meta_cache = step.args[1]
    B, S = meta_cache["lengths"].shape[0], OP_CELLS[kind].seq_len
    cache = tbb.init_cache(cfg, B, S, device="cpu", img_len=cfg.n_img_tokens,
                           enc_len=cfg.enc_len)
    assert {k: (v.shape, v.dtype) for k, v in cache.items()} == \
        {k: (v.shape, v.dtype) for k, v in meta_cache.items()}
    return (params, cache, *[_fill(x, cfg, gen) for x in step.args[2:]])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_op_cost_same_on_meta_and_cpu(arch, kind):
    cfg = get_smoke_config(arch)
    step = dryrun.build_step(cfg, arch, OP_CELLS[kind], 2)
    args = real_args(step, cfg, kind)
    meta, _, _ = dryrun.count_step(step)
    real = hlo_analysis.op_cost(step.fn, *args)
    assert meta == real
    assert meta["flops"] > 0 and meta["bytes accessed"] > 0


def dense_product_flops(cfg, kind, B, T):
    """2 m n k of every product of a plain dense step: the projections,
    the reference attention's full (T, S) scores and P.V, the MLP and the
    lm_head on the last position."""
    D, H, Hkv, dh, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.d_head, cfg.d_ff)
    Vp = cfg.padded_vocab
    Tq, S = (T, T) if kind == "prefill" else (1, T)
    per_layer = (2 * B * Tq * D * (H + 2 * Hkv) * dh       # q, k, v
                 + 2 * B * Tq * H * dh * D                  # o
                 + 2 * 2 * B * H * Tq * S * dh              # scores, P.V
                 + 3 * 2 * B * Tq * D * F)                  # wi, wg, wd
    return cfg.n_layers * per_layer + 2 * B * D * Vp


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["glm4-9b", "phi3-mini-3.8b"])
def test_dense_product_flops_are_analytic(arch, kind):
    cfg = get_smoke_config(arch)
    cell = SMALL[kind]
    got, _, _ = dryrun.count_step(dryrun.build_step(cfg, arch, cell, 1))
    assert got["flops"] == dense_product_flops(cfg, kind, cell.global_batch,
                                               cell.seq_len)


def jax_step_cost(arch, kind, cell):
    jcfg = dataclasses.replace(jax_smoke(arch), unroll=True)
    p = jspecs.param_specs(jcfg)
    if kind == "train":
        f32 = jax.tree_util.tree_map(
            lambda l: jax.ShapeDtypeStruct(l.shape, jnp.float32), p)
        opt = JOptState(step=jax.ShapeDtypeStruct((), jnp.int32), mu=f32,
                        nu=f32)
        step = jax_train_step(jcfg, jax_adam(1e-4, grad_clip=1.0),
                              n_microbatches=1)
        return jhlo.xla_cost(step, p, opt,
                             jspecs.train_batch_specs(jcfg, cell))
    run = jbb.prefill if kind == "prefill" else jbb.decode_step

    def serve_step(params, cache, tokens):
        if kind == "prefill":
            hidden, cache = run(params, tokens, jcfg, cache)
        else:
            hidden, cache = run(params, cache, tokens, jcfg)
        logits = jbb.lm_logits(params, hidden, jcfg)
        return jnp.argmax(logits[:, -1], axis=-1), cache

    kw = (jspecs.prefill_specs if kind == "prefill" else jspecs.decode_specs)(
        jcfg, cell)
    return jhlo.xla_cost(serve_step, p, kw["cache"], kw["tokens"])


@pytest.mark.parametrize("kind", KINDS)
def test_flops_within_band_of_xla_cost(kind):
    cell = ShapeCell("band", 32 if kind == "train" else 64, 4, kind)
    cfg = get_smoke_config("glm4-9b")
    got, _, _ = dryrun.count_step(dryrun.build_step(cfg, "glm4-9b", cell, 1))
    want = jax_step_cost("glm4-9b", kind, cell)
    lo, hi = XLA_BAND[kind]
    assert lo <= got["flops"] / want["flops"] <= hi, (got, want)


def test_op_cost_refuses_the_kernel_route():
    x = torch.zeros(4, 4)
    with registry.override("cuda"):
        with pytest.raises(ValueError, match="ctypes"):
            hlo_analysis.op_cost(torch.matmul, x, x)
    assert hlo_analysis.op_cost(torch.matmul, x, x)["flops"] == 2 * 4 ** 3


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

HLO = {
    "all-gather": "%ag = bf16[16,1024]{1,0} all-gather(bf16[1,1024]{1,0} %x), "
                  "replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15}}, "
                  "dimensions={0}",
    "all-reduce": "%ar = f32[4096]{0} all-reduce(f32[4096]{0} %g), "
                  "replica_groups=[32,16]<=[512], to_apply=%add",
    "reduce-scatter": "%rs = f32[256,8]{1,0} reduce-scatter(f32[512,8]{1,0} "
                      "%y), replica_groups={{0,1}}, dimensions={0}",
    "all-to-all": "%a2a = bf16[8,64,128]{2,1,0} all-to-all(bf16[8,64,128]"
                  "{2,1,0} %z), replica_groups={{0,1,2,3,4,5,6,7}}",
    "collective-permute": "%cp = s32[1000]{0} collective-permute(s32[1000]{0}"
                          " %w), source_target_pairs={{0,1},{1,0}}",
}
RECORDS = {"all-gather": ("all-gather", 16 * 1024 * 2, 16),
           "all-reduce": ("all-reduce", 4096 * 4, 16),
           "reduce-scatter": ("reduce-scatter", 256 * 8 * 4, 2),
           "all-to-all": ("all-to-all", 8 * 64 * 128 * 2, 8),
           "collective-permute": ("collective-permute", 1000 * 4, 1)}


@pytest.mark.parametrize("kind", list(HLO) + ["all"])
def test_collective_bytes_match_jax_parser(kind):
    kinds = list(HLO) if kind == "all" else [kind]
    want = jhlo.collective_bytes("\n".join("  " + HLO[k] for k in kinds))
    got = hlo_analysis.collective_bytes([RECORDS[k] for k in kinds])
    assert got == want
    assert got["total"] > 0


@pytest.mark.parametrize("compress", [None, "int8_ef"])
def test_a2c_step_records_its_gradient_allreduce(compress):
    out = R.run_ranks(R.a2c_records_body, 2, compress)
    records = out[0]["records"]
    assert records == out[1]["records"]
    assert all(k == "all-reduce" and g == 2 for k, _, g in records)
    n = out[0]["n_elems"]
    payload = wire_bytes([torch.zeros(n)])["fp32_bytes"]
    assert ("all-reduce", payload, 2) in records
    # what the wire carries is the f32 sum of the dequantized gradients,
    # not the int8 payload the compression models
    assert payload == 4 * n != wire_bytes([torch.zeros(n)])["int8_bytes"]
    coll = hlo_analysis.collective_bytes(records)
    assert coll["all-reduce"] == sum(2 * (g - 1) / g * b
                                     for _, b, g in records)
    assert coll["counts"]["all-reduce"] == len(records)
    assert 2 * (2 - 1) / 2 * payload == payload


def test_recorder_sees_all_gather_as_an_allreduce_of_its_buffer():
    mesh = tmesh.make_data_mesh(1, device="cpu")
    with tmesh.record_collectives() as records:
        mesh.psum(torch.ones(3))
        mesh.all_gather(torch.ones(2, 5))
    assert records == []  # a mesh of one rank sends nothing
    for r, out in enumerate(R.run_ranks(R.records_body, 2)):
        # the gather's wire: the zeroed (2 ranks x 2 rows) x 20-byte buffer
        assert out["records"] == [("all-reduce", 12, 2),
                                  ("all-reduce", 2 * 2 * 5 * 4, 2)], r
        assert (out["gathered"][:2] == 0).all()
        assert (out["gathered"][2:] == 1).all()


# ---------------------------------------------------------------------------
# run_cell
# ---------------------------------------------------------------------------

def jax_result_keys():
    """The keys JAX's run_cell writes (``result = {...}`` and
    ``result.update({...})`` in repro/launch/dryrun.py), and its memory
    dict's."""
    tree = ast.parse((REPO / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    keys, memory = set(), set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            name = node.targets[0].id
            ks = {k.value for k in node.value.keys}
            (keys if name == "result" else memory).update(
                ks if name in ("result", "memory") else ())
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "update" and node.args and \
                isinstance(node.args[0], ast.Dict):
            keys.update(k.value for k in node.args[0].keys)
    return keys, memory


def _shards(spec, mesh):
    n = 1
    for ax in spec:
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                n *= mesh.shape[a]
    return n


def _leaf_bytes(shape, itemsize, spec, mesh):
    return -(-math.prod(shape) * itemsize // _shards(spec, mesh))


def jax_argument_bytes(arch, cell, mesh):
    """Per-device bytes of the cell's inputs from JAX's specs and rules."""
    from jax.sharding import PartitionSpec as P
    jcfg = jax_smoke(arch)
    dp = ("data",)
    jshd.set_global_mesh(mesh, dp_axes=dp)
    p = jspecs.param_specs(jcfg)
    total = 0
    if cell.kind == "train":
        pp = jshd.param_pspecs(p, jcfg, fsdp_axes=dp)
        for leaf, spec in zip(jax.tree_util.tree_leaves(p),
                              jax.tree_util.tree_leaves(
                                  pp, is_leaf=lambda x: isinstance(x, P))):
            total += 3 * _leaf_bytes(leaf.shape, 4, spec, mesh)  # w, mu, nu
        total += 4  # the step
        for leaf in jspecs.train_batch_specs(jcfg, cell).values():
            total += _leaf_bytes(leaf.shape, leaf.dtype.itemsize,
                                 P(dp, *[None] * (leaf.ndim - 1)), mesh)
        return total
    fsdp = dp if dryrun.resolve(arch) in dryrun.SERVE_FSDP else None
    pp = jshd.param_pspecs(p, jcfg, fsdp_axes=fsdp)
    for (path, leaf), spec in zip(
            jax.tree_util.tree_leaves_with_path(p),
            jax.tree_util.tree_leaves(pp, is_leaf=lambda x: isinstance(x, P))):
        size = 4 if path[-1].key in F32_LEAVES else 2  # the serving dtypes
        total += _leaf_bytes(leaf.shape, size, spec, mesh)
    kw = (jspecs.prefill_specs if cell.kind == "prefill"
          else jspecs.decode_specs)(jcfg, cell)
    cache = kw.pop("cache")
    cp = jbb.cache_pspecs(jcfg, cache)
    for k, leaf in cache.items():
        total += _leaf_bytes(leaf.shape, leaf.dtype.itemsize, cp[k], mesh)
    for leaf in kw.values():
        spec = P(dp, *[None] * (leaf.ndim - 1))
        if cell.kind == "decode" and cell.global_batch % 16:
            spec = P()
        total += _leaf_bytes(leaf.shape, leaf.dtype.itemsize, spec, mesh)
    return total


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_run_cell_writes_jax_keys_and_argument_bytes(arch, kind, tmp_path):
    cell = SMALL[kind]
    r = dryrun.run_cell(arch, cell, cfg=get_smoke_config(arch), n_micro=2,
                        save_dir=str(tmp_path), verbose=False)
    keys, memory = jax_result_keys()
    assert set(r) == (keys - {"t_lower_s", "t_compile_s"}) | {
        "t_trace_s", "collectives_scope", "collectives_by_axis"}
    assert set(r["memory"]) == memory
    assert r["memory"]["temp_bytes"] is None
    assert r["memory"]["peak_bytes"] is None
    if kind in ("train", "prefill"):
        # one rank's step: the 'model' axis' collectives (the smoke vocab
        # splits over 16), and a train cell's gradient all-reduce over
        # 'data' (test_train_cell_collectives)
        assert set(r["collectives_by_kind"]) == set(
            hlo_analysis._COLLECTIVES)
        assert r["roofline"]["t_collective_s"] > 0
        assert "'model' axis" in r["collectives_scope"]
        assert set(r["collectives_by_axis"]) == {"model", "data"}
        assert r["collectives_by_axis"]["model"] > 0
        assert (r["collectives_by_axis"]["data"] > 0) == (kind == "train")
    else:
        assert r["collectives_by_kind"] is None
        assert r["collectives_by_axis"] is None
        assert r["collectives_scope"] is None
        assert r["roofline"]["t_collective_s"] is None
        assert r["roofline"]["collective_bytes_per_device"] is None
    assert r["mesh"] == "16x16" and r["n_chips"] == 256
    assert r["n_micro"] == (2 if kind == "train" else None)
    saved = json.loads((tmp_path / f"{r['arch']}__{cell.name}__16x16.json")
                       .read_text())
    assert saved == r
    want = jax_argument_bytes(
        arch, cell, jax.sharding.AbstractMesh((16, 16), ("data", "model")))
    assert r["memory"]["argument_bytes"] == want
    assert tshd.get_global_mesh() is None  # run_cell restores the rules


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("compress", [None, "int8_ef"])
def test_train_cell_collectives(compress, multi_pod):
    """A train cell's optimizer is cross_replica over RecordingMeshes of
    the dp axes, on one rank's blocks of the leaves (the 'model' axis of
    16 splits the smoke vocab): uncompressed, each axis all-reduces the
    rank's f32 gradient; compressed, the inner axis does so and the
    outermost sends its int8 payload with one scale a stacked leaf, as
    many as JAX's compress.wire_bytes counts on JAX's param tree, plus the
    two health scalars (4 bytes each).  The 'model' axis' collectives
    (``collectives_by_axis``) come on top, all-reduces and the logits'
    all-gather."""
    arch, cell = "mamba2-1.3b", SMALL["train"]
    cfg = get_smoke_config(arch)
    r = dryrun.run_cell(arch, cell, cfg=cfg, n_micro=2, verbose=False,
                        compress=compress, multi_pod=multi_pod)
    params = list(tspecs.param_specs(cfg, "train").parameters())
    wb = jcompress.wire_bytes(jspecs.param_specs(jax_smoke(arch)))
    assert wb["fp32_bytes"] == 4 * sum(p.numel() for p in params)
    assert wb["int8_bytes"] < wire_bytes(params)["int8_bytes"]  # 2 layers
    n_scales = (wb["int8_bytes"] - wb["fp32_bytes"] // 4) // 4
    with tshd.slicing(cfg, tmesh.RecordingMesh(axis="model", size=16)):
        local = sum(p.numel() for p in
                    tspecs.param_specs(cfg, "train").parameters())
    assert local < wb["fp32_bytes"] // 4     # the vocab split over 16
    sizes = (2, 16) if multi_pod else (16,)
    ring = [2 * (g - 1) / g for g in sizes]   # all-reduce wire factor
    if compress is None:
        want = sum(f * 4 * local for f in ring)
    else:
        want = ring[0] * (local + 4 * n_scales + 2 * 4) + sum(
            f * 4 * local for f in ring[1:])
    by_axis = r["collectives_by_axis"]
    dp = ("pod", "data") if multi_pod else ("data",)
    assert set(by_axis) == {"model", *dp}
    assert sum(by_axis[a] for a in dp) == pytest.approx(want, rel=1e-12)
    assert by_axis["model"] > 0
    coll = r["collectives_by_kind"]
    total = sum(by_axis.values())
    assert coll["all-reduce"] + coll["all-gather"] == \
        pytest.approx(total, rel=1e-12)
    assert r["roofline"]["collective_bytes_per_device"] == \
        pytest.approx(total, rel=1e-12)
    assert r["roofline"]["t_collective_s"] == pytest.approx(
        total / tmesh.LINK_BW, rel=1e-12)
    assert r["collectives_scope"].endswith(f"compress={compress}")


def test_recording_mesh_sends_nothing():
    """RecordingMesh: records one all-reduce a dtype, returns its inputs
    (pmean undivided: the values of a meta count do not matter), and the
    int8 psum records one byte an element and four a scale."""
    m = tmesh.RecordingMesh(axis="data", size=4)
    x, y = torch.ones(3), torch.ones(2, dtype=torch.int32)
    with tmesh.record_collectives() as records:
        out = m.pmean_all([x, y])
        m.psum_all_([torch.ones(5), torch.ones(7)], int8_scales=2)
    assert out[0] is x and out[1] is y
    assert records == [("all-reduce", 12, 4), ("all-reduce", 8, 4),
                       ("all-reduce", 5 + 4 + 7 + 4, 4)]
