"""The LM mesh's data axis (``launch/train.py --mesh Dx1 [--compress]``,
JAX's ``run_mesh``) on 2 gloo ranks on the CPU, and the execution half of
the sharding rules.

JAX's own 2-D mesh tests fail under JAX 0.9.0 (ROADMAP Queue 3), so the
port is held two ways:

- against JAX function by function: the port's ``make_lm_ppo_train_step``
  under ``cross_replica`` on 2 ranks and JAX's under ``jax.vmap(...,
  axis_name="data")``, 3 steps on the same params (seeded weights in
  JAX's layout) and
  per-rank batches (numpy), uncompressed and ``int8_ef``, smoke gemma2 (2
  layers) and smoke mamba2 on the plain SSD route, f32 compute: every
  metric of every step within 1e-4 relative (+1e-6), the parameters after
  3 Adam steps within 1e-5 + 6 lr everywhere (an Adam step moves a weight
  by about lr, and a gradient within rounding of 0, or an int8 rounding
  on a half, may take the other side) and within 1e-5 on all but 1e-3 of
  the elements, the EF residual within 1e-5 + one int8 step of its leaf
  (where the two sides round a value on a half apart) and within 1e-5 +
  0.01 step on all but 1e-3 of the elements (the gradients' rounding moves
  the quantised value by a small share of a step: measured at most 0.0015
  of it on all but 3 of 88 864 elements of smoke mamba2);
- against the identity (JAX's ``test_mesh2d_parity_uncompressed`` at
  2x1): 2 ranks of 4 rows each == plain Adam on the 8 rows, params within
  1e-4 after 3 steps, the loss within 1e-4;
- the EF telescoping sum (JAX's ``test_mesh2d_ef_cumulative_convergence``):
  with SGD, (p_0 - p_T) / lr == the sum of the pmean'd gradients - the
  ranks' mean residual, within 1e-3 of max(|expected|, 1) a leaf.

And ``train.main`` end to end (rows with JAX's keys, a restore equal to an
unbroken run bit for bit, a group its caller initialized, the error paths),
the rank-local advantage normalisation against JAX's formula on each
slice, and ``constrain`` / ``make_shardings`` / ``install`` /
``install_2d`` against JAX's rules.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_ranks as R  # noqa: E402
from _torch_parity import to_numpy, torch_cfg  # noqa: E402
from repro.algos.pg import gae as jgae  # noqa: E402
from repro.algos.pg.ppo import make_lm_ppo_train_step as jax_ppo_step  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import registry as jax_registry  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import sharding as jshd  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch.algos.pg.ppo import make_lm_ppo_train_step  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import sharding as tshd  # noqa: E402
from repro_torch.models import backbones as tbb  # noqa: E402
from repro_torch.models.convert import (params_from_jax,  # noqa: E402
                                        params_of_jax, params_to_jax)
from repro_torch.train import optim as toptim  # noqa: E402

N = 2          # ranks
LR = 1e-3
ARCHS = ("gemma2-2b", "mamba2-1.3b")
COMPRESS = (None, "int8_ef")


def _cfg(arch):
    return dataclasses.replace(jax_smoke(arch), compute_dtype="float32",
                               n_layers=2)


def _init(jc):
    """Weights for both packages: the port's ``init_lm`` from a seeded
    generator in JAX's layout (JAX's own init runs op by op here, 7 s)."""
    tc = torch_cfg(jc)
    lm = tbb.init_lm(tc, device="cpu", generator=torch.Generator()
                     .manual_seed(0), dtype=torch.float32)
    return jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), params_to_jax(
            lm.named_parameters(), tc))


def _batches(vocab, n_steps, B, T, seed):
    """``n_steps`` LM-PPO batches of N x B rows ({key: (N, B, T)})."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n_steps):
        shape = (N, B, T)
        out.append({
            "tokens": r.randint(0, vocab, shape).astype(np.int32),
            "actions": r.randint(0, vocab, shape).astype(np.int32),
            "logp_old": (-np.abs(r.randn(*shape))).astype(np.float32),
            "advantage": r.randn(*shape).astype(np.float32),
            "return_": r.randn(*shape).astype(np.float32)})
    return out


@pytest.fixture(scope="module")
def mesh_runs():
    """One spawn of 2 ranks for every rank-side case: the JAX parity cases
    (arch x compress), the identity run and the EF run."""
    cases, inputs = {}, {}
    for arch in ARCHS:
        jc = _cfg(arch)
        params = _init(jc)
        batches = _batches(jc.vocab, 3, 2, 8, seed=1)
        inputs[arch] = (jc, params, batches)
        for compress in COMPRESS:
            cases[(arch, compress)] = dict(
                np_params=to_numpy(params), cfg=torch_cfg(jc),
                batches=batches, compress=compress, lr=LR)
    jc, params, _ = inputs["gemma2-2b"]
    ident = _batches(jc.vocab, 1, 4, 16, seed=2)
    cases["identity"] = dict(np_params=to_numpy(params), cfg=torch_cfg(jc),
                             batches=ident * 3, lr=LR)
    cases["ef"] = dict(np_params=to_numpy(params), cfg=torch_cfg(jc),
                       batches=_batches(jc.vocab, 6, 4, 16, seed=3),
                       compress="int8_ef", lr=LR, opt="sgd",
                       instrument=True)
    out = R.run_ranks(R.lm_steps_body, N, cases)
    return inputs, cases, out


def _jax_mesh_steps(jc, params, batches, compress):
    """JAX's step under vmap(axis_name='data') over N ranks, 3 steps."""
    opt = joptim.cross_replica(joptim.adam(LR, grad_clip=1.0), "data",
                               compress=compress, ef_shards=1)
    step = jax.jit(jax.vmap(jax_ppo_step(jc, opt, entropy_coeff=0.003),
                            axis_name="data"))
    pn = jax.tree_util.tree_map(lambda x: jnp.stack([x] * N), params)
    with jax_registry.override("ref"):
        sn = jax.vmap(opt.init)(pn)
        ms = []
        for b in batches:
            pn, sn, m = step(pn, sn, {k: jnp.asarray(v) for k, v in
                                      b.items()})
            ms.append(m)
    return pn, sn, ms


def _rank_tree(tree, r):
    return to_numpy(jax.tree_util.tree_map(lambda x: x[r], tree))


@pytest.mark.parametrize("compress", COMPRESS)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_update_matches_jax_under_vmap(mesh_runs, arch, compress):
    inputs, cases, out = mesh_runs
    jc, params, batches = inputs[arch]
    tc = torch_cfg(jc)
    pn, sn, jms = _jax_mesh_steps(jc, params, batches, compress)
    for r in range(N):
        got = out[r][(arch, compress)]
        names = got["names"]
        for t, (tm, jm) in enumerate(zip(got["metrics"], jms)):
            keys = set(tm) - {"loss_pmean"}
            assert keys == set(jm), (keys, set(jm))
            if compress:
                assert {"compress_err_norm", "grad_norm_shard_max"} <= keys
            for k in keys:
                np.testing.assert_allclose(tm[k], float(jm[k][r]), rtol=1e-4,
                                           atol=1e-6, err_msg=f"{k} step {t}")
        want = params_of_jax(_rank_tree(pn, r), names, tc)
        n_off = n_all = 0
        for name, a, b in zip(names, got["params"], want):
            err = np.abs(a - b)
            assert err.max() <= 1e-5 + 6 * LR, name
            n_off += int((err > 1e-5).sum())
            n_all += err.size
        assert n_off <= 1e-3 * n_all, (n_off, n_all)
        if compress:
            res = jax.tree_util.tree_map(lambda x: x[r, 0], sn.ef.residual)
            want = params_of_jax(to_numpy(res), names, tc)
            n_off = n_all = 0
            for name, a, b in zip(names, got["residual"], want):
                # |residual| <= scale / 2: one int8 step of the leaf is at
                # least twice its largest residual
                quantum = 2 * np.abs(b).max()
                err = np.abs(a - b)
                assert err.max() <= 1e-5 + quantum, name
                n_off += int((err > 1e-5 + 0.01 * quantum).sum())
                n_all += err.size
            assert n_off <= 1e-3 * n_all, (n_off, n_all)


def test_two_ranks_equal_the_global_batch(mesh_runs):
    """JAX's test_mesh2d_parity_uncompressed at 2x1: 2 ranks of 4 rows, 3
    steps of cross_replica Adam == plain Adam on the 8 rows."""
    inputs, cases, out = mesh_runs
    c = cases["identity"]
    lm = params_from_jax(c["np_params"], c["cfg"], device="cpu",
                         dtype=torch.float32, requires_grad=True)
    opt = toptim.adam(LR, grad_clip=1.0)
    step = make_lm_ppo_train_step(c["cfg"], opt, entropy_coeff=0.003)
    state = opt.init(lm.parameters())
    whole = {k: torch.from_numpy(v.reshape((-1,) + v.shape[2:]))
             for k, v in c["batches"][0].items()}
    losses = []
    with R.one_thread():
        for _ in range(3):
            lm, state, m = step(lm, state, whole)
            losses.append(float(m["loss"]))
    ref = [R.t2n(p) for p in lm.parameters()]
    for r in range(N):
        got = out[r]["identity"]
        worst = max(float(np.abs(a - b).max())
                    for a, b in zip(got["params"], ref))
        assert worst <= 1e-4, worst
        np.testing.assert_allclose([m["loss_pmean"] for m in got["metrics"]],
                                   losses, atol=1e-4, rtol=1e-4)
    for a, b in zip(out[0]["identity"]["params"], out[1]["identity"]["params"]):
        np.testing.assert_array_equal(a, b)   # replicated


def test_ef_cumulative_update_telescopes(mesh_runs):
    """JAX's test_mesh2d_ef_cumulative_convergence at 2x1: with SGD, the
    sum of the applied updates is the sum of the pmean'd gradients minus
    the ranks' mean residual."""
    _, _, out = mesh_runs
    got = out[0]["ef"]
    assert got["metrics"][-1]["compress_err_norm"] > 0
    assert got["metrics"][-1]["grad_norm_shard_max"] > 0
    res_norm = math.sqrt(sum(float(np.sum(np.square(r)))
                             for r in got["residual_mean"]))
    assert res_norm > 0   # the quantisation dropped something
    for p0, pt, acc, rm, name in zip(got["p0"], got["params"], got["acc"],
                                     got["residual_mean"], got["names"]):
        applied = (p0 - pt) / LR
        expect = acc - rm
        d = np.abs(applied - expect).max() / max(np.abs(expect).max(), 1.0)
        assert d <= 1e-3, (name, d)
    for a, b in zip(out[0]["ef"]["params"], out[1]["ef"]["params"]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# advantages: normalised over each rank's slice
# ---------------------------------------------------------------------------

def test_rank_local_advantages_match_jax_per_slice():
    """Each rank's ``build_batch`` normalises the advantages over its own
    slice, as JAX's run_mesh does: equal to JAX's GAE + normalisation on
    that slice, and not the global batch's normalisation."""
    r = np.random.RandomState(4)
    T, B = 12, 8
    traj = {"reward": r.randn(T, B).astype(np.float32),
            "value": r.randn(T, B).astype(np.float32),
            "done": r.rand(T, B) < 0.1,
            "tokens": r.randint(0, 50, (T, B)).astype(np.int32),
            "actions": r.randint(0, 50, (T, B)).astype(np.int32),
            "logp": r.randn(T, B).astype(np.float32)}
    v_last = r.randn(B).astype(np.float32)
    half = B // N
    slices = []
    for k in range(N):
        sl = slice(k * half, (k + 1) * half)
        t_traj = {key: torch.from_numpy(np.ascontiguousarray(v[:, sl]))
                  for key, v in traj.items()}
        got = train.build_batch(t_traj, torch.from_numpy(v_last[sl]))
        adv, ret = jgae.gae_associative(
            jnp.asarray(traj["reward"][:, sl]),
            jnp.asarray(traj["value"][:, sl]), jnp.asarray(v_last[sl]),
            jnp.asarray(traj["done"][:, sl]), gamma=0.99, lam=0.95)
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)
        np.testing.assert_allclose(got["advantage"].numpy(),
                                   np.asarray(adv).T, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got["return_"].numpy(),
                                   np.asarray(ret).T, atol=1e-5, rtol=1e-5)
        slices.append(got["advantage"].numpy())
    whole = train.build_batch({k: torch.from_numpy(v)
                               for k, v in traj.items()},
                              torch.from_numpy(v_last))
    assert not np.allclose(np.concatenate(slices), whole["advantage"].numpy(),
                           atol=1e-3)


# ---------------------------------------------------------------------------
# train.main --mesh
# ---------------------------------------------------------------------------

JAX_ROW_KEYS = {"avg_reward", "loss", "entropy", "samples_per_sec",
                "compress_err_norm", "grad_norm_shard_max"}


def test_main_spawns_ranks_and_logs_jax_keys(tmp_path):
    """``train --device cpu --mesh 2x1 --compress``: main spawns 2 ranks;
    rank 0's rows carry JAX's keys (rank 1 logs its own under rank_1)."""
    log = tmp_path / "log"
    assert train.main(["--device", "cpu", "--mesh", "2x1", "--compress",
                       "--steps", "2", "--batch", "4", "--horizon", "8",
                       "--log-dir", str(log)]) is None
    for d in (log, log / "rank_1"):
        rows = [json.loads(x) for x in
                (d / "progress.jsonl").read_text().splitlines()]
        assert [row["step"] for row in rows] == [1, 2]
        for row in rows:
            assert JAX_ROW_KEYS <= set(row), set(row)
            assert all(math.isfinite(row[k]) for k in JAX_ROW_KEYS)
            assert row["compress_err_norm"] > 0


def test_main_joins_its_callers_group_and_restores_bit_for_bit(tmp_path):
    """On ranks whose group the caller initialized, ``train.main`` joins it
    (no spawn) and returns its rank's LM; a run saved at step 2 and resumed
    with --restore equals the unbroken 4-step run bit for bit (the EF
    residual restored a slice a rank)."""
    argv = ["--device", "cpu", "--mesh", "2x1", "--compress", "--batch", "4",
            "--horizon", "8"]
    out = R.run_ranks(R.train_main_restore_body, N, str(tmp_path / "ck"),
                      argv)
    for r, o in enumerate(out):
        assert o["mesh"] == ({"data": 2, "model": 1}, r, True)
        for a, b in zip(o["whole"], o["resumed"]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(out[0]["resumed"], out[1]["resumed"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("argv, error, match", [
    (["--compress"], SystemExit, None),
    (["--mesh", "2x1", "--batch", "5"], SystemExit, "must divide"),
    (["--mesh", "1x0"], ValueError, "n_model"),
])
def test_main_mesh_errors_as_jax(argv, error, match):
    """--compress without --mesh is a parser error, an indivisible --batch
    exits (JAX's messages), and a 'model' axis of no rank raises as JAX's
    ``make_2d_mesh``."""
    with pytest.raises(error) as e:
        train.main(["--device", "cpu"] + argv)
    if match:
        assert match in str(e.value)
    else:
        assert e.value.code == 2


# ---------------------------------------------------------------------------
# the execution half of the sharding rules, install / install_2d
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_rules():
    jshd.set_global_mesh(None)
    tshd.set_global_mesh(None)
    yield
    jshd.set_global_mesh(None)
    tshd.set_global_mesh(None)


def _spec(p):
    """A spec's entries with JAX's equivalent forms made one: a tuple of
    one axis is the axis, an empty tuple None."""
    return tuple(None if e == () else e[0] if isinstance(e, tuple)
                 and len(e) == 1 else e for e in p)


@pytest.mark.parametrize("how", ["install", "install_2d"])
@pytest.mark.parametrize("shape", [(2, 1), (16, 16)])
def test_install_gives_jax_rules(fresh_rules, how, shape):
    jm = jax.sharding.AbstractMesh(shape, ("data", "model"))
    tm = tmesh.make_test_mesh(2, 1) if shape == (2, 1) else \
        tmesh.AbstractMesh(shape, ("data", "model"))
    assert getattr(jmesh, how)(jm) is jm
    assert getattr(tmesh, how)(tm) is tm
    assert tshd.dp_axes() == jshd.dp_axes()
    assert tshd.tp_axis() == jshd.tp_axis()
    assert tshd.tp_size() == jshd.tp_size()
    assert tshd.n_batch_shards() == jshd.n_batch_shards()
    assert _spec(tshd.batch_spec(None)) == _spec(jshd.batch_spec(None))
    assert getattr(tmesh, how)(None) is None
    assert tshd.get_global_mesh() is None


def test_constrain_and_make_shardings(fresh_rules):
    x = torch.zeros(4, 6, 8)
    spec = tshd.P("data", "model", None)
    assert tshd.constrain(x, spec) is x          # no mesh: identity
    assert tshd.make_shardings({"w": spec}) is None
    mesh = tmesh.install_2d(tmesh.make_test_mesh(2))
    assert tshd.constrain(x, spec) is x
    assert tshd.constrain(torch.zeros(3, 6, 8), spec) is not None  # padded
    with pytest.raises(ValueError, match="not on the mesh"):
        tshd.constrain(x, tshd.P("pod", None, None))
    with pytest.raises(ValueError, match="entries"):
        tshd.constrain(torch.zeros(4), spec)
    sh = tshd.make_shardings({"a": spec, "b": [tshd.P(), tshd.P(None)]})
    assert sh["a"].mesh is mesh and sh["a"].spec == spec
    assert [s.spec for s in sh["b"]] == [tshd.P(), tshd.P(None)]
    other = tmesh.AbstractMesh((16, 16), ("data", "model"))
    assert tshd.make_shardings(spec, other).mesh is other


def test_make_2d_mesh_shapes_and_refusals(tmp_path):
    m = tmesh.make_2d_mesh(2, 1, device="cpu")
    assert m.shape == {"data": 2, "model": 1} and m.size == 2
    assert m.axis_names == ("data", "model") and not m.data.distributed
    with pytest.raises(ValueError, match="n_model"):
        tmesh.make_2d_mesh(1, 0, device="cpu")
    # the 'model' axis: one-process views of both axes (JAX's 2 x 2
    # default), and on a world of one rank a 2 x 2 mesh is refused
    m = tmesh.make_test_mesh()
    assert m.shape == {"data": 2, "model": 2} and m.size == 4
    assert m.model.axis == "model" and not m.model.distributed
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="needs 4 ranks"):
            tmesh.make_2d_mesh(2, 2, device="cpu")
        one = tmesh.make_2d_mesh(1, 1, device="cpu")
        assert one.data.distributed and one.lead
    finally:
        dist.destroy_process_group()
