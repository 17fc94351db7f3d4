"""The port's data-parallel mesh (``launch/mesh.py``: gloo ranks, one
process each) against the JAX package, on the CPU.

Each collective-bearing function of the port runs on N spawned gloo ranks
(``tests/_torch_ranks.py``) and is held against its JAX counterpart under
``jax.vmap(..., axis_name=...)`` on one CPU device, shard i of the vmap
against rank i, on the same seeded numpy inputs: psum / pmean / pmax /
all_gather, ``cross_pod_allreduce``, ``cross_replica`` (None and int8_ef,
one axis and the (pod, data) tuple), ``sentinels.replicate`` and
``TrainLoop._replicate_info``.  End to end, as JAX's own mesh tests
(which fail under this JAX in ``shard_map``; ROADMAP Queue 3), the port is
held against the identity they encode: the A2C loop on 2 and 4 ranks equals
the one-process loop on the same global batch; the compressed A2C run, its
sentinels and its mis-initialisation error; the sharded prioritized DQN
smoke through ``OffPolicyRunner(mesh=)``; and checkpoints saved on N ranks
restored on the same N, on M and whole in one process.

Tolerances:
- exact (bit for bit) where the ranks and the reference add the same terms
  in one order: every 2-rank sum, gathers, maxima, int8 quantization and
  the residuals, the two-stage tuple reduction (2 x 2);
- 4 f32 ulps of the sum of magnitudes for a 4-rank sum (gloo's ring and
  XLA add four terms in other orders), and after Adam steps on such sums
  1e-6 relative + 1e-6 absolute (the second moment 1e-9 absolute); the
  same for the tuple form without compression, whose port pmeans one axis
  after the other where JAX's sums the four terms at once;
- norms (grad norm, shard_grad_norm, ef_err_norm: each framework's
  reduction sums the squares in its own order) 4 ulps relative;
- the A2C identity at JAX's bounds (tests/test_sharded_train.py): params
  within atol 2e-5 / rtol 2e-4, the loss of every iteration within 1e-4.
Every multi-rank call has its own deadline (``_torch_ranks.DEADLINE_S``)
and a collective timeout, so a fault fails in seconds.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.algorithm import OptInfo as JOptInfo  # noqa: E402
from repro.runners.train_loop import TrainLoop as JTrainLoop  # noqa: E402
from repro.telemetry import sentinels as jsent  # noqa: E402
from repro.train import compress as jcompress  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.replay.interface import (DeviceReplay,  # noqa: E402
                                          transition_example)
from repro_torch.runners import TrainLoop  # noqa: E402
from repro_torch.envs import make_env  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402

import _torch_ranks as R  # noqa: E402

F32_ULP = float(np.finfo(np.float32).eps)


def _sum_bound(stacked):
    """4 ulps of the sum of magnitudes over the rank axis."""
    return 4 * F32_ULP * np.sum(np.abs(stacked), axis=0)


def _close(got, want, n, atol4=1e-6):
    """Exact on 2 ranks; on 4, 1e-6 relative + ``atol4``."""
    if n == 2:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol4)


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request):
    n = request.param
    return n, R.run_ranks(R.collectives_body, n, n)


def _vmap(f, n, *args):
    return jax.vmap(f, axis_name="data")(*args)


# ---------------------------------------------------------------------------
# collectives against JAX under vmap
# ---------------------------------------------------------------------------

def test_psum_pmean_pmax_all_gather_match_jax(ranks):
    n, res = ranks
    _, grads = R.inputs_grads(n)
    x = jnp.asarray(np.stack([grads[0][r]["w"] for r in range(n)]))
    want = {
        "psum": _vmap(lambda v: jax.lax.psum(v, "data"), n, x),
        "pmean": _vmap(lambda v: jax.lax.pmean(v, "data"), n, x),
        "pmax": _vmap(lambda v: jax.lax.pmax(v, "data"), n, x),
        "all_gather": _vmap(lambda v: jax.lax.all_gather(
            v, "data", axis=1, tiled=True), n, x)}
    bound = _sum_bound(np.asarray(x))
    for r in range(n):
        for k in ("pmax", "all_gather"):
            np.testing.assert_array_equal(res[r][k], np.asarray(want[k][r]),
                                          err_msg=k)
        for k, scale in (("psum", 1.0), ("pmean", 1.0 / n)):
            if n == 2:
                np.testing.assert_array_equal(res[r][k],
                                              np.asarray(want[k][r]))
            else:
                assert np.all(np.abs(res[r][k] - np.asarray(want[k][r]))
                              <= bound * scale), k


def test_cross_pod_allreduce_matches_jax(ranks):
    """Quantization and the residual exact; the mean of the dequantized
    grads exact on 2 ranks, 4 ulps of the summed magnitudes on 4."""
    n, res = ranks
    _, grads = R.inputs_grads(n)
    keys = sorted(R.PARAM_SHAPES)
    G = {k: jnp.asarray(np.stack([grads[0][r][k] for r in range(n)]))
         for k in keys}
    Rs = {k: jnp.asarray(np.stack([R.residual_of(grads[1][r][k])
                                   for r in range(n)])) for k in keys}
    g, ef = _vmap(lambda a, b: jcompress.cross_pod_allreduce(
        a, jcompress.EFState(b), axis="data"), n, G, Rs)
    for r in range(n):
        tg, tres = res[r]["cross_pod"]
        for i, k in enumerate(keys):
            np.testing.assert_array_equal(tres[i],
                                          np.asarray(ef.residual[k][r]))
            want = np.asarray(g[k][r])
            if n == 2:
                np.testing.assert_array_equal(tg[i], want)
            else:
                deq = np.asarray(G[k]) + np.asarray(Rs[k]) - np.asarray(
                    ef.residual[k])
                assert np.all(np.abs(tg[i] - want)
                              <= _sum_bound(deq) / n + 1e-12), k


def _jax_opt_run(opt, params, grads_steps, n, axes=("data",), shape=None):
    """JAX's optimizer over N_STEPS under vmap (nested for a tuple of
    axes), every shard starting from the same params and state; returns
    (params, [state after each step], [gnorm]) with leading shard dims."""
    shape = shape or (n,)
    state0 = opt.init(params)

    def stack(t):
        return jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(l, shape + jnp.shape(l)), t)

    f = lambda p, s, g: opt.update(g, s, p)
    for ax in reversed(axes):
        f = jax.vmap(f, axis_name=ax)
    P, S = stack(params), stack(state0)
    states, norms = [], []
    for g in grads_steps:
        G = {k: jnp.asarray(np.stack([g[r][k] for r in range(n)]).reshape(
            shape + g[0][k].shape)) for k in g[0]}
        P, S, gn = f(P, S, G)
        states.append(S)
        norms.append(gn)
    return P, states, norms


def _flat_shard(tree, r, shape):
    """Shard r (row-major over ``shape``) of a tree with leading shard
    dims."""
    idx = np.unravel_index(r, shape)
    return jax.tree_util.tree_map(lambda l: np.asarray(l)[idx], tree)


def _norm_close(got, want):
    """A norm: each framework's reduction sums the squares in its own
    order, 4 ulps relative."""
    np.testing.assert_allclose(got, want, rtol=4 * F32_ULP, atol=0)


def _check_opt(got, want, r, n, shape, compress):
    tp, tstates, tnorms = got
    P, states, norms = want
    keys = sorted(R.PARAM_SHAPES)
    jp = _flat_shard(P, r, shape)
    for i, k in enumerate(keys):
        _close(tp[i], jp[k], n)
    for t, (ts, js) in enumerate(zip(tstates, states)):
        js = _flat_shard(js, r, shape)
        _norm_close(np.float32(tnorms[t]), np.asarray(_flat_shard(
            norms[t], r, shape)))
        inner = ts.inner if compress else ts
        jinner = js.inner if compress else js
        assert int(inner.step) == int(jinner.step) == t + 1
        for i, k in enumerate(keys):
            _close(inner.mu[i], jinner.mu[k], n)
            _close(inner.nu[i], jinner.nu[k], n, atol4=1e-9)
        if compress:
            for i, k in enumerate(keys):
                assert ts.ef.residual[i].shape == (1,) + R.PARAM_SHAPES[k]
                _close(ts.ef.residual[i], js.ef.residual[k], n)
            _norm_close(ts.shard_grad_norm, js.shard_grad_norm)
            _norm_close(ts.ef_err_norm, js.ef_err_norm)


@pytest.mark.parametrize("compress", [None, "int8_ef"])
def test_cross_replica_matches_jax(ranks, compress):
    """Three Adam steps through cross_replica over one axis: params, both
    moments, grad norms and (int8_ef) the residual, shard_grad_norm and
    ef_err_norm of every rank against JAX's shard."""
    n, res = ranks
    params, grads = R.inputs_grads(n)
    opt = joptim.cross_replica(joptim.adam(1e-2), "data", compress=compress,
                               ef_shards=1)
    want = _jax_opt_run(opt, {k: jnp.asarray(v) for k, v in params.items()},
                        grads, n)
    for r in range(n):
        _check_opt(res[r][f"cross_replica_{compress}"], want, r, n, (n,),
                   compress)


@pytest.mark.parametrize("ranks", [4], indirect=True)
@pytest.mark.parametrize("compress", [None, "int8_ef"])
def test_cross_replica_over_a_tuple_of_axes_matches_jax(ranks, compress):
    """The tuple form over ('pod', 'data') on 2 x 2 ranks (rank = the
    row-major index, as jax.make_mesh lays devices out).  int8_ef: pmean
    over 'data', then the compressed all-reduce over 'pod'; exact (each
    stage adds two terms).  None: the pmean over both axes (4 terms)."""
    n, res = ranks
    params, grads = R.inputs_grads(n)
    opt = joptim.cross_replica(joptim.adam(1e-2), ("pod", "data"),
                               compress=compress, ef_shards=1)
    want = _jax_opt_run(opt, {k: jnp.asarray(v) for k, v in params.items()},
                        grads, n, axes=("pod", "data"), shape=(2, 2))
    for r in range(n):
        _check_opt(res[r][f"cross_replica_2d_{compress}"], want, r,
                   2 if compress else 4, (2, 2), compress)


def test_replicate_matches_jax(ranks):
    """sentinels.replicate: pmean / pmax / psum field by field as JAX's
    (exact on 2 ranks; 4 ulps of the summed magnitudes on 4)."""
    n, res = ranks
    vals = R.inputs_sentinels(n)
    js = _vmap(lambda s: jsent.replicate(s, "data"), n,
               jsent.Sentinels(**{k: jnp.asarray(v)
                                  for k, v in vals.items()}))
    for r in range(n):
        for k in jsent.Sentinels._fields:
            want = np.asarray(getattr(js, k)[r])
            got = res[r]["replicate"][k]
            assert got.dtype == want.dtype, k
            if n == 2 or k not in ("loss", "loss_sq", "grad_norm",
                                   "param_norm", "update_norm",
                                   "compress_err_norm", "replay_filled",
                                   "replay_priority_mass"):
                np.testing.assert_array_equal(got, want, err_msg=k)
            else:
                assert abs(float(got) - float(want)) <= float(
                    _sum_bound(vals[k])), k


def test_replicate_info_matches_jax(ranks):
    """TrainLoop._replicate_info: scalar leaves pmean, the batch-leading
    td_abs gathers to global width (n x 3) in rank order, bit for bit."""
    n, res = ranks
    vals = R.inputs_info(n)
    info = JOptInfo(loss=jnp.asarray(vals["loss"]),
                    grad_norm=jnp.asarray(vals["grad_norm"]),
                    extra={"q_mean": jnp.asarray(vals["q_mean"]),
                           "td_abs": jnp.asarray(vals["td_abs"])})
    loop = types.SimpleNamespace(axis="data")
    want = _vmap(lambda i: JTrainLoop._replicate_info(loop, i), n, info)
    for r in range(n):
        got = res[r]["replicate_info"]
        assert got["td_abs"].shape == (n * 3,)
        np.testing.assert_array_equal(got["td_abs"],
                                      np.asarray(want.extra["td_abs"][r]))
        for k, w in (("loss", want.loss), ("grad_norm", want.grad_norm),
                     ("q_mean", want.extra["q_mean"])):
            src = vals[k]
            if n == 2:
                np.testing.assert_array_equal(got[k], np.asarray(w[r]))
            else:
                assert abs(float(got[k]) - float(w[r])) <= float(
                    _sum_bound(src)) / n, k


# ---------------------------------------------------------------------------
# the mesh object, the launcher, the loop's checks (one process)
# ---------------------------------------------------------------------------

def test_data_mesh_one_process_view():
    """Without torch.distributed, make_data_mesh is the one-process view of
    n shards: shape as JAX's mesh.shape, collectives refused for n > 1 and
    the identity for n = 1; parse_mesh_arg as JAX's."""
    m = tmesh.make_data_mesh(4, device="cpu")
    assert m.shape["data"] == 4 and m.axis_names == ("data",)
    assert not m.distributed and m.devices == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError, match="process group"):
        m.psum(torch.ones(2))
    one = tmesh.make_data_mesh(device="cpu")
    assert one.size == 1
    x = torch.arange(6.0).reshape(2, 3)
    for f in (one.psum, one.pmean, one.pmax):
        assert torch.equal(f(x), x)
    assert torch.equal(one.all_gather(x, dim=1), x)
    assert torch.equal(one.block(x), x)
    assert tmesh.mesh_devices(m) == {torch.device("cpu")}
    assert tmesh.parse_mesh_arg("") is None
    assert tmesh.parse_mesh_arg("1x1") is None
    assert tmesh.parse_mesh_arg("2X2") == (2, 2)
    assert tmesh.parse_mesh_arg("4,2") == (4, 2)
    for bad in ("2x2x2", "abc"):
        with pytest.raises(ValueError):
            tmesh.parse_mesh_arg(bad)


def test_spawn_ranks_fails_fast_on_a_rank_error():
    """A rank that raises while its peer waits in a collective fails the
    call with the rank's traceback; the peer is killed."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        R.run_ranks(R.failing_body, 2, timeout=60)


def test_spawn_ranks_deadline():
    """A rank that never returns fails the call at the deadline."""
    with pytest.raises(RuntimeError, match="had not returned"):
        R.run_ranks(R.hanging_body, 2, timeout=6)


@dataclasses.dataclass(frozen=True, eq=False)
class _FakeMesh(tmesh.DataMesh):
    """A mesh whose group is a stand-in with the backend given."""
    fake_backend: str = "gloo"

    @property
    def backend(self):
        return self.fake_backend


def _fake_mesh(device="cpu", size=2, backend="gloo"):
    d = torch.device(device)
    return _FakeMesh(axis="data", size=size, index=0, device=d,
                     devices=(d,) * size, group=object(),
                     fake_backend=backend)


def test_train_loop_mesh_checks():
    """JAX's construction checks and messages (train_loop.py:115-131), the
    refusal of fuse=True on the card where the mesh's collectives cannot
    sit in a CUDA graph (gloo ranks sharing a card) and its acceptance
    where they can (NCCL ranks), and the caller's algo left unwrapped."""
    sampler, algo, _ = R.a2c_stack(tmesh.make_data_mesh(2, device="cpu"))
    mesh = _fake_mesh()
    with pytest.raises(ValueError, match="mesh"):
        TrainLoop(sampler, algo, compress="int8_ef")
    with pytest.raises(ValueError, match="local_collect"):
        TrainLoop(object.__new__(type("S", (), {})), algo, mesh=mesh)
    with pytest.raises(ValueError, match="axis"):
        TrainLoop(sampler, algo, mesh=mesh, axis="pod")
    with pytest.raises(ValueError, match="CUDA graph") as err:
        TrainLoop(sampler, algo, mesh=_fake_mesh("cuda"))
    assert "NCCL" in str(err.value) and "gloo" in str(err.value)
    nccl = _fake_mesh("cuda", backend="nccl")
    assert nccl.capturable and not _fake_mesh("cuda").capturable
    assert TrainLoop(sampler, algo, mesh=nccl).fuse
    loop = TrainLoop(sampler, algo, mesh=_fake_mesh("cuda"), fuse=False)
    assert loop.n_shards == 2 and loop.algo is not algo
    assert loop.algo.opt.update._cross_replica_axis == ((loop.mesh,), None)
    assert not hasattr(algo.opt.update, "_cross_replica_axis")
    # idempotent under the same tag
    from repro_torch.train.optim import cross_replica
    assert cross_replica(loop.algo.opt, loop.mesh) is loop.algo.opt
    dqn = R.dqn_runner(tmesh.make_data_mesh(2, device="cpu")).loop
    with pytest.raises(ValueError, match="divisible"):
        TrainLoop(dqn.sampler, dqn.algo, replay=dqn.replay, batch_size=33,
                  mesh=_fake_mesh())


def test_split_actor_learner_with_mesh():
    """split_actor_learner(mesh=): picks from the devices the mesh's ranks
    do not use, and raises when they use every one (on one card, always)."""
    devs = [torch.device("cuda", i) for i in range(4)]
    two = tmesh.DataMesh(axis="data", size=2, devices=tuple(devs[:2]),
                         device=devs[0])
    assert tmesh.split_actor_learner(devs, mesh=two) == (devs[3], devs[2])
    three = tmesh.DataMesh(axis="data", size=3, devices=tuple(devs[:3]),
                           device=devs[0])
    assert tmesh.split_actor_learner(devs, mesh=three) == (devs[3], devs[3])
    one_card = tmesh.DataMesh(axis="data", size=2, device=devs[0],
                              devices=(devs[0], devs[0]))
    with pytest.raises(ValueError, match="every device"):
        tmesh.split_actor_learner(devs[:1], mesh=one_card)


# ---------------------------------------------------------------------------
# the sampler and the replay's views (one process)
# ---------------------------------------------------------------------------

def test_sharded_sampler_one_process_runs_the_shards_in_turn():
    """collect in one process: the global (T, B) batch is the shards'
    batches side by side, each shard run on its block of the state with
    its own generator; the episode stats sum the shards' deltas."""
    from repro_torch.samplers import SerialSampler
    mesh = tmesh.make_data_mesh(2, device="cpu")
    sampler, _, params = R.a2c_stack(mesh, n_envs=4, horizon=12)
    with R.one_thread():
        ss = sampler.init(torch.Generator().manual_seed(1))
        assert len(ss.generator) == 2
        shards = [sampler._slice(ss, s, torch.Generator().manual_seed(
            ss.generator[s].initial_seed())) for s in range(2)]
        for _ in range(2):
            ss, batch = sampler.collect(params, ss)
        assert batch.observation.shape == (12, 4, 4)
        local = SerialSampler(sampler.env, sampler.agent, 2, 12)
        parts, count = [], 0
        for s in range(2):
            st = shards[s]
            for _ in range(2):
                st, b = local.collect(params, st)
            parts.append(b)
            count += int(st.completed_count)
        np.testing.assert_array_equal(
            batch.observation.numpy(),
            torch.cat([p.observation for p in parts], 1).numpy())
        np.testing.assert_array_equal(
            batch.reward.numpy(), torch.cat([p.reward for p in parts],
                                            1).numpy())
        assert int(ss.completed_count) == count > 0
        assert sampler.bootstrap_value(params, ss).shape == (4,)
    with pytest.raises(ValueError, match="ranks"):
        sampler.local_collect(params, ss)
    spec = sampler.state_spec(ss)
    assert spec.obs is mesh and spec.completed_count is None
    assert spec.generator is None


def test_device_replay_sharded_views():
    """init_sharded: the global state (JAX's layout) or a rank's block;
    local_view / merge_view are views, so an insert reaches the block."""
    from repro_torch.samplers.serial import RolloutBatch
    replay = DeviceReplay(64, prioritized=True)
    ex = transition_example(make_env("catch"))
    g = replay.init_sharded(ex, 4)
    assert g.storage["observation"].shape[0] == 64
    assert g.tree.shape == (4, 32)
    blk = replay.init_sharded(ex, 4, index=1)
    assert blk.storage["observation"].shape[0] == 16
    assert blk.tree.shape == (1, 32)
    local = replay.local_view(blk)
    assert local.tree.shape == (32,)
    obs = torch.ones((2, 3) + tuple(ex["observation"].shape))
    z = torch.zeros((2, 3))
    batch = RolloutBatch(observation=obs, prev_action=None, prev_reward=None,
                         action=torch.zeros((2, 3), dtype=torch.int32),
                         reward=z, done=z.bool(), timeout=z.bool(),
                         next_observation=obs, agent_info=None)
    local = replay.insert(local, batch)
    merged = replay.merge_view(local)
    assert merged.tree.data_ptr() == blk.tree.data_ptr()
    assert float(blk.tree[0, 1]) == 6.0 and int(merged.filled) == 6
    spec = DeviceReplay.shard_spec("m")
    assert spec.storage == "m" and spec.tree == "m" and spec.cursor is None
    with pytest.raises(ValueError, match="split"):
        DeviceReplay(60).init_sharded(ex, 8)


def test_checkpoint_shardings_on_one_rank(tmp_path):
    """save / restore with ``shardings`` on a mesh of one rank: the mesh
    shape in the manifest, the prefix matched by path (the EF residual
    under a TrainState), and a many-shard mesh without a group refused."""
    from repro_torch.core.algorithm import TrainState
    from repro_torch.train.optim import adam, cross_replica
    mesh = tmesh.make_data_mesh(device="cpu")
    params = {"w": torch.randn(3, 2), "b": torch.randn(2)}
    opt = cross_replica(adam(1e-3), mesh, compress="int8_ef")
    st = opt.init(list(params.values()))
    st.ef.residual[0].fill_(0.5)
    ts = TrainState(step=3, params=params, opt_state=st)
    loop = types.SimpleNamespace(mesh=mesh, replay=DeviceReplay(8))
    spec = TrainLoop.checkpoint_specs(loop, ts)
    assert spec.opt_state.ef.residual is mesh and spec.params["w"] is None
    tckpt.save_checkpoint(str(tmp_path), 1, ts, shardings=spec)
    like = TrainState(step=0, params={k: torch.zeros_like(v)
                                      for k, v in params.items()},
                      opt_state=opt.init(list(params.values())))
    out, manifest = tckpt.restore_checkpoint(str(tmp_path), like,
                                             shardings=spec)
    assert manifest["mesh_shape"] == [1] and out.step == 3
    assert torch.equal(out.opt_state.ef.residual[0], st.ef.residual[0])
    assert torch.equal(out.params["w"], params["w"])
    paths = {m["path"] for m in manifest["leaves"]}
    assert ".opt_state/.ef/.residual/w" in paths
    with pytest.raises(ValueError, match="process group"):
        tckpt.restore_checkpoint(str(tmp_path), like, shardings={
            "params": tmesh.make_data_mesh(2, device="cpu")})


# ---------------------------------------------------------------------------
# end to end on ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_sharded_a2c_matches_global_batch(n):
    """JAX's test_sharded_fused_matches_global_batch_a2c: 20 A2C iterations
    on n ranks (local collect, local grads, all-reduced mean) equal the
    plain TrainLoop updating on the full batch of the same ShardedSampler
    in one process, params within atol 2e-5 / rtol 2e-4 and every
    iteration's loss within 1e-4; the one algo stays usable unwrapped."""
    ranks = R.run_ranks(R.a2c_body, n)
    with R.one_thread():
        ref = R.a2c_body(tmesh.make_data_mesh(n, device="cpu"))
    for r in ranks:
        assert r["step"] == 20
        for a, b in zip(ref["params"], r["params"]):
            np.testing.assert_allclose(b, a, atol=2e-5, rtol=2e-4)
        np.testing.assert_allclose(r["losses"], ref["losses"], atol=1e-4,
                                   rtol=1e-4)
        assert r["stats"] == ref["stats"]


def test_sharded_a2c_compressed_end_to_end():
    """JAX's test_trainloop_mesh_compress_end_to_end on 4 ranks: 10
    iterations with int8_ef, params finite, the sentinels' compression
    columns > 0, no non-finite param, one residual slice a rank (4 in the
    global leaf); a train state of the unwrapped algo raises naming
    init_train_state."""
    ranks = R.run_ranks(R.a2c_body, 4, 10, "int8_ef", True)
    for r in ranks:
        assert r["step"] == 10
        assert all(np.isfinite(p).all() for p in r["params"])
        row = r["row"]
        assert row["sent_compress_err_norm"] > 0, row
        assert row["sent_grad_norm_shard_max"] > 0, row
        assert row["sent_nonfinite_params"] == 0, row
        assert row["sent_env_steps"] == 10 * 8 * 16
        assert all(s[0] == 1 for s in r["residual_shapes"])
    for a, b in zip(ranks[0]["params"], ranks[3]["params"]):
        np.testing.assert_array_equal(a, b)   # replicated
    msgs = R.run_ranks(R.a2c_misinit_body, 2)
    assert all(m is not None and "init_train_state" in m for m in msgs)


def test_sharded_dqn_and_elastic_checkpoint(tmp_path):
    """JAX's test_dqn_on_sharded_replay_smoke on 4 ranks through
    OffPolicyRunner(mesh=): 4 iterations x 2 updates, finite loss, td_abs
    gathered to the global batch (32,), replicated params; the
    checkpoint of the last iteration (rings gathered, rank 0 writing)
    restores on each rank bit for bit (shardings=), whole in one process
    (the ranks' rings end to end, the trees stacked), and on 2 ranks: the
    replicated train state whole and a data-sharded (8, 4) leaf by block
    (JAX's test_checkpoint_elastic_reshard; the replay's rings have
    shapes of their own on each mesh, as JAX's)."""
    d = str(tmp_path / "ckpt")
    ranks = R.run_ranks(R.dqn_body, 4, d)
    for r in ranks:
        assert r["step"] == 8 and np.isfinite(r["loss"])
        assert r["td_abs_shape"] == (32,)
        assert r["restored_equal"] and r["iteration"] == 4
        assert r["manifest_mesh"] == [4]
        assert r["filled"] == 128 // 4 + 4 * 8 * 8 // 4
    for a, b in zip(ranks[0]["params"], ranks[3]["params"]):
        np.testing.assert_array_equal(a, b)
    # whole in one process: the global layout
    with R.one_thread():
        runner = R.dqn_runner(tmesh.make_data_mesh(4, device="cpu"))
        ex = transition_example(runner.sampler.env)
        like = runner.replay.init_sharded(ex, 4)
        ts = runner.loop.algo.init_train_state(
            None, runner.sampler.agent.init_params(torch.Generator()))
        (_, rs), _ = tckpt.restore_checkpoint(d, (ts, like))
    for k, v in rs.storage.items():
        np.testing.assert_array_equal(v.numpy(), np.concatenate(
            [r["replay"]["storage"][k] for r in ranks]))
    np.testing.assert_array_equal(rs.tree.numpy(), np.concatenate(
        [r["replay"]["tree"] for r in ranks]))
    # elastic: saved on 4 ranks, restored on 2
    for r, e in enumerate(R.run_ranks(R.elastic_body, 2, d)):
        for a, b in zip(ranks[0]["params"], e["params"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            e["x"], np.arange(32.0, dtype=np.float32).reshape(8, 4)[
                4 * r:4 * (r + 1)])
        assert e["saved_mesh"] == [4]


@pytest.mark.parametrize("fuse", [False, True])
def test_sharded_dqn_rerun_repeats_its_draws(fuse):
    """Two runs of one OffPolicyRunner(mesh=) from the same seed give the
    same params and replay bit for bit on every rank, as off the mesh: the
    rank's replay generator is seeded again for the second run's training
    generator, not carried over from the first; fused, it is a leaf of the
    graphs' state, seeded again in place, and the second run's generators
    lend the graphs their state."""
    for first, second in R.run_ranks(R.rerun_body, 2, fuse):
        for key in ("params", "replay"):
            for a, b in zip(first[key], second[key]):
                np.testing.assert_array_equal(a, b)


def test_replicated_checkpoint_on_ranks_rank_0_writes(tmp_path):
    """On a mesh whose checkpoint has no sharded leaf (OnPolicyRunner(mesh=)
    uncompressed) the manifest still records the mesh, and only the mesh's
    rank 0 writes: a leaf that differs per rank comes back as rank 0's."""
    d = str(tmp_path / "ckpt")
    for manifest in R.run_ranks(R.replicated_ckpt_body, 2, d):
        assert manifest["mesh_shape"] == [2]
        assert manifest["extra"]["iteration"] == 2
    out, manifest = tckpt.restore_checkpoint(d + "_x",
                                             {"x": torch.ones(2)})
    assert manifest["mesh_shape"] == [2]
    assert torch.equal(out["x"], torch.zeros(2))
