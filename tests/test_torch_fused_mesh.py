"""The fused mesh on the CPU: ``TrainLoop(mesh=, fuse=True)`` and the model
axis' rollout step, the bodies that NCCL ranks capture in CUDA graphs
(core/graphs.py, launch/mesh.py).

A CPU has no graphs: there ``StepGraph`` runs every body eagerly, so these
tests pin what a capture needs and what the fused route computes, on gloo
ranks (``tests/_torch_ranks.py``; one spawn of 2 ranks serves them all):

- no host read (``NoHostReads``) in the fused iteration on a mesh of 2
  ranks for A2C with int8 error feedback and sentinels, PPO and
  prioritized DQN, and in the rollout of a model axis of 2 ranks (smoke
  gemma2-2b and mamba2-1.3b): a capture would refuse or freeze one;
- every rank records the same collectives (kind, bytes, group size) in
  the same order, iteration after iteration, fused as unfused: the ranks'
  graphs then agree, as NCCL needs;
- fused equals unfused bit for bit on each rank (state, info, sentinels),
  and the rank's replay generator is a leaf of the graph's state;
- the fused A2C on 2 ranks against JAX's fused single-device window
  (``TrainLoop(fuse=True)._window``) on the global batch, both drawing
  JAX's numbers: what JAX's own ``shard_map`` test
  (tests/test_sharded_train.py::test_sharded_fused_matches_global_batch_a2c,
  which fails under this JAX) means to hold, at its bounds: params within
  atol 2e-5 / rtol 2e-4, every iteration's loss within 1e-4;
- which meshes can be captured (``capturable``) and that ``run_mesh``
  graphs the rollout exactly where the model axis can.

A fused rerun repeating its draws is ``tests/test_torch_mesh.py::
test_sharded_dqn_rerun_repeats_its_draws[True]``; on the card, fused
against unfused on NCCL ranks is ``tests/test_torch_graphs_cuda.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

import _torch_ranks as R  # noqa: E402
from repro import agents as jagents  # noqa: E402
from repro.algos import A2C as JA2C  # noqa: E402
from repro.core.distributions import Categorical as JCategorical  # noqa: E402
from repro.envs import make_env as jmake_env  # noqa: E402
from repro.models import rl_models as jrl  # noqa: E402
from repro.runners import TrainLoop as JTrainLoop  # noqa: E402
from repro.runners.train_loop import split_keys  # noqa: E402
from repro.samplers import SerialSampler as JSerialSampler  # noqa: E402
from repro.train.optim import adam as jadam  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train  # noqa: E402

N_ITERS = 3
ROLLOUT_ARCHS = ("gemma2-2b", "mamba2-1.3b")
DRAWN = {"B": 8, "T": 8, "n": 3}


def _n(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _jax_a2c():
    """JAX's fused window of ``DRAWN["n"]`` A2C iterations on CartPole (8
    envs x 8, Adam 1e-3) and the numbers it drew: the Gumbel noise of each
    step's categorical sample and each env's fresh state."""
    B, T, n = DRAWN["B"], DRAWN["T"], DRAWN["n"]
    jm = jrl.make_pg_mlp(4, 2)
    jsampler = JSerialSampler(jmake_env("cartpole"),
                              jagents.make_categorical_pg_agent(jm), B, T)
    jloop = JTrainLoop(jsampler, JA2C(jm.apply, jadam(1e-3),
                                      distribution=JCategorical(2)),
                       fuse=True)
    jp = jm.init(jax.random.PRNGKey(2))
    jts = jloop.algo.init_train_state(None, jp)
    jss = jsampler.init(jax.random.PRNGKey(3))
    rng, agent, env = jss.rng, [], []
    for _ in range(n * T):
        rng, k_act, k_env = jax.random.split(rng, 3)
        agent.append(np.asarray(jax.random.gumbel(k_act, (B, 2),
                                                  jnp.float32)))
        env.append(np.stack([np.asarray(jax.random.uniform(
            k, (4,), jnp.float32, -0.05, 0.05))
            for k in jax.random.split(k_env, B)]))
    _, keys = split_keys(jax.random.PRNGKey(8), n)
    jts2, _, _, jinfos, _ = jloop._window(jts, jss, None, keys)
    drawn = dict(params=_n(jp), env_state=_n(jss.env_state),
                 obs=np.array(jss.obs), agent_noise=agent, env_noise=env,
                 **DRAWN)
    return drawn, jts2, jinfos


@pytest.fixture(scope="module")
def ranks():
    """One spawn of 2 gloo ranks for every check of this file but the
    construction ones; and JAX's A2C window."""
    drawn, jts2, jinfos = _jax_a2c()
    out = R.run_ranks(R.fused_mesh_body, 2, N_ITERS, ROLLOUT_ARCHS, drawn)
    return out, jts2, jinfos


@pytest.mark.parametrize("name", R.FUSED_MESH_ALGOS)
def test_fused_mesh_iteration_reads_nothing_on_the_host(ranks, name):
    """The fused iterations ran under ``NoHostReads`` on both ranks (a
    host read raises in the rank), all ``N_ITERS`` of them."""
    for r in ranks[0]:
        assert len(r[name]["snaps"][True]) == N_ITERS


@pytest.mark.parametrize("arch", ROLLOUT_ARCHS)
def test_model_axis_rollout_reads_nothing_on_the_host(ranks, arch):
    """The rollout on a model axis of 2 ranks ran under ``NoHostReads``;
    the model group's ranks took the same actions."""
    a, b = (r["rollouts"][arch] for r in ranks[0])
    assert a.shape == (5, 2)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", R.FUSED_MESH_ALGOS)
def test_ranks_record_the_same_collectives_fused_as_unfused(ranks, name):
    """Every rank's (kind, bytes, group size) sequence is the same, the same
    in every iteration, and the same fused as unfused."""
    recs = [r[name]["records"] for r in ranks[0]]
    first = recs[0][False][0]
    assert first
    for rec in recs:
        for fuse in (False, True):
            assert all(it == first for it in rec[fuse]), (fuse, rec[fuse])


@pytest.mark.parametrize("name", R.FUSED_MESH_ALGOS)
def test_fused_mesh_equals_unfused_bit_for_bit(ranks, name):
    """On each rank, after every iteration: the train, sampler and replay
    states, the generators' states, the info and the sentinels; and the
    rank's replay generator is a leaf of the graph's state."""
    for r in ranks[0]:
        res = r[name]
        assert res["shard_leaf"]
        for a, b in zip(res["snaps"][False], res["snaps"][True]):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                if isinstance(x, np.ndarray):
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)
                else:
                    assert x == y


def test_fused_mesh_a2c_matches_jax_fused_window(ranks):
    """Two ranks of 4 envs each, fused, against JAX's fused window on the
    8 envs, on JAX's draws: params within atol 2e-5 / rtol 2e-4, each
    iteration's loss within 1e-4 (tests/test_sharded_train.py's bounds)."""
    out, jts2, jinfos = ranks
    want = jax.tree_util.tree_leaves(jts2.params)
    for r in out:
        d = r["drawn"]
        assert d["step"] == DRAWN["n"]
        for p, q in zip(d["params"], want):
            np.testing.assert_allclose(p, np.asarray(q), atol=2e-5,
                                       rtol=2e-4)
        np.testing.assert_allclose(d["losses"], np.asarray(jinfos.loss),
                                   atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# construction: which meshes a graph can hold
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class _Axis(tmesh.DataMesh):
    """An axis whose group is a stand-in with the backend given."""
    fake_backend: str = "gloo"

    @property
    def backend(self):
        return self.fake_backend


def _axis(name, size, device, backend, group=True):
    d = torch.device(device)
    return _Axis(axis=name, size=size, index=0, device=d,
                 devices=(d,) * size, group=object() if group else None,
                 fake_backend=backend)


def test_capturable_follows_the_backend():
    """NCCL on the card can be captured, gloo cannot; an axis that sends
    nothing (one rank, no process group) can; a 2-D mesh when both axes
    can."""
    assert _axis("data", 2, "cuda", "nccl").capturable
    assert not _axis("data", 2, "cuda", "gloo").capturable
    assert not _axis("data", 2, "cpu", "gloo").capturable
    assert _axis("data", 1, "cuda", "gloo").capturable
    assert _axis("data", 2, "cuda", None, group=False).capturable
    nccl, gloo = _axis("model", 2, "cuda", "nccl"), \
        _axis("model", 2, "cuda", "gloo")
    one = _axis("data", 1, "cuda", "gloo")
    assert tmesh.Mesh2D(data=one, model=nccl).capturable
    assert not tmesh.Mesh2D(data=one, model=gloo).capturable
    assert not tmesh.Mesh2D(data=_axis("data", 2, "cuda", "gloo"),
                            model=nccl).capturable


class _Stop(Exception):
    pass


@pytest.mark.parametrize("backend, graph", [("gloo", False), ("nccl", True)])
def test_run_mesh_graphs_the_rollout_where_the_model_axis_can(
        monkeypatch, capsys, backend, graph):
    """``run_mesh`` at 1 x 2 builds its rollout with ``graph=True`` only
    where the model axis is ``capturable``, and rank 0's first line says
    how it rolls out.  The axes are stand-ins on the CPU whose
    ``capturable`` answers as an NCCL or gloo axis on the card would."""
    monkeypatch.setattr(_Axis, "capturable", property(
        lambda self: self.size == 1 or self.fake_backend == "nccl"))
    mesh = tmesh.Mesh2D(data=_axis("data", 1, "cpu", backend),
                        model=_axis("model", 2, "cpu", backend))
    seen = {}

    def rollout(*args, graph, **kw):
        seen["graph"] = graph
        raise _Stop

    monkeypatch.setattr(train, "make_lm_rollout", rollout)
    monkeypatch.setattr(tmesh, "make_2d_mesh", lambda *a, **kw: mesh)
    args = train.build_parser().parse_args(
        ["--device", "cpu", "--mesh", "1x2", "--batch", "2", "--horizon",
         "4"])
    cfg = train.get_smoke_config("gemma2-2b")
    with pytest.raises(_Stop):
        train.run_mesh(args, cfg, None, None, (1, 2), torch.device("cpu"))
    assert seen["graph"] is graph
    first = capsys.readouterr().out.splitlines()[0]
    assert first.endswith("rollout: eager (CPU)" if graph
                          else "rollout: eager (gloo)"), first
