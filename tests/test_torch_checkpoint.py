"""Checkpoints of the PyTorch port against the JAX package, on the CPU: a
round trip of the port's train and replay states (ints come back as ints,
leaves matched by path, on the device asked for); a params tree saved by
JAX's ``save_checkpoint`` restored by the port and one saved by the port
restored by JAX, with identical values; a whole SAC train state crossing
both ways in JAX's layout; ``TrainLoop.drive`` saving at every
``ckpt_interval`` inside a ``checkpoint`` span; on- and off-policy restore
(the mirrors of tests/test_train_loop.py's restore tests, including the
start-iteration regression) and a SAC restore whose replay skips the
warm-up; and ``TBSink``'s bytes against JAX's with the clock and host name
fixed.  Every comparison is exact: a checkpoint copies bytes.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro.models import rl_models as jrl  # noqa: E402
from repro.telemetry import metrics as jmetrics  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.agents import make_categorical_pg_agent  # noqa: E402
from repro_torch.algos import A2C  # noqa: E402
from repro_torch.core.distributions import Categorical  # noqa: E402
from repro_torch.envs import make_env  # noqa: E402
from repro_torch.examples import catch_dqn_variants as catch_example  # noqa: E402
from repro_torch.examples import pendulum_qpg  # noqa: E402
from repro_torch.models.convert import rl_params_from_jax  # noqa: E402
from repro_torch.models.rl_models import make_pg_mlp  # noqa: E402
from repro_torch.runners import OnPolicyRunner  # noqa: E402
from repro_torch.samplers import SerialSampler  # noqa: E402
from repro_torch.telemetry import metrics as tmetrics  # noqa: E402
from repro_torch.telemetry import trace  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train.optim import adam  # noqa: E402
from repro_torch.utils.logger import Logger  # noqa: E402


def _equal(a, b):
    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        if torch.is_tensor(x):
            assert torch.is_tensor(y) and x.dtype == y.dtype
            assert torch.equal(x, y)
        else:
            assert type(x) is type(y) and x == y


def _qpg_runner(tmp, n_iterations, **kw):
    return pendulum_qpg.make_runner(
        "sac", n_iterations, hidden=(8,), n_envs=4, horizon=8,
        replay_capacity=256, batch_size=16, updates_per_collect=2,
        min_replay=64, log_interval=2, logger=Logger(sinks=()),
        ckpt_dir=str(tmp), ckpt_interval=2, **kw)


def test_round_trip_of_train_and_replay_state(tmp_path):
    """A SAC train state (an int step, list-based Adam states with 0-d
    int32 counts, a 0-d log_alpha) and a prioritized replay state (0-d
    int32 cursor / filled, bool leaves) come back equal, with Python ints
    as ints and the int32 counts as int32 tensors; the manifest is JAX's
    format."""
    _, runner, init = _qpg_runner(tmp_path, 2, prioritized=True)
    ts, _, _ = runner.run(0, params=init(torch.Generator().manual_seed(0)),
                          device="cpu")
    rs = runner.replay_state
    path = tckpt.save_checkpoint(str(tmp_path / "rt"), 7, (ts, rs),
                                 extra={"iteration": 7})
    assert path.endswith("step_0000000007.npz")
    assert tckpt.latest_step(str(tmp_path / "rt")) == 7
    like = pytree.tree_map(
        lambda x: torch.zeros_like(x) if torch.is_tensor(x) else 0, (ts, rs))
    (ts2, rs2), manifest = tckpt.restore_checkpoint(str(tmp_path / "rt"), like)
    _equal((ts2, rs2), (ts, rs))
    assert ts2.step == 4 and isinstance(ts2.step, int)
    assert rs2.filled.dtype == torch.int32 and rs2.filled.dim() == 0
    assert ts2.opt_state["critic"].step.dtype == torch.int32
    assert manifest["extra"] == {"iteration": 7} and manifest["step"] == 7
    with open(tmp_path / "rt" / "step_0000000007.json") as f:
        m = json.load(f)
    assert set(m) == {"step", "n_leaves", "mesh_shape", "leaves", "extra"}
    by_path = {leaf["path"]: leaf for leaf in m["leaves"]}
    assert by_path["0/.step"]["dtype"] == "int32"
    assert by_path["1/.filled"]["dtype"] == "int32"
    assert by_path["1/.storage/timeout"]["dtype"] == "bool"
    assert not [f for f in os.listdir(tmp_path / "rt") if "tmp" in f]


def test_restore_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path), {"a": torch.zeros(2)})
    tckpt.save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_checkpoint(str(tmp_path), {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="leaves"):
        tckpt.restore_checkpoint(str(tmp_path), {"a": torch.zeros(2),
                                                 "b": torch.zeros(2)})
    with pytest.raises(KeyError, match="c"):
        tckpt.restore_checkpoint(str(tmp_path), {"c": torch.zeros(2)})
    with pytest.raises(NotImplementedError, match="item 12"):
        tckpt.restore_checkpoint(str(tmp_path), {"a": torch.zeros(2)},
                                 shardings={"a": None})


def _jax_params():
    ka, kc = jax.random.split(jax.random.PRNGKey(0))
    return {"actor": jrl.make_sac_actor(3, 1, (16, 16)).init(ka),
            "critic": jrl.make_q_critic(3, 1, (16, 16)).init(kc),
            "step": jnp.asarray(5, jnp.int32)}


def _reordered(tree):
    """The same tree with every dict's keys in reverse order: JAX sorts
    them, so only a restore that matches by path gets the values right."""
    if isinstance(tree, dict):
        return {k: _reordered(tree[k]) for k in sorted(tree, reverse=True)}
    if isinstance(tree, list):
        return [_reordered(x) for x in tree]
    return tree


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jp = _jax_params()
    jckpt.save_checkpoint(str(tmp_path), 3, jp, extra={"iteration": 3})
    np_tree = jax.tree_util.tree_map(lambda a: np.array(a), jp)
    like = _reordered(pytree.tree_map(
        lambda a: torch.zeros(a.shape, dtype=torch.from_numpy(a).dtype),
        np_tree))
    like["step"] = 0
    got, manifest = tckpt.restore_checkpoint(str(tmp_path), like,
                                             device="cpu")
    assert list(got) == list(like) and got["step"] == 5
    want = rl_params_from_jax({k: v for k, v in np_tree.items()
                               if k != "step"})
    _equal({k: v for k, v in got.items() if k != "step"}, _reordered(want))
    assert manifest["extra"] == {"iteration": 3}


def test_port_checkpoint_restores_in_jax(tmp_path):
    jp = _jax_params()
    np_tree = jax.tree_util.tree_map(lambda a: np.array(a), jp)
    tp = _reordered(rl_params_from_jax({k: v for k, v in np_tree.items()
                                        if k != "step"}))
    tp["step"] = 5
    tckpt.save_checkpoint(str(tmp_path), 9, tp)
    like = jax.tree_util.tree_map(jnp.zeros_like, jp)
    got, manifest = jckpt.restore_checkpoint(str(tmp_path), like)
    assert manifest["step"] == 9
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(path))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def _by_path(flat):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", getattr(
        p, "name", p)))) for p in path): np.asarray(x) for path, x in flat}


def test_sac_train_state_crosses_both_ways_in_jax_layout(tmp_path):
    """Every runner writes JAX's layout: the off-policy runner's SAC
    checkpoint (three Adam states, one over the 0-d log_alpha) restores in
    JAX with each moment at its param's path, and a JAX-saved SAC train
    state of random values restores into the port, moments back as lists in
    the params' leaf order."""
    from repro.algos.qpg.sac import SAC as JSAC
    from repro.train import optim as joptim

    _, runner, init = _qpg_runner(tmp_path / "port", 2)
    ts, _, _ = runner.run(0, params=init(torch.Generator().manual_seed(0)),
                          device="cpu")
    (got, _), _ = tckpt.restore_checkpoint(
        str(tmp_path / "port"), (ts, runner.replay_state))
    _equal(got, ts)
    jalgo = JSAC(jrl.make_sac_actor(3, 1, (8,)).apply,
                 jrl.make_q_critic(3, 1, (8,)).apply,
                 joptim.adam(1e-3, grad_clip=1.0),
                 joptim.adam(1e-3, grad_clip=1.0), act_dim=1)
    ka, kc = jax.random.split(jax.random.PRNGKey(0))
    jts = jalgo.init_train_state(jax.random.PRNGKey(1), {
        "actor": jrl.make_sac_actor(3, 1, (8,)).init(ka),
        "critic": jrl.make_q_critic(3, 1, (8,)).init(kc)})

    def port_flat(t):
        """(path, leaf) of a port train state, each moment at the path of
        the param it belongs to, as JAX lays it out."""
        out = [(path, x.numpy() if torch.is_tensor(x) else x)
               for path, x in pytree.tree_flatten_with_path(t)[0]
               if not (getattr(path[0], "name", None) == "opt_state"
                       and getattr(path[2], "name", None) in ("mu", "nu"))]
        for k, state in t.opt_state.items():
            owner = t.params[k] if k in t.params else t.extra[f"log_{k}"]
            for field in ("mu", "nu"):
                for (p, _), m in zip(pytree.tree_flatten_with_path(owner)[0],
                                     getattr(state, field)):
                    out.append(((pytree.GetAttrKey("opt_state"),
                                 pytree.MappingKey(k),
                                 pytree.GetAttrKey(field)) + tuple(p),
                                m.numpy()))
        return _by_path(out)

    def manifest_paths(ckpt_dir, prefix=""):
        step = tckpt.latest_step(ckpt_dir)
        with open(os.path.join(ckpt_dir, f"step_{step:010d}.json")) as f:
            return sorted(leaf["path"][len(prefix):]
                          for leaf in json.load(f)["leaves"]
                          if leaf["path"].startswith(prefix))

    # the runner's own file holds the train state at JAX's leaf paths
    jckpt.save_checkpoint(str(tmp_path / "jax"), 1, jts)
    assert manifest_paths(str(tmp_path / "port"), "0/") == manifest_paths(
        str(tmp_path / "jax"))
    # port -> JAX, value for value
    tckpt.save_checkpoint(str(tmp_path / "p2j"), 2, ts)
    jgot, _ = jckpt.restore_checkpoint(
        str(tmp_path / "p2j"), jax.tree_util.tree_map(jnp.zeros_like, jts))
    want, have = port_flat(ts), _by_path(
        jax.tree_util.tree_flatten_with_path(jgot)[0])
    assert sorted(want) == sorted(have)
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)

    # JAX -> port, from random values so no two leaves agree by chance
    rng = np.random.default_rng(0)
    jrand = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.integers(1, 9, a.shape).astype(a.dtype)
                              if a.dtype == jnp.int32 else
                              rng.standard_normal(a.shape).astype(a.dtype)),
        jts)
    jckpt.save_checkpoint(str(tmp_path / "j2p"), 3, jrand)
    pgot, _ = tckpt.restore_checkpoint(str(tmp_path / "j2p"), ts)
    want, have = _by_path(jax.tree_util.tree_flatten_with_path(jrand)[0]), \
        port_flat(pgot)
    assert sorted(want) == sorted(have)
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)
    assert isinstance(pgot.opt_state["alpha"].mu, list)


def _a2c_runner(tmp, n_iterations):
    env = make_env("cartpole")
    model = make_pg_mlp(4, 2)
    algo = A2C(model.apply, adam(1e-3), distribution=Categorical(2))
    sampler = SerialSampler(env, make_categorical_pg_agent(model), n_envs=4,
                            horizon=8)
    return OnPolicyRunner(sampler, algo, n_iterations=n_iterations,
                          log_interval=2, logger=Logger(sinks=()),
                          ckpt_dir=str(tmp), ckpt_interval=2)


def test_onpolicy_restore_still_works(tmp_path):
    """The mirror of tests/test_train_loop.py::test_onpolicy_restore_still_
    works: 4 iterations saved every 2; 6 from the restore end at step 6, and
    the restored params are the saved ones."""
    ts1, _, _ = _a2c_runner(tmp_path, 4).run(0, device="cpu")
    assert ts1.step == 4 and tckpt.latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == [
        f"step_{s:010d}.{e}" for s in (2, 4) for e in ("json", "npz")]
    saved, _ = tckpt.restore_checkpoint(str(tmp_path), ts1)
    _equal(saved, ts1)
    ts2, _, _ = _a2c_runner(tmp_path, 6).run(0, restore=True, device="cpu")
    assert ts2.step == 6


def test_offpolicy_restore_honors_start_iter(tmp_path):
    """The mirror of tests/test_train_loop.py::test_offpolicy_restore_honors_
    start_iter: the second runner resumes at iteration 4, so 2 more updates
    (not 4 + 6)."""
    def runner(n):
        _, r = catch_example.make_runner("rainbow", n, replay_capacity=512,
                                         updates_per_collect=1, min_replay=64,
                                         log_interval=2, logger=Logger(sinks=()))
        r.ckpt_dir, r.ckpt_interval = str(tmp_path), 2
        return r

    ts1, _, _ = runner(4).run(0, device="cpu")
    assert ts1.step == 4
    ts2, _, _ = runner(6).run(0, restore=True, device="cpu")
    assert ts2.step == 6


def test_sac_restore_resumes_with_its_replay_and_skips_warmup(tmp_path):
    """Checkpoints are saved at iterations 2 and 4 inside ``checkpoint``
    spans; a second runner restores (train state, replay state) of iteration
    4 bit for bit, skips the warm-up (the restored replay holds min_replay)
    and ends at step 6 x updates_per_collect."""
    tracer = trace.configure(None)
    try:
        _, r1, init = _qpg_runner(tmp_path, 4)
        ts1, _, _ = r1.run(0, params=init(torch.Generator().manual_seed(0)),
                           device="cpu")
        spans = [e["iteration"] for e in tracer.events
                 if e["kind"] == "span" and e["name"] == "checkpoint"]
        assert spans == [2, 4]
    finally:
        trace.configure(None)
    rs1 = r1.replay_state
    (ts_s, rs_s), manifest = tckpt.restore_checkpoint(str(tmp_path),
                                                      (ts1, rs1))
    _equal((ts_s, rs_s), (ts1, rs1))
    assert manifest["extra"] == {"iteration": 4}

    _, r2, init = _qpg_runner(tmp_path, 6)
    ts2, _, _ = r2.run(0, params=init(torch.Generator().manual_seed(1)),
                       restore=True, device="cpu")
    assert ts2.step == 12
    # no warm-up collect: only the two iterations' 2 x 32 transitions added
    assert r2.replay_state.filled == rs1.filled + 2 * 32
    assert r2.replay_state.cursor == (rs1.cursor + 64) % 256


def _tb_bytes(monkeypatch, module, tmp, rows):
    monkeypatch.setattr(module.time, "time", lambda: 1700000000.25)
    monkeypatch.setattr(module.socket, "gethostname", lambda: "host")
    sink = module.TBSink(str(tmp))
    for r in rows:
        sink.write(r)
    sink.close()
    (name,) = os.listdir(tmp)
    with open(os.path.join(tmp, name), "rb") as f:
        return name, f.read()


def test_tb_sink_bytes_match_jax(tmp_path, monkeypatch):
    rows = [{"step": 0, "wall_time": 0.5, "loss": 1.25, "iter": 1,
             "name": "skipped"},
            {"step": 300, "wall_time": 2.0, "loss": -3.5e-4, "alpha": 0.2,
             "avg_return": -1234.5}]
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jname, jbytes = _tb_bytes(monkeypatch, jmetrics, tmp_path / "j", rows)
    tname, tbytes = _tb_bytes(monkeypatch, tmetrics, tmp_path / "t", rows)
    assert tname == jname == "events.out.tfevents.1700000000.host"
    assert tbytes == jbytes and len(tbytes) > 100


def test_registry_accepts_tb(tmp_path):
    reg = tmetrics.MetricsRegistry(str(tmp_path), sinks=("tb",))
    reg.record(10, {"loss": torch.tensor(0.5)})
    reg.close()
    assert [type(s).__name__ for s in reg.sinks] == ["TBSink"]
    assert any(f.startswith("events.out.tfevents.")
               for f in os.listdir(tmp_path))
    with pytest.raises(ValueError, match="unknown sinks"):
        tmetrics.MetricsRegistry(str(tmp_path), sinks=("tensorboard",))
