"""DQN and the RL main path of the PyTorch port against the JAX package, on
the CPU: one DQN update (plain, double, dueling + C51) from the same params,
target and batch; the specs of tests/test_algos.py; one ``update_step`` of
the TrainLoop (sample -> batch -> update -> priority update) against JAX's
iteration body on the same replay state and draws; a short port-only
``OffPolicyRunner`` run of the rainbow variant; and the example entry point.

Tolerances (f32 on the CPU; the frameworks sum convolution and matmul
products in other orders):
- loss, td_abs, q_mean: 1e-5 relative + 1e-6 absolute;
- gradients: 1e-4 relative + 1e-6 absolute of the largest entry of the
  leaf (small entries are sums of cancelling terms);
- params after one Adam step: Adam's first step moves p by lr g / (|g| +
  eps), whose sensitivity to g is at most lr / (|g| + eps), so each param
  is held within 2 lr |g_port - g_jax| / (|g_jax| + eps) + 1e-6 |p|.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro.algos import DQN as JDQN  # noqa: E402
from repro.core.batch_spec import make_algo_batch as jmake_algo_batch  # noqa: E402
from repro.models import rl_models as jrl  # noqa: E402
from repro.replay import device as jreplay  # noqa: E402
from repro.train.optim import adam as jadam  # noqa: E402
from repro_torch.agents import make_dqn_agent  # noqa: E402
from repro_torch.algos import DQN  # noqa: E402
from repro_torch.envs import make_env  # noqa: E402
from repro_torch.examples import catch_dqn_variants as example  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.models import rl_models as trl  # noqa: E402
from repro_torch.models.convert import rl_params_from_jax  # noqa: E402
from repro_torch.replay import device as treplay  # noqa: E402
from repro_torch.replay.interface import DeviceReplay  # noqa: E402
from repro_torch.runners import OffPolicyRunner, TrainLoop  # noqa: E402
from repro_torch.samplers import SerialSampler  # noqa: E402
from repro_torch.telemetry import trace  # noqa: E402
from repro_torch.train.optim import adam  # noqa: E402

LR = 5e-4
CONV = dict(img_hw=(10, 5), channels=(16, 32), kernels=(3, 3), strides=(1, 1),
            d_out=128)
SCALAR_TOL = dict(rtol=1e-5, atol=1e-6)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _batch(B, seed):
    rs = np.random.RandomState(seed)
    return {"observation": (rs.rand(B, 10, 5, 1) < 0.2).astype(np.float32),
            "action": rs.randint(0, 3, B).astype(np.int32),
            "return_": rs.choice([-1.0, 0.0, 1.0], B).astype(np.float32),
            "bootstrap": (rs.rand(B) < 0.8).astype(np.float32),
            "next_observation": (rs.rand(B, 10, 5, 1) < 0.2).astype(np.float32),
            "n_used": np.ones(B, np.int32),
            "is_weights": rs.uniform(0.3, 1.0, B).astype(np.float32)}


class _Rows:
    def __init__(self):
        self.rows = []

    def record(self, step, metrics):
        self.rows.append({k: float(v) for k, v in metrics.items()})


VARIANTS = {"plain": dict(double=False, dueling=False, n_atoms=0),
            "double": dict(double=True, dueling=False, n_atoms=0),
            "double_dueling_c51": dict(double=True, dueling=True, n_atoms=21),
            "c51": dict(double=False, dueling=False, n_atoms=21)}


def _algos(v):
    jm = jrl.make_q_conv(1, 3, dueling=v["dueling"], n_atoms=v["n_atoms"], **CONV)
    tm = trl.make_q_conv(1, 3, dueling=v["dueling"], n_atoms=v["n_atoms"], **CONV)
    kw = dict(gamma=0.99, double=v["double"], n_atoms=v["n_atoms"], v_min=-1,
              v_max=1, target_update_interval=100)
    return jm, tm, JDQN(jm.apply, jadam(LR), **kw), DQN(tm.apply, adam(LR), **kw)


def _check_adam_step(tp_new, jp_new, tp_old, tg, jg):
    for p, jpn, p0, g, gj in zip(pytree.tree_leaves(tp_new),
                                 jax.tree_util.tree_leaves(jp_new),
                                 pytree.tree_leaves(tp_old), tg,
                                 jax.tree_util.tree_leaves(jg)):
        gj = np.asarray(gj)
        bound = (2 * LR * np.abs(g.numpy() - gj) / (np.abs(gj) + 1e-8)
                 + 1e-6 * np.abs(p0.numpy()) + 1e-9)
        assert np.all(np.abs(p.numpy() - np.asarray(jpn)) <= bound)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_dqn_update_matches_jax(variant):
    """Same params (target != params), same batch: loss, td_abs, q_mean,
    grads, grad_norm, and the params after one Adam step."""
    jm, tm, jalgo, talgo = _algos(VARIANTS[variant])
    jp = jm.init(jax.random.PRNGKey(1))
    jt = jm.init(jax.random.PRNGKey(2))
    b = _batch(32, seed=4)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}

    (jloss, jaux), jg = jax.jit(jax.value_and_grad(jalgo.loss, has_aux=True))(
        jp, jt, jb)
    tp = rl_params_from_jax(_np(jp))
    tt = rl_params_from_jax(_np(jt))
    tloss, taux, tg = talgo.grads(tp, tt, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), **SCALAR_TOL)
    for k in ("td_abs", "q_mean"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]),
                                   **SCALAR_TOL)
    for g, gj in zip(tg, jax.tree_util.tree_leaves(jg)):
        gj = np.asarray(gj)
        np.testing.assert_allclose(g.numpy(), gj, rtol=1e-4,
                                   atol=1e-6 * max(np.abs(gj).max(), 1.0))

    jts = jalgo.init_train_state(None, jp)._replace(extra={"target": jt})
    jts2, jinfo = jax.jit(jalgo.update)(jts, jb)
    tts = talgo.init_train_state(None, rl_params_from_jax(_np(jp)))
    tts = tts._replace(extra={"target": tt})
    tts2, tinfo = talgo.update(tts, tb)
    assert tts2.step == int(jts2.step) == 1
    np.testing.assert_allclose(float(tinfo.loss), float(jinfo.loss), **SCALAR_TOL)
    np.testing.assert_allclose(float(tinfo.grad_norm), float(jinfo.grad_norm),
                               rtol=1e-5)
    _check_adam_step(tts2.params, jts2.params, tp, tg, jg)


def test_dqn_target_copy_after_the_optimizer_step():
    """The target takes the params at step % interval == 0, after Adam."""
    tm = trl.make_q_mlp(2, 3, hidden=(8,))
    algo = DQN(tm.apply, adam(1e-2), target_update_interval=2)
    ts = algo.init_train_state(None, tm.init(torch.Generator().manual_seed(0)))
    b = {k: torch.from_numpy(v) for k, v in {
        "observation": np.ones((4, 2), np.float32), "action": np.zeros(4, np.int32),
        "return_": np.ones(4, np.float32), "bootstrap": np.ones(4, np.float32),
        "next_observation": np.zeros((4, 2), np.float32),
        "n_used": np.ones(4, np.int32), "is_weights": np.ones(4, np.float32)}.items()}
    t0 = [t.clone() for t in pytree.tree_leaves(ts.extra["target"])]
    ts, _ = algo.update(ts, b)
    assert all(torch.equal(a, c) for a, c in zip(
        pytree.tree_leaves(ts.extra["target"]), t0))
    ts, _ = algo.update(ts, b)
    assert all(torch.equal(a, c) for a, c in zip(
        pytree.tree_leaves(ts.extra["target"]), pytree.tree_leaves(ts.params)))
    assert not all(torch.equal(a, c) for a, c in zip(
        pytree.tree_leaves(ts.params), t0))


def test_dqn_target_handmade():
    """1-step double-DQN target on a fabricated batch (test_algos.py)."""
    model = trl.make_q_mlp(2, 3, hidden=(8,))
    params = model.init(torch.Generator().manual_seed(0))
    algo = DQN(model.apply, adam(1e-3), gamma=0.5, double=True)
    batch = {"observation": torch.ones(4, 2),
             "action": torch.tensor([0, 1, 2, 0]),
             "return_": torch.tensor([1.0, 2.0, 3.0, 4.0]),
             "bootstrap": torch.tensor([1.0, 0.0, 1.0, 1.0]),
             "next_observation": torch.ones(4, 2) * 2,
             "n_used": torch.ones(4, dtype=torch.int32),
             "is_weights": torch.ones(4)}
    loss, _ = algo.loss(params, params, batch)
    q = model.apply(params, batch["observation"]).detach().numpy()
    qa = q[np.arange(4), batch["action"].numpy()]
    qn = model.apply(params, batch["next_observation"]).detach().numpy()
    target = batch["return_"].numpy() + 0.5 * batch["bootstrap"].numpy() * \
        qn[np.arange(4), qn.argmax(-1)]
    td = qa - target
    expect = np.where(np.abs(td) <= 1, 0.5 * td ** 2, np.abs(td) - 0.5).mean()
    np.testing.assert_allclose(float(loss), expect, rtol=1e-5)


def test_c51_projection_probability_mass():
    model = trl.make_q_mlp(2, 3, hidden=(8,), n_atoms=11)
    g = torch.Generator().manual_seed(0)
    params = model.init(g)
    algo = DQN(model.apply, adam(1e-3), n_atoms=11, v_min=-2, v_max=2, gamma=0.9)
    batch = {"observation": torch.randn(6, 2, generator=g),
             "action": torch.zeros(6, dtype=torch.int32),
             "return_": torch.linspace(-3, 3, 6), "bootstrap": torch.ones(6),
             "next_observation": torch.randn(6, 2, generator=g),
             "n_used": torch.ones(6, dtype=torch.int32), "is_weights": torch.ones(6)}
    loss, aux = algo.loss(params, params, batch)
    assert math.isfinite(float(loss)) and float(loss) > 0
    # the projected target is a distribution: its cross-entropy against a
    # uniform log-prob is exactly log(atoms)
    flat = {k: v for k, v in batch.items()}
    uniform = lambda p, o, a=None, r=None: torch.zeros(o.shape[0], 3, 11)  # noqa: E731
    ce = DQN(uniform, adam(1e-3), n_atoms=11, v_min=-2, v_max=2,
             gamma=0.9)._c51_loss(params, params, flat)[1]["td_abs"]
    np.testing.assert_allclose(ce.numpy(), np.full(6, math.log(11)), rtol=1e-5)


def test_dqn_update_moves_toward_target():
    model = trl.make_q_mlp(3, 2, hidden=(16,))
    params = model.init(torch.Generator().manual_seed(0))
    algo = DQN(model.apply, adam(1e-2), gamma=0.0)  # target == return
    ts = algo.init_train_state(None, params)
    batch = {"observation": torch.tensor([[1.0, 0.0, -1.0]]).repeat(8, 1),
             "action": torch.zeros(8, dtype=torch.int32),
             "return_": torch.full((8,), 5.0), "bootstrap": torch.zeros(8),
             "next_observation": torch.zeros(8, 3),
             "n_used": torch.ones(8, dtype=torch.int32), "is_weights": torch.ones(8)}
    for _ in range(200):
        ts, _ = algo.update(ts, batch)
    q = model.apply(ts.params, batch["observation"][:1])
    np.testing.assert_allclose(float(q[0, 0]), 5.0, atol=0.2)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def _rainbow(capacity, B=64):
    v = example.VARIANTS["rainbow"]
    jm, tm, jalgo, talgo = _algos(v)
    env = make_env("catch")
    agent = make_dqn_agent(tm, 3, n_atoms=21, v_min=-1, v_max=1)
    loop = TrainLoop(SerialSampler(env, agent, n_envs=4, horizon=4), talgo,
                     replay=DeviceReplay(capacity, prioritized=True),
                     batch_size=B, updates_per_collect=2)
    return jm, jalgo, loop


@pytest.mark.parametrize("spec", ["sum_tree=ref", "sum_tree=cuda"])
def test_update_step_matches_jax_iteration_body(spec):
    """sample -> make_algo_batch(is_weights) -> DQN update -> priority update
    from the same replay state, params and draws: the same indices, IS
    weights, loss, td_abs, params and tree."""
    cap, B = 256, 64
    jm, jalgo, loop = _rainbow(cap, B)
    rs = np.random.RandomState(5)
    data = {"observation": (rs.rand(200, 10, 5, 1) < 0.2).astype(np.float32),
            "action": rs.randint(0, 3, 200).astype(np.int32),
            "reward": rs.choice([-1.0, 0.0, 1.0], 200).astype(np.float32),
            "done": rs.rand(200) < 0.1, "timeout": np.zeros(200, bool),
            "next_observation": (rs.rand(200, 10, 5, 1) < 0.2).astype(np.float32)}
    pr = (rs.rand(200) * 2 + 0.1).astype(np.float32)
    jex = {k: jnp.zeros(v.shape[1:], v.dtype) for k, v in data.items()}
    tex = {k: torch.zeros(v.shape[1:], dtype=torch.from_numpy(v).dtype)
           for k, v in data.items()}
    jrs = jreplay.insert(jreplay.init_replay(jex, cap),
                         {k: jnp.asarray(v) for k, v in data.items()},
                         jnp.asarray(pr))
    jp = jm.init(jax.random.PRNGKey(0))
    jts = jalgo.init_train_state(None, jp)
    # the body of TrainLoop._iteration's do_update, one key
    k_s, k_u = jax.random.split(jax.random.PRNGKey(9))

    @jax.jit
    def do_update(jts, jrs):
        mb, jidx, jw = jreplay.sample(jrs, k_s, B, beta=0.4)
        jts2, jinfo = jalgo.update(jts, jmake_algo_batch(
            jalgo.batch_spec, mb, {"is_weights": jw}), k_u)
        return jts2, jreplay.update_priorities(jrs, jidx, jinfo.extra["td_abs"]), \
            jinfo, jidx

    jts2, jrs2, jinfo, jidx = do_update(jts, jrs)

    with registry.override(spec):
        trs = treplay.insert(treplay.init_replay(tex, cap),
                             {k: torch.from_numpy(v) for k, v in data.items()},
                             torch.from_numpy(pr))
        tts = loop.algo.init_train_state(None, rl_params_from_jax(_np(jp)))
        u01 = torch.tensor(np.asarray(jax.random.uniform(k_s, (B,))))
        tidx = treplay.sample(trs, None, B, draws=u01)[1]  # what it will draw
        tts2, trs2, tinfo = loop.update_step(tts, trs, None, draws=u01)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(float(tinfo.loss), float(jinfo.loss), **SCALAR_TOL)
    np.testing.assert_allclose(tinfo.extra["td_abs"].numpy(),
                               np.asarray(jinfo.extra["td_abs"]), **SCALAR_TOL)
    # Adam's first step is lr sign(g) wherever |g| >> eps, so the rounding
    # of g moves a param only where |g| is within a few eps of 0
    for p, q in zip(pytree.tree_leaves(tts2.params),
                    jax.tree_util.tree_leaves(jts2.params)):
        np.testing.assert_allclose(p.numpy(), np.asarray(q), rtol=1e-5,
                                   atol=2e-6)
    np.testing.assert_allclose(trs2.tree.numpy(), np.asarray(jrs2.tree),
                               rtol=2e-5)


def test_off_policy_runner_rainbow_short_run():
    """A port-only run of the rainbow variant on the CPU (capacity 1024,
    4 iterations after the warm-up): every logged number finite, the tree's
    priorities moved off the max-priority init, one kernel_dispatch event
    for the tree sample."""
    tracer = trace.configure(None)
    try:
        logger = _Rows()
        sampler, runner = example.make_runner("rainbow", 4, replay_capacity=1024,
                                              log_interval=2, logger=logger)
        ts, ss, info = runner.run(0, device="cpu")
        assert ts.step == 8 and len(logger.rows) == 2
        for row in logger.rows:
            assert all(math.isfinite(v) for v in row.values()), row
        assert runner.replay_state.filled == 1024  # 512 warm-up + 4 x 256
        leaves = runner.replay_state.tree[1024:]
        assert len(torch.unique(leaves)) > 10  # not all at max-priority init
        names = {e["name"] for e in tracer.events if e["kind"] == "kernel_dispatch"}
        assert "sum_tree@replay.tree_sample" in names
        stats = example.greedy_eval(sampler, ts.params, ss, collects=1)
        assert stats["episodes"] > 0 and math.isfinite(stats["avg_return"])
    finally:
        trace.configure(None)


def test_train_loop_refuses_what_is_not_ported():
    """The mesh and compress still raise, naming their ROADMAP item;
    sentinels, the NaN guard, checkpoints and the fused window (the
    default; tests/test_torch_graphs.py) are ported and construct."""
    _, _, loop = _rainbow(64)
    args = (loop.sampler, loop.algo)
    kw = dict(replay=loop.replay, batch_size=8)
    for bad in (dict(mesh=object()), dict(compress="int8")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TrainLoop(*args, **kw, **bad)
    for ok in (dict(sentinels=True), dict(nan_guard=True)):
        assert TrainLoop(*args, **kw, **ok).sentinels_on
    assert TrainLoop(*args, **kw).fuse
    assert not TrainLoop(*args, **kw, fuse=False).fuse
    with pytest.raises(ValueError, match="batch_size"):
        TrainLoop(*args, replay=loop.replay)
    _, runner = example.make_runner("rainbow", 1, replay_capacity=64)
    assert OffPolicyRunner(runner.sampler, runner.algo, replay_capacity=64,
                           batch_size=8, n_iterations=1, ckpt_dir="x",
                           ckpt_interval=1).ckpt_dir == "x"


def test_example_defaults_to_cuda_and_runs_on_cpu(capsys):
    ap = example.build_parser()
    assert ap.get_default("device") == "cuda"
    assert ap.get_default("variant") == "rainbow" and ap.get_default("iters") == 150
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            example.main(["--iters", "1"])
    stats = example.main(["--device", "cpu", "--iters", "1", "--variant", "dqn"])
    assert set(stats) == {"avg_return", "avg_len", "episodes"}
    assert "greedy eval" in capsys.readouterr().out
