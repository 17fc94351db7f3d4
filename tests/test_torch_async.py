"""The asynchronous runner of the PyTorch port and what it runs, on the CPU:
V-trace, its advantage and the GAE inversion against the JAX package (and
V-trace equal to GAE on-policy); the alternating sampler's layout,
interleaving and ``full_agent_state`` against two serial half-samplers;
``split_actor_learner``; and ``AsyncRunner`` / ``AsyncR2D1Runner`` — the
staleness-0 identity with the synchronous loop, the replay-ratio throttle,
the publication cadence and staleness (the mirrors of
tests/test_async_rl.py's assertions), the published snapshot left
bit-unchanged by an in-place learner step, the stored recurrent state
taken before each collect, the threaded schedule's telemetry and its
re-raise of an actor error, restore with and without the replay sidecar, a
JAX-written R2D1 checkpoint and sidecar restored into the port, and both
example twins on ``--device cpu``.

Tolerances: V-trace and GAE series 1e-5 relative + 1e-5 absolute against
JAX on the same f32 inputs (1e-4 against the f64 loop of
tests/test_async_rl.py); the staleness-0 identity 1e-4 on every param
(JAX's bound); samplers, snapshots, stored states, restores and sidecars
exact.  Every threaded run is a few iterations and joins its threads with
a timeout.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro import agents as jagents  # noqa: E402
from repro.algos import R2D1 as JR2D1  # noqa: E402
from repro.envs import make_env as jmake_env  # noqa: E402
from repro.models import rl_models as jrl  # noqa: E402
from repro.replay import host as jhost  # noqa: E402
from repro.runners import AsyncR2D1Runner as JAsyncR2D1Runner  # noqa: E402
from repro.samplers import SerialSampler as JSerialSampler  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train import vtrace as jvt  # noqa: E402
from repro_torch.agents import (make_categorical_pg_agent, make_dqn_agent,  # noqa: E402
                                make_r2d1_agent)
from repro_torch.algos import A2C, DQN, R2D1  # noqa: E402
from repro_torch.algos.pg.gae import gae_scan  # noqa: E402
from repro_torch.core.distributions import Categorical  # noqa: E402
from repro_torch.envs import make_env  # noqa: E402
from repro_torch.examples import mujoco_style_sac, r2d1_recurrent  # noqa: E402
from repro_torch.launch.mesh import DataMesh, split_actor_learner  # noqa: E402
from repro_torch.models.rl_models import (make_pg_mlp, make_q_mlp,  # noqa: E402
                                          make_recurrent_q)
from repro_torch.replay import host as thost  # noqa: E402
from repro_torch.replay.host import TransitionSamples, UniformReplayBuffer  # noqa: E402
from repro_torch.runners import AsyncR2D1Runner, AsyncRunner, TrainLoop  # noqa: E402
from repro_torch.samplers import AlternatingSampler, SerialSampler  # noqa: E402
from repro_torch.samplers.eval import fold_seed  # noqa: E402
from repro_torch.train import vtrace as vt  # noqa: E402
from repro_torch.train.checkpoint import latest_step  # noqa: E402
from repro_torch.train.optim import adam  # noqa: E402
from repro_torch.utils.logger import Logger  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _quiet(log_dir=None):
    """No console rows; progress.jsonl in ``log_dir`` when given."""
    return Logger(log_dir, sinks=("jsonl",) if log_dir else ())


def _clone(tree):
    return pytree.tree_map(lambda p: p.detach().clone(), tree)


# ---------------------------------------------------------------------------
# V-trace
# ---------------------------------------------------------------------------

def _vtrace_reference(mu_logp, pi_logp, r, v, boot, done, gamma, lam,
                      rho_bar, c_bar):
    """Plain numpy loop transcribing the IMPALA recursion (f64), as in
    tests/test_async_rl.py."""
    T, B = r.shape
    ratio = np.exp(pi_logp - mu_logp)
    rho = np.minimum(ratio, rho_bar)
    c = lam * np.minimum(ratio, c_bar)
    nd = 1.0 - done.astype(np.float64)
    v_next = np.concatenate([v[1:], boot[None]], 0)
    vs = np.zeros((T, B))
    acc = np.zeros(B)
    for t in reversed(range(T)):
        delta = rho[t] * (r[t] + gamma * v_next[t] * nd[t] - v[t])
        acc = delta + gamma * c[t] * nd[t] * acc
        vs[t] = v[t] + acc
    vs_next = np.concatenate([vs[1:], boot[None]], 0)
    return vs, rho * (r + gamma * vs_next * nd - v)


def _stale_batch(seed=0, T=7, B=3):
    rng = np.random.default_rng(seed)
    mu_logp = rng.normal(-1.2, 0.4, (T, B))
    pi_logp = mu_logp + rng.normal(0.0, 0.5, (T, B))  # genuinely off-policy
    r = rng.normal(0, 1, (T, B))
    v = rng.normal(0, 1, (T, B))
    boot = rng.normal(0, 1, B)
    done = rng.random((T, B)) < 0.2
    return mu_logp, pi_logp, r, v, boot, done


def _f32(*xs):
    return [np.asarray(x, np.float32) for x in xs]


@pytest.mark.parametrize("rho_bar,c_bar,lam", [(1.0, 1.0, 1.0),
                                               (1.0, 1.0, 0.9),
                                               (0.8, 0.7, 0.95)])
def test_vtrace_matches_jax_on_a_stale_batch(rho_bar, c_bar, lam):
    mu, pi, r, v, boot, done = _stale_batch()
    kw = dict(gamma=0.97, lam=lam, rho_bar=rho_bar, c_bar=c_bar)
    args = _f32(mu, pi, r, v, boot)
    tvs, tpg = vt.vtrace(*map(torch.from_numpy, args),
                         torch.from_numpy(done), **kw)
    jvs, jpg = jvt.vtrace(*map(jnp.asarray, args), jnp.asarray(done), **kw)
    np.testing.assert_allclose(tvs.numpy(), np.asarray(jvs), **TOL)
    np.testing.assert_allclose(tpg.numpy(), np.asarray(jpg), **TOL)
    rvs, rpg = _vtrace_reference(mu, pi, r, v, boot, done, 0.97, lam,
                                 rho_bar, c_bar)
    np.testing.assert_allclose(tvs.numpy(), rvs, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tpg.numpy(), rpg, rtol=1e-4, atol=1e-4)
    tadv = vt.vtrace_advantage(*map(torch.from_numpy, args),
                               torch.from_numpy(done), **kw)
    jadv = jvt.vtrace_advantage(*map(jnp.asarray, args), jnp.asarray(done),
                                **kw)
    np.testing.assert_allclose(tadv.numpy(), np.asarray(jadv), **TOL)


def test_vtrace_reduces_to_gae_on_policy():
    """At pi == mu and rho_bar = c_bar = 1, vs - v is GAE(lam)."""
    mu, _, r, v, boot, done = _stale_batch(seed=3)
    mu, r, v, boot = map(torch.from_numpy, _f32(mu, r, v, boot))
    done = torch.from_numpy(done)
    for lam in (1.0, 0.9):
        adv = vt.vtrace_advantage(mu, mu, r, v, boot, done, gamma=0.98,
                                  lam=lam)
        gae_adv, _ = gae_scan(r, v, boot, done, gamma=0.98, lam=lam)
        np.testing.assert_allclose(adv.numpy(), gae_adv.numpy(), **TOL)
    vs, pg = vt.vtrace(mu, mu, r, v, boot, done, gamma=0.98, lam=1.0)
    np.testing.assert_allclose(pg.numpy(), (vs - v).numpy(), rtol=1e-4,
                               atol=1e-4)


def test_gae_inverse_matches_jax_and_roundtrips():
    """gae_scan(gae_inverse(adv)) recovers adv; r_hat equals JAX's."""
    rng = np.random.default_rng(5)
    T, B = 9, 4
    adv, v = _f32(rng.normal(0, 2, (T, B)), rng.normal(0, 1, (T, B)))
    (boot,) = _f32(rng.normal(0, 1, B))
    done = rng.random((T, B)) < 0.25
    for gamma, lam in ((0.99, 0.95), (0.9, 1.0)):
        t = [torch.from_numpy(x) for x in (adv, v, boot, done)]
        r_hat = vt.gae_inverse(*t, gamma=gamma, lam=lam)
        j_hat = jvt.gae_inverse(*map(jnp.asarray, (adv, v, boot, done)),
                                gamma=gamma, lam=lam)
        np.testing.assert_allclose(r_hat.numpy(), np.asarray(j_hat), **TOL)
        adv2, _ = gae_scan(r_hat, t[1], t[2], t[3], gamma=gamma, lam=lam)
        np.testing.assert_allclose(adv2.numpy(), adv, **TOL)


# ---------------------------------------------------------------------------
# alternating sampler, device split
# ---------------------------------------------------------------------------

def _r2d1_model(d=16):
    return make_recurrent_q(1, 3, conv=True, img_hw=(10, 5), d_lstm=d,
                            channels=(8,), kernels=(3,), strides=(1,),
                            d_conv_out=32)


def _equal_trees(a, b):
    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def test_alternating_sampler_layout_and_interleaving():
    """Group A is the first half of the batch axis and group B the second;
    each half is exactly a serial sampler of n_envs / 2 on the generator
    ``fold_seed(seed, g)``, over two collects (A's pending action is the
    serial sampler's next selection); ``full_agent_state`` is [A; B] with
    A one selection ahead (its pending action's); the stats add up."""
    env = make_env("catch")
    model = _r2d1_model()
    agent = make_r2d1_agent(model, 3)
    params = model.init(torch.Generator().manual_seed(0))
    alt = AlternatingSampler(env, agent, n_envs=8, horizon=5)
    half = SerialSampler(env, agent, 4, 5)
    kw = {"epsilon": 0.3}
    st = alt.init(torch.Generator().manual_seed(3), kw)
    sa = half.init(torch.Generator().manual_seed(fold_seed(3, 0)), kw)
    sb = half.init(torch.Generator().manual_seed(fold_seed(3, 1)), kw)
    for _ in range(2):
        st, batch = alt.collect(params, st)
        sa, ba = half.collect(params, sa)
        sb, bb = half.collect(params, sb)
        assert tuple(batch.reward.shape) == (5, 8)
        _equal_trees(pytree.tree_map(lambda x: x[:, :4], batch), ba)
        _equal_trees(pytree.tree_map(lambda x: x[:, 4:], batch), bb)
    _, _, sa_next = half.select(params, sa)
    full = alt.full_agent_state(st)
    _equal_trees(full["lstm"], tuple(torch.cat([x, y]) for x, y in zip(
        sa_next.agent_state["lstm"], sb.agent_state["lstm"])))
    stats, sa_stats, sb_stats = (alt.traj_stats(st), half.traj_stats(sa),
                                 half.traj_stats(sb))
    assert int(stats["episodes"]) == int(sa_stats["episodes"]) + \
        int(sb_stats["episodes"]) > 0
    v = alt.bootstrap_value(params, st)
    assert tuple(v.shape) == (8,)
    reset = alt.reset_stats(st)
    assert int(alt.traj_stats(reset)["episodes"]) == 0
    assert reset.pending_a is st.pending_a
    with pytest.raises(ValueError, match="even"):
        AlternatingSampler(env, agent, n_envs=7, horizon=5)


def test_split_actor_learner():
    cpu = torch.device("cpu")
    assert split_actor_learner(["cpu"]) == (cpu, cpu)
    devs = [torch.device("cuda", i) for i in range(4)]
    assert split_actor_learner(devs) == (devs[3], devs[0])
    with pytest.raises(ValueError):
        split_actor_learner([])
    # mesh=: the devices the mesh's ranks do not use, or a ValueError when
    # they use every one (two ranks on one card)
    mesh2 = DataMesh(axis="data", size=2, device=devs[0],
                     devices=(devs[0], devs[1]))
    assert split_actor_learner(devs, mesh=mesh2) == (devs[3], devs[2])
    one_card = DataMesh(axis="data", size=2, device=devs[0],
                        devices=(devs[0], devs[0]))
    with pytest.raises(ValueError, match="every device"):
        split_actor_learner(devs[:1], mesh=one_card)


# ---------------------------------------------------------------------------
# runner fixtures (the stacks of tests/test_async_rl.py)
# ---------------------------------------------------------------------------

def _a2c_stack():
    model = make_pg_mlp(4, 2)
    agent = make_categorical_pg_agent(model)
    algo = A2C(model.apply, adam(1e-3), distribution=Categorical(2),
               gamma=0.99, gae_lambda=0.95)
    return agent, algo, SerialSampler(make_env("cartpole"), agent, 8, 16)


def _dqn_stack():
    model = make_q_mlp(4, 2)
    agent = make_dqn_agent(model, 2)
    algo = DQN(model.apply, adam(1e-3), double=True)
    sampler = SerialSampler(make_env("cartpole"), agent, n_envs=8, horizon=16)
    ex = TransitionSamples(observation=np.zeros(4, np.float32),
                           action=np.int32(0), reward=np.float32(0),
                           done=False, timeout=False)
    return agent, algo, sampler, ex


def test_async_staleness0_matches_sync_trainloop():
    """Lockstep async A2C with V-trace ON equals the synchronous TrainLoop
    on the same seed: at staleness 0 the correction is the identity."""
    agent, algo, sampler = _a2c_stack()
    N, seed = 6, 7
    params = agent.init_params(torch.Generator().manual_seed(seed))
    loop = TrainLoop(sampler, algo)
    ts = algo.init_train_state(None, _clone(params))
    ss = sampler.init(torch.Generator().manual_seed(seed + 1))
    ts_sync = loop.run_window(ts, ss, None,
                              torch.Generator().manual_seed(seed + 2), N)[0]
    runner = AsyncRunner(sampler, algo, n_iterations=N, log_interval=3,
                         threaded=False, publish_interval=1, logger=_quiet())
    ts_async, _, _ = runner.run(seed, params=_clone(params), device="cpu")
    diffs = [float((a - b).abs().max()) for a, b in zip(
        pytree.tree_leaves(ts_sync.params),
        pytree.tree_leaves(ts_async.params))]
    assert max(diffs) < 1e-4, diffs
    moved = max(float((a - b).abs().max()) for a, b in zip(
        pytree.tree_leaves(ts_async.params), pytree.tree_leaves(params)))
    assert moved > 1e-3
    assert runner.stats["replay_ratio_actual"] == pytest.approx(1.0)
    assert runner.stats["updates"] == N


def test_replay_ratio_throttle_accounting():
    """consumption/generation never exceeds replay_ratio, and the update
    count is exactly consumed / batch_size."""
    _, algo, sampler, ex = _dqn_stack()
    buf = UniformReplayBuffer(ex, T_size=512, B=8, n_step=1)
    ratio = 0.5
    runner = AsyncRunner(sampler, algo, buf, batch_size=64,
                         replay_ratio=ratio, min_replay=128, n_iterations=12,
                         log_interval=6, threaded=False, logger=_quiet(),
                         agent_state_kwargs={"epsilon": 0.3})
    runner.run(0, device="cpu")
    generated = 12 * sampler.horizon * sampler.n_envs
    actual = runner.stats["replay_ratio_actual"]
    assert 0 < actual <= ratio + 1e-9
    assert runner.stats["updates"] == int(actual * generated) // 64
    assert "recompile_events" not in runner.stats
    # one thread: no put wait, no idle learner, busy time per unit of work
    assert runner.stats["actor_put_wait_s"] == 0.0
    assert runner.stats["learner_idle_s"] == 0.0
    assert runner.stats["collect_ms"] > 0 and runner.stats["update_ms"] > 0
    step = runner._train_state.step
    info = runner.update_once(torch.Generator().manual_seed(0))
    assert np.isfinite(float(info.loss))
    assert runner._train_state.step == step + 1


def test_publication_cadence_and_staleness(tmp_path):
    """publish_interval=k publishes every k updates and gives measurable
    staleness; k=1 keeps staleness 0 in the lockstep schedule."""
    _, algo, sampler = _a2c_stack()
    rows = {}
    for k in (1, 3):
        runner = AsyncRunner(sampler, algo, n_iterations=6, log_interval=6,
                             threaded=False, publish_interval=k,
                             logger=_quiet(str(tmp_path / f"pub{k}")))
        runner.run(1, device="cpu")
        runner.logger.close()
        assert runner.stats["publish_version"] == 6 // k
        with open(tmp_path / f"pub{k}" / "progress.jsonl") as f:
            rows[k] = [json.loads(line) for line in f][-1]
    assert rows[1]["param_staleness_max"] == 0
    assert rows[3]["param_staleness_max"] == 2
    assert 0 < rows[3]["param_staleness_mean"] <= 2


def test_published_snapshot_survives_an_in_place_step():
    """The bus holds a copy: an in-place Adam step of the learner moves the
    train state's params and leaves the published ones bit-unchanged (no
    storage shared); the next publication is a new copy of the new
    params."""
    _, algo, sampler = _a2c_stack()
    runner = AsyncRunner(sampler, algo, n_iterations=1, log_interval=1,
                         threaded=False, publish_interval=2, logger=_quiet())
    runner.run(2, device="cpu")
    assert runner._bus.version == 0          # one update: nothing published
    _, _, published, event = runner._bus.read()
    assert event is None                      # no stream on the CPU
    before = _clone(published)
    train = pytree.tree_leaves(runner._train_state.params)
    assert all(p.data_ptr() != q.data_ptr()
               for p, q in zip(pytree.tree_leaves(published), train))
    item, _ = runner._actor_step(1)
    runner._learner_consume_rollout(item, torch.Generator().manual_seed(0))
    _equal_trees(published, before)
    assert not all(torch.equal(p, q) for p, q in zip(
        pytree.tree_leaves(runner._train_state.params),
        pytree.tree_leaves(before)))
    assert runner._bus.version == 1           # the second update published
    _, _, new, _ = runner._bus.read()
    _equal_trees(new, runner._train_state.params)
    assert all(p.data_ptr() != q.data_ptr() for p, q in zip(
        pytree.tree_leaves(new),
        pytree.tree_leaves(runner._train_state.params)))


def test_threaded_runner_telemetry(tmp_path):
    """The decoupled schedule: every async column in the log, nonzero
    throughput, updates, a finite loss, and both threads joined."""
    _, algo, sampler, ex = _dqn_stack()
    buf = UniformReplayBuffer(ex, T_size=1024, B=8, n_step=1)
    runner = AsyncRunner(sampler, algo, buf, batch_size=64, replay_ratio=1.0,
                         min_replay=128, n_iterations=16, log_interval=4,
                         threaded=True, publish_interval=2, drain=True,
                         logger=_quiet(str(tmp_path)),
                         agent_state_kwargs={"epsilon": 0.3})
    _, _, info = runner.run(0, device="cpu")
    runner.logger.close()
    assert np.isfinite(float(info.loss))
    assert runner.stats["samples_per_sec"] > 0
    assert runner.stats["updates"] > 0
    assert runner.stats["replay_ratio_actual"] <= 1.0 + 1e-9
    assert runner.stats["publish_version"] == runner.stats["updates"] // 2
    for key in ("collect_ms", "update_ms", "actor_put_wait_s",
                "learner_idle_s"):
        assert runner.stats[key] >= 0, key
    with open(tmp_path / "progress.jsonl") as f:
        row = [json.loads(line) for line in f][-1]
    for key in ("param_staleness_mean", "param_staleness_max",
                "publish_version", "db_occupancy", "queue_depth",
                "actor_idle_frac", "learner_idle_frac", "overlap_frac",
                "avg_return", "episodes"):
        assert key in row, key
    assert 0 <= row["db_occupancy"] <= 1 and 0 <= row["actor_idle_frac"] <= 1


class _FailingSampler(SerialSampler):
    def __init__(self, *a, fail_at=2, **kw):
        super().__init__(*a, **kw)
        self.calls, self.fail_at = 0, fail_at

    def collect(self, params, state):
        self.calls += 1
        if self.calls > self.fail_at:
            raise RuntimeError("actor failed on purpose")
        return super().collect(params, state)


@pytest.mark.parametrize("mode", ["transition", "rollout"])
def test_threaded_runner_reraises_the_actor_error(mode):
    """An error in the actor thread ends the run and is raised by run()."""
    if mode == "rollout":
        agent, algo, _ = _a2c_stack()
        sampler = _FailingSampler(make_env("cartpole"), agent, 8, 16)
        runner = AsyncRunner(sampler, algo, n_iterations=10, logger=_quiet())
    else:
        agent, algo, _, ex = _dqn_stack()
        sampler = _FailingSampler(make_env("cartpole"), agent, 8, 16)
        runner = AsyncRunner(sampler, algo,
                             UniformReplayBuffer(ex, 256, 8), batch_size=32,
                             min_replay=64, n_iterations=10, logger=_quiet(),
                             agent_state_kwargs={"epsilon": 0.3})
    with pytest.raises(RuntimeError, match="on purpose"):
        runner.run(0, device="cpu")
    assert sampler.calls == 3


def test_runner_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, algo, sampler = _a2c_stack()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AsyncRunner(sampler, algo, n_iterations=1).run(0)


# ---------------------------------------------------------------------------
# R2D1 + checkpoint/restore
# ---------------------------------------------------------------------------

D = 32


def _r2d1_stack(sampler_cls=SerialSampler, horizon=8):
    model = _r2d1_model(D)
    agent = make_r2d1_agent(model, 3)
    algo = R2D1(model.apply, adam(5e-4), burn_in=2, n_step=1, gamma=0.99,
                target_update_interval=50)
    sampler = sampler_cls(make_env("catch"), agent, n_envs=8, horizon=horizon)
    return algo, sampler, _seq_buffer


def _seq_buffer(mod=thost):
    st0 = (np.zeros((D,), np.float32), np.zeros((D,), np.float32))
    ex = mod.SequenceSamples(observation=np.zeros((10, 5, 1), np.float32),
                             prev_action=np.int32(0),
                             prev_reward=np.float32(0), action=np.int32(0),
                             reward=np.float32(0), done=False,
                             init_state=st0)
    return mod.SequenceReplayBuffer(ex, T_size=256, B=8, seq_len=16,
                                    burn_in=2, state_interval=8)


def test_r2d1_stored_state_alignment():
    """horizon != state_interval is rejected; and each block's stored state
    is the alternating sampler's full agent state copied BEFORE that
    block's collect (later collects do not move it)."""
    algo, sampler, mkbuf = _r2d1_stack(horizon=4)
    with pytest.raises(ValueError, match="state_interval"):
        AsyncR2D1Runner(sampler, algo, mkbuf(), batch_size=8)
    algo, sampler, mkbuf = _r2d1_stack(AlternatingSampler)
    seen = []
    collect = sampler.collect

    def recording(params, state):
        seen.append(_clone(sampler.full_agent_state(state)["lstm"]))
        return collect(params, state)

    sampler.collect = recording
    buf = mkbuf()
    runner = AsyncR2D1Runner(sampler, algo, buf, batch_size=8,
                             replay_ratio=1.0, min_replay=128,
                             n_iterations=6, log_interval=3, threaded=False,
                             logger=_quiet(),
                             agent_state_kwargs={"epsilon": 0.3})
    runner.run(0, device="cpu")
    assert len(seen) == 6 and runner.stats["updates"] > 0
    for slot, (h, c) in enumerate(seen):
        np.testing.assert_array_equal(buf.states[0][slot], h.numpy())
        np.testing.assert_array_equal(buf.states[1][slot], c.numpy())
    assert float(seen[-1][0].abs().sum()) > 0
    # priorities moved off their initial 1.0 for the sampled sequences
    assert (buf.slot_pr[:6] != 1.0).any()


def test_r2d1_unified_run_restores(tmp_path):
    """Both runner classes share one run loop: a restored R2D1 run resumes
    at the saved iteration, rehydrates the sequence buffer bit for bit and
    keeps checkpointing."""
    algo, sampler, mkbuf = _r2d1_stack()
    ck = str(tmp_path / "ck")
    buf = mkbuf()
    kw = dict(batch_size=8, replay_ratio=1.0, min_replay=128, log_interval=4,
              threaded=False, ckpt_dir=ck, ckpt_interval=4, logger=_quiet(),
              agent_state_kwargs={"epsilon": 0.3})
    r1 = AsyncR2D1Runner(sampler, algo, buf, n_iterations=8, **kw)
    ts1, _, _ = r1.run(0, device="cpu")
    assert latest_step(ck) == 8
    assert os.path.exists(os.path.join(ck, "replay_00000008.npz"))
    saved = buf.state_dict()
    assert buf.filled == 64

    buf2 = mkbuf()
    r2 = AsyncR2D1Runner(sampler, algo, buf2, n_iterations=8, **kw)
    ts2, _, _ = r2.run(1, restore=True, device="cpu")
    for k, v in saved.items():              # nothing ran after the restore
        np.testing.assert_array_equal(buf2.state_dict()[k], v)
    _equal_trees(ts2.params, ts1.params)
    assert ts2.step == ts1.step and ts2.opt_state.step == ts1.opt_state.step
    _equal_trees(ts2.opt_state.mu, ts1.opt_state.mu)
    _equal_trees(ts2.extra, ts1.extra)

    buf3 = mkbuf()
    r3 = AsyncR2D1Runner(sampler, algo, buf3, n_iterations=12, **kw)
    r3.run(1, restore=True, device="cpu")
    assert buf3.filled == 64 + 4 * 8
    assert latest_step(ck) == 12


def test_restore_missing_sidecar_warns(tmp_path):
    """Without the replay sidecar, restore warns and re-enforces the
    min_replay warmup instead of optimizing an empty buffer."""
    _, algo, sampler, ex = _dqn_stack()
    ck = str(tmp_path / "ck")
    kw = dict(batch_size=32, min_replay=128, log_interval=3, threaded=False,
              ckpt_dir=ck, ckpt_interval=3, logger=_quiet(),
              agent_state_kwargs={"epsilon": 0.3})
    b1 = UniformReplayBuffer(ex, T_size=512, B=8, n_step=1)
    AsyncRunner(sampler, algo, b1, n_iterations=6, **kw).run(0, device="cpu")
    for fn in os.listdir(ck):
        if fn.startswith("replay_"):
            os.remove(os.path.join(ck, fn))
    b2 = UniformReplayBuffer(ex, T_size=512, B=8, n_step=1)
    r2 = AsyncRunner(sampler, algo, b2, n_iterations=9, **kw)
    with pytest.warns(UserWarning, match="replay sidecar"):
        r2.run(1, restore=True, device="cpu")
    assert b2.filled == 3 * 16            # only the resumed iterations
    assert latest_step(ck) == 9


def test_jax_written_r2d1_checkpoint_restores_into_the_port(tmp_path):
    """JAX's AsyncR2D1Runner saves at iteration 6 (train state + sequence
    sidecar); the port's runner of the same configuration, given
    ``restore=True``, takes its params, optimizer moments, target and step
    and its buffer exactly, and resumes at iteration 6."""
    ck = str(tmp_path / "ck")
    jmodel = jrl.make_recurrent_q(1, 3, conv=True, img_hw=(10, 5), d_lstm=D,
                                  channels=(8,), kernels=(3,), strides=(1,),
                                  d_conv_out=32)
    jalgo = JR2D1(jmodel.apply, joptim.adam(5e-4), burn_in=2, n_step=1,
                  gamma=0.99, target_update_interval=50)
    jsampler = JSerialSampler(jmake_env("catch"),
                              jagents.make_r2d1_agent(jmodel, 3), n_envs=8,
                              horizon=8)
    jbuf = _seq_buffer(jhost)
    kw = dict(batch_size=8, replay_ratio=1.0, min_replay=128, log_interval=6,
              threaded=False, ckpt_dir=ck, ckpt_interval=6,
              agent_state_kwargs={"epsilon": 0.3})
    jr = JAsyncR2D1Runner(jsampler, jalgo, jbuf, n_iterations=6,
                          logger=_quiet(), **kw)
    jts, _, _ = jr.run(jax.random.PRNGKey(0))
    assert latest_step(ck) == 6 and int(jts.step) > 0

    algo, sampler, mkbuf = _r2d1_stack()
    buf = mkbuf()
    runner = AsyncR2D1Runner(sampler, algo, buf, n_iterations=6,
                             logger=_quiet(), **kw)
    ts, _, _ = runner.run(3, restore=True, device="cpu")
    assert ts.step == int(jts.step) and ts.opt_state.step == int(
        jts.opt_state.step)
    jstate = jbuf.state_dict()
    for k, v in buf.state_dict().items():
        np.testing.assert_array_equal(v, jstate[k])

    def by_path(tree, jax_tree=False):
        if jax_tree:
            flat = jax.tree_util.tree_flatten_with_path(tree)[0]
            return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                             for p in path): np.asarray(x)
                    for path, x in flat}
        return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                         for p in path): x.numpy()
                for path, x in pytree.tree_flatten_with_path(tree)[0]}

    for port, ref in ((ts.params, jts.params),
                      (ts.extra["target"], jts.extra["target"])):
        a, b = by_path(port), by_path(ref, jax_tree=True)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    # the moments come back in the port's leaf order
    pmu = dict(zip(by_path(ts.params), ts.opt_state.mu))
    jmu = by_path(jts.opt_state.mu, jax_tree=True)
    for k, m in pmu.items():
        np.testing.assert_array_equal(m.numpy(), jmu[k])
    assert runner._iters_done == 6 and runner.stats["updates"] == int(
        jts.step)


# ---------------------------------------------------------------------------
# the example twins
# ---------------------------------------------------------------------------

def test_r2d1_example_defaults_to_cuda_and_runs_on_cpu(capsys):
    ap = r2d1_recurrent.build_parser()
    assert ap.get_default("device") == "cuda"
    assert ap.get_default("iters") == 120
    assert ap.get_default("replay_ratio") == 2.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            r2d1_recurrent.main(["--iters", "1"])
    stats = r2d1_recurrent.main(["--device", "cpu", "--iters", "8"])
    assert stats["updates"] > 0
    assert 0 < stats["replay_ratio_actual"] <= 2.0 + 1e-9
    assert "done" in capsys.readouterr().out
    sampler, runner = r2d1_recurrent.make_runner(1)
    assert isinstance(sampler, AlternatingSampler)
    assert (sampler.n_envs, sampler.horizon, runner.batch_size) == (16, 8, 32)
    assert (runner.buffer.seq_len, runner.buffer.state_interval,
            runner.buffer.T_size) == (16, 8, 2048)
    assert runner.algo.target_interval == 200
    _, runner = r2d1_recurrent.make_runner(1, target_update_interval=4)
    assert runner.algo.target_interval == 4


def test_sac_example_defaults_to_cuda_and_runs_on_cpu():
    ap = mujoco_style_sac.build_parser()
    assert ap.get_default("device") == "cuda"
    assert ap.get_default("iters") == 150
    assert ap.get_default("replay_ratio") == 8.0
    stats = mujoco_style_sac.main(["--device", "cpu", "--iters", "6"])
    assert 0 <= stats["replay_ratio_actual"] <= 8.0 + 1e-9
    assert stats["publish_version"] == stats["updates"]
    _, runner, init = mujoco_style_sac.make_runner(1)
    assert runner.buffer.store_next_obs and runner.batch_size == 128
    p = init(torch.Generator().manual_seed(0))
    assert set(p) == {"actor", "critic"}
