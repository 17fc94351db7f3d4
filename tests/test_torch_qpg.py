"""The Q-value policy-gradient family of the PyTorch port against the JAX
package, on the CPU: Pendulum (one batched step and a crossing of the time
limit, with JAX's reset draws), the continuous heads, the DDPG / SAC actors
and the stacked twin critic on params carried by ``rl_params_from_jax``,
``Gaussian`` and ``SquashedGaussian`` on the same pre-drawn noise, the DDPG,
SAC and Gaussian-PG agents, one DDPG, TD3 and SAC update each from the same
params, targets, batch and noise (with the Polyak identity of the targets
and no target aliasing its online params), TD3's delayed actor and SAC's
alpha dynamics, timeout bootstrapping through both packages'
``DeviceReplay``, the family through ``OffPolicyRunner`` (uniform and
prioritized), ``soft_update`` / ``adam(weight_decay=)`` /
``linear_warmup_cosine`` and the Adam scalars built on the params' device,
and the example entry point.

Inputs are made from a seed with numpy (or drawn by JAX and handed over as
numpy) and go through both sides.  Tolerances:
- exact for integer and boolean results (done, timeout, episode_step,
  indices, n_used, bootstrap) and for values both sides only copy
  (replayed observations);
- Pendulum's state, observations and reward after a step: 1e-5 relative +
  1e-6 absolute (``sin`` / ``cos`` / ``remainder`` differ in the last ulp
  between XLA and ATen);
- model outputs, log-likelihoods, entropies, KLs, losses, td_abs, alpha,
  schedules and one ``soft_update``: 1e-5 relative + 1e-6 absolute (the
  frameworks sum a product's terms in other orders; ``softplus`` and
  ``tanh`` differ by ulps);
- gradients: 1e-4 relative + 1e-6 absolute of the largest entry of the
  leaf (small entries are sums of cancelling terms);
- params and ``log_alpha`` after one Adam step: Adam's first step moves p by
  lr g / (|g| + eps), whose sensitivity to g is at most lr / (|g| + eps),
  so each is held within 2 lr |g_port - g_jax| / (|g_jax| + eps) + 1e-6 |p|
  (the bound of tests/test_torch_dqn.py);
- targets after an update: exactly ``(1 - tau) * old + tau * new`` of the
  port's own tensors, and within tau times the params' bound of JAX's;
- AdamW over 5 steps against JAX: 1e-6 relative + 1e-7 absolute (the
  gradients are the same numbers on both sides).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro import agents as jagents  # noqa: E402
from repro.algos import DDPG as JDDPG, SAC as JSAC, TD3 as JTD3  # noqa: E402
from repro.core import distributions as jdist  # noqa: E402
from repro.core.batch_spec import make_algo_batch as jmake_algo_batch  # noqa: E402
from repro.envs import make_env as jmake_env  # noqa: E402
from repro.models import heads as jheads  # noqa: E402
from repro.models import rl_models as jrl  # noqa: E402
from repro.replay.interface import DeviceReplay as JDeviceReplay  # noqa: E402
from repro.replay.interface import transition_example as jexample  # noqa: E402
from repro.samplers.serial import RolloutBatch as JRolloutBatch  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch import agents as tagents  # noqa: E402
from repro_torch.algos import DDPG, SAC, TD3  # noqa: E402
from repro_torch.algos.qpg.ddpg import copy_params  # noqa: E402
from repro_torch.core import distributions as tdist  # noqa: E402
from repro_torch.core.algorithm import grads_of  # noqa: E402
from repro_torch.core.batch_spec import make_algo_batch  # noqa: E402
from repro_torch.envs import make_env  # noqa: E402
from repro_torch.envs import pendulum as tpendulum  # noqa: E402
from repro_torch.examples import pendulum_qpg as example  # noqa: E402
from repro_torch.models import heads as theads  # noqa: E402
from repro_torch.models import rl_models as trl  # noqa: E402
from repro_torch.models.convert import rl_params_from_jax  # noqa: E402
from repro_torch.replay.interface import DeviceReplay, transition_example  # noqa: E402
from repro_torch.samplers import SerialSampler  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-6)
LR = 1e-3
TAU = 0.005
HID = (16, 16)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _leaves(tree):
    return [t.detach().numpy() for t in pytree.tree_leaves(tree)]


def _jleaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _close(t, j, **tol):
    for a, b in zip(_leaves(t), _jleaves(j), strict=True):
        np.testing.assert_allclose(a, b, **(tol or F32_TOL))


# ---------------------------------------------------------------------------
# Pendulum
# ---------------------------------------------------------------------------

def _jax_fresh(keys):
    """JAX's reset draws (th, thdot) of ``make_pendulum``'s ``_fresh`` for
    each key, as (B, 2) numpy."""
    def one(k):
        k1, k2 = jax.random.split(k)
        return jnp.stack([
            jax.random.uniform(k1, (), jnp.float32, -jnp.pi, jnp.pi),
            jax.random.uniform(k2, (), jnp.float32, -1.0, 1.0)])
    return np.array(jax.vmap(one)(keys))


def _jax_step(jenv, state, action, keys):
    return jax.vmap(jenv.step)({k: jnp.asarray(v) for k, v in state.items()},
                               jnp.asarray(action), keys)


def _check_step(t_out, j_out):
    ts, tobs, tr, td, tinfo = t_out
    js, jobs, jr, jd, jinfo = j_out
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tinfo.timeout.numpy(),
                                  np.asarray(jinfo.timeout))
    np.testing.assert_array_equal(tinfo.episode_step.numpy(),
                                  np.asarray(jinfo.episode_step))
    np.testing.assert_array_equal(ts["t"].numpy(), np.asarray(js["t"]))
    for k in ("th", "thdot"):
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), **F32_TOL)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), **F32_TOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **F32_TOL)
    np.testing.assert_allclose(tinfo.terminal_obs.numpy(),
                               np.asarray(jinfo.terminal_obs), **F32_TOL)


def test_pendulum_step_matches_jax():
    """One step of 400 states — angles beyond +-pi (the floor modulo), speeds
    at the clip, torques beyond +-2, steps 0-199 (a quarter at 199, so the
    time limit ends them) — from the same state, action and reset draws:
    every output of JAX's vmapped ``step``."""
    rs = np.random.RandomState(0)
    B = 400
    state = {"th": rs.uniform(-7, 7, B).astype(np.float32),
             "thdot": rs.uniform(-9, 9, B).astype(np.float32),
             "t": np.where(rs.rand(B) < 0.25, 199,
                           rs.randint(0, 199, B)).astype(np.int32)}
    action = rs.uniform(-3, 3, (B, 1)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    j_out = _jax_step(jmake_env("pendulum"), state, action, keys)
    t_out = tpendulum.step_with_noise(
        {k: torch.from_numpy(v) for k, v in state.items()},
        torch.from_numpy(action), torch.from_numpy(_jax_fresh(keys)))
    _check_step(t_out, j_out)
    done = t_out[3].numpy()
    assert 50 < done.sum() < B and t_out[4].timeout.numpy()[done].all()
    # the reset rows start from JAX's draws; terminal_obs is pre-reset
    assert not np.allclose(t_out[4].terminal_obs.numpy()[done],
                           t_out[1].numpy()[done])


def test_pendulum_crosses_the_time_limit_like_jax():
    """Six steps of 8 envs with a 3-step limit (the mirror of
    tests/test_envs.py::test_pendulum_terminal_obs_is_pre_reset), fed the
    same actions and reset draws each step: both sides end and restart
    every episode on the same step, with ``timeout`` set and the pre-reset
    observation as ``terminal_obs``."""
    B, limit = 8, 3
    jenv = jmake_env("pendulum", max_episode_steps=limit)
    tenv = make_env("pendulum", max_episode_steps=limit)
    rs = np.random.RandomState(1)
    state = {"th": rs.uniform(-3, 3, B).astype(np.float32),
             "thdot": rs.uniform(-1, 1, B).astype(np.float32),
             "t": np.arange(B, dtype=np.int32) % limit}
    jstate = state
    tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    key = jax.random.PRNGKey(7)
    ends = 0
    for _ in range(6):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, B)
        action = rs.uniform(-1, 1, (B, 1)).astype(np.float32)
        j_out = _jax_step(jenv, {k: np.asarray(v) for k, v in jstate.items()},
                          action, keys)
        t_out = tpendulum.step_with_noise(
            tstate, torch.from_numpy(action),
            torch.from_numpy(_jax_fresh(keys)), max_episode_steps=limit)
        _check_step(t_out, j_out)
        d = t_out[3].numpy()
        ends += d.sum()
        assert (t_out[4].timeout.numpy() == d).all()
        assert not np.allclose(t_out[4].terminal_obs.numpy()[d],
                               t_out[1].numpy()[d])
        jstate, tstate = j_out[0], t_out[0]
    assert ends == 2 * B  # every env crossed the limit twice
    assert tenv.max_episode_steps == limit


def test_pendulum_reset_and_env_spec():
    env = make_env("pendulum")
    jenv = jmake_env("pendulum")
    np.testing.assert_array_equal(env.observation_space.low,
                                  np.asarray(jenv.observation_space.low))
    np.testing.assert_array_equal(env.observation_space.high,
                                  np.asarray(jenv.observation_space.high))
    assert env.action_space.shape == jenv.action_space.shape == (1,)
    np.testing.assert_array_equal(env.action_space.high,
                                  np.asarray(jenv.action_space.high))
    assert env.max_episode_steps == jenv.max_episode_steps == 200
    state, obs = env.reset(1000, torch.Generator().manual_seed(0))
    th, thdot = state["th"].numpy(), state["thdot"].numpy()
    assert obs.shape == (1000, 3) and state["t"].dtype == torch.int32
    assert th.min() >= -math.pi and th.max() < math.pi and th.std() > 1.5
    assert thdot.min() >= -1 and thdot.max() < 1
    np.testing.assert_allclose(obs.numpy(), np.stack(
        [np.cos(th), np.sin(th), thdot], -1), **F32_TOL)


# ---------------------------------------------------------------------------
# heads, actors, critics, distributions, agents
# ---------------------------------------------------------------------------

def test_continuous_heads_match_jax():
    """mu_head and gaussian_head (log_std clipped at -20 and 2: h is scaled
    so that both clips bite) on JAX's params."""
    jmu = jheads.init_mu_head(jax.random.PRNGKey(0), 8, 3)
    jg = jheads.init_gaussian_head(jax.random.PRNGKey(1), 8, 3)
    h = np.random.RandomState(2).normal(0, 4, (64, 8)).astype(np.float32)
    h[:4] *= 30
    np.testing.assert_allclose(
        theads.mu_head(rl_params_from_jax(_np(jmu)), torch.from_numpy(h)).numpy(),
        np.asarray(jheads.mu_head(jmu, jnp.asarray(h))), **F32_TOL)
    tm, tl = theads.gaussian_head(rl_params_from_jax(_np(jg)),
                                  torch.from_numpy(h))
    jm, jl = jheads.gaussian_head(jg, jnp.asarray(h))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **F32_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)
    assert tl.min() == -20.0 and tl.max() == 2.0
    # the port's own init: JAX's shapes, N(0, 1/d_in) weights, zero biases
    p = theads.init_gaussian_head(torch.Generator().manual_seed(0), 8, 3)
    assert {k: tuple(v["w"].shape) for k, v in p.items()} == {
        k: tuple(v["w"].shape) for k, v in jg.items()}
    assert not p["mean"]["b"].any()


def _jax_qpg_params(hidden=HID, seed=0):
    ka, kc = jax.random.split(jax.random.PRNGKey(seed))
    return {"actor_ddpg": jrl.make_ddpg_actor(3, 1, hidden).init(ka),
            "actor_sac": jrl.make_sac_actor(3, 1, hidden).init(ka),
            "critic": jrl.make_q_critic(3, 1, hidden).init(kc)}


@pytest.mark.parametrize("lead", [(), (7,), (5, 3)])
def test_actors_and_twin_critic_match_jax(lead):
    """make_ddpg_actor, make_sac_actor and make_q_critic on JAX's params at
    [], [B] and [T, B] leading dims; the critic returns (n_critics, *lead)."""
    jp = _jax_qpg_params()
    rs = np.random.RandomState(3)
    obs = rs.normal(size=lead + (3,)).astype(np.float32)
    act = rs.uniform(-1, 1, lead + (1,)).astype(np.float32)
    tobs, tact = torch.from_numpy(obs), torch.from_numpy(act)
    jobs, jact = jnp.asarray(obs), jnp.asarray(act)

    mu = trl.make_ddpg_actor(3, 1, HID).apply(
        rl_params_from_jax(_np(jp["actor_ddpg"])), tobs)
    jmu = jrl.make_ddpg_actor(3, 1, HID).apply(jp["actor_ddpg"], jobs)
    assert mu.shape == jmu.shape == lead + (1,)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), **F32_TOL)

    out = trl.make_sac_actor(3, 1, HID).apply(
        rl_params_from_jax(_np(jp["actor_sac"])), tobs)
    jout = jrl.make_sac_actor(3, 1, HID).apply(jp["actor_sac"], jobs)
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32_TOL)

    q = trl.make_q_critic(3, 1, HID).apply(
        rl_params_from_jax(_np(jp["critic"])), tobs, tact)
    jq = jrl.make_q_critic(3, 1, HID).apply(jp["critic"], jobs, jact)
    assert tuple(q.shape) == jq.shape == (2,) + lead
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), **F32_TOL)


def test_qpg_params_carry_across_and_keep_the_stacked_layout():
    """``rl_params_from_jax`` carries the combined {"actor", "critic"} tree
    leaf for leaf; the port's own init has JAX's layout (every critic leaf
    with a leading n_critics axis), and its critics differ."""
    jp = _jax_qpg_params()
    jtree = {"actor": jp["actor_sac"], "critic": jp["critic"]}
    tp = rl_params_from_jax(_np(jtree))
    tpaths = [(pytree.keystr(k), tuple(v.shape)) for k, v in
              pytree.tree_flatten_with_path(tp)[0]]
    jpaths = [(jax.tree_util.keystr(k), tuple(v.shape)) for k, v in
              jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert tpaths == jpaths
    for a, b in zip(_leaves(tp), _jleaves(jtree)):
        np.testing.assert_array_equal(a, b)
    own = trl.make_q_critic(3, 1, HID, n_critics=3).init(
        torch.Generator().manual_seed(0))
    jown = jrl.make_q_critic(3, 1, HID, n_critics=3).init(
        jax.random.PRNGKey(0))
    assert sorted((pytree.keystr(k), tuple(v.shape)) for k, v in
                  pytree.tree_flatten_with_path(own)[0]) == sorted(
        (jax.tree_util.keystr(k), tuple(v.shape)) for k, v in
        jax.tree_util.tree_flatten_with_path(jown)[0])
    w = own["trunk"][0]["w"]
    assert w.shape == (3, 4, 16) and not torch.equal(w[0], w[1])


def _dist_inputs(seed=0, B=256, D=2):
    rs = np.random.RandomState(seed)
    mean = rs.normal(0, 3, (B, D)).astype(np.float32)
    log_std = rs.uniform(-4, 1.5, (B, D)).astype(np.float32)
    mean[:8] *= 10  # |u| up to ~90: tanh(u) rounds to +-1 in f32
    return mean, log_std


def test_gaussian_matches_jax():
    mean, log_std = _dist_inputs()
    mean_q, log_std_q = _dist_inputs(seed=1)
    key = jax.random.PRNGKey(4)
    jd, td = jdist.Gaussian(2, clip=1.5), tdist.Gaussian(2, clip=1.5)
    noise = np.array(jax.random.normal(key, mean.shape, jnp.float32))
    ja = jd.sample(key, jnp.asarray(mean), jnp.asarray(log_std))
    ta = td.sample_given(torch.from_numpy(mean), torch.from_numpy(log_std),
                         torch.from_numpy(noise))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **F32_TOL)
    assert ta.abs().max() == 1.5
    t = [torch.from_numpy(x) for x in (mean, log_std, mean_q, log_std_q)]
    j = [jnp.asarray(x) for x in (mean, log_std, mean_q, log_std_q)]
    np.testing.assert_allclose(
        td.log_likelihood(ta, t[0], t[1]).numpy(),
        np.asarray(jd.log_likelihood(ja, j[0], j[1])), **F32_TOL)
    np.testing.assert_allclose(td.entropy(t[0], t[1]).numpy(),
                               np.asarray(jd.entropy(j[0], j[1])), **F32_TOL)
    np.testing.assert_allclose(td.kl(*t).numpy(), np.asarray(jd.kl(*j)),
                               rtol=1e-5, atol=1e-4)
    # the generator wrapper draws a standard normal of the mean's shape
    g = torch.Generator().manual_seed(5)
    want = td.sample_given(t[0], t[1], torch.randn(mean.shape, generator=g))
    got = td.sample(torch.Generator().manual_seed(5), t[0], t[1])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_squashed_gaussian_matches_jax():
    """sample_with_logprob on the same noise, including rows where tanh(u)
    is +-1 in f32: the log-Jacobian's stable form stays finite there."""
    mean, log_std = _dist_inputs(seed=2)
    key = jax.random.PRNGKey(6)
    noise = np.array(jax.random.normal(key, mean.shape, jnp.float32))
    ja, jlogp = jdist.SquashedGaussian(2).sample_with_logprob(
        key, jnp.asarray(mean), jnp.asarray(log_std))
    d = tdist.SquashedGaussian(2)
    t = [torch.from_numpy(x) for x in (mean, log_std, noise)]
    ta, tlogp = d.sample_with_logprob_given(*t)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **F32_TOL)
    np.testing.assert_allclose(tlogp.numpy(), np.asarray(jlogp), rtol=1e-5,
                               atol=1e-4)
    assert (ta.abs() == 1.0).any() and torch.isfinite(tlogp).all()
    torch.testing.assert_close(d.sample_given(*t), ta, rtol=0, atol=0)
    torch.testing.assert_close(d.mode(t[0], t[1]), torch.tanh(t[0]))
    g = torch.Generator().manual_seed(8)
    want = d.sample_with_logprob_given(t[0], t[1],
                                       torch.randn(mean.shape, generator=g))
    got = d.sample_with_logprob(torch.Generator().manual_seed(8), t[0], t[1])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_qpg_agents_match_jax():
    """The DDPG and SAC agents' steps are their distributions' pure forms on
    the generator's next normal draw; their eval steps equal JAX's; both
    take the combined params or the actor's alone; ``value`` raises."""
    jp = _jax_qpg_params()
    obs = np.random.RandomState(9).normal(size=(16, 3)).astype(np.float32)
    tobs, jobs = torch.from_numpy(obs), jnp.asarray(obs)
    for kind in ("ddpg", "sac"):
        jactor = (jrl.make_ddpg_actor if kind == "ddpg" else
                  jrl.make_sac_actor)(3, 1, HID)
        tactor = (trl.make_ddpg_actor if kind == "ddpg" else
                  trl.make_sac_actor)(3, 1, HID)
        jagent = (jagents.make_ddpg_agent(jactor, 1, expl_noise=0.1)
                  if kind == "ddpg" else jagents.make_sac_agent(jactor, 1))
        tagent = (tagents.make_ddpg_agent(tactor, 1, expl_noise=0.1)
                  if kind == "ddpg" else tagents.make_sac_agent(tactor, 1))
        jparams = {"actor": jp[f"actor_{kind}"], "critic": jp["critic"]}
        tparams = rl_params_from_jax(_np(jparams))
        ja, jinfo, _ = jagent.eval_step(jparams, None, jobs, None, None, None)
        for p in (tparams, tparams["actor"]):
            ta, tinfo, _ = tagent.eval_step(p, None, tobs, None, None, None)
            np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **F32_TOL)
            assert set(tinfo) == set(jinfo)
        noise = torch.randn((16, 1), generator=torch.Generator().manual_seed(3))
        ta, tinfo, _ = tagent.step(tparams, torch.Generator().manual_seed(3),
                                   tobs, None, None, None)
        out = tactor.apply(tparams["actor"], tobs)
        if kind == "ddpg":
            torch.testing.assert_close(
                ta, torch.clamp(out + 0.1 * noise, -1, 1), rtol=0, atol=0)
            assert tinfo == {}
        else:
            a, logp = tdist.SquashedGaussian(1).sample_with_logprob_given(
                *out, noise)
            torch.testing.assert_close(ta, a, rtol=0, atol=0)
            torch.testing.assert_close(tinfo["logp"], logp, rtol=0, atol=0)
        with pytest.raises(NotImplementedError):
            tagent.value(tparams, tobs, None, None, None)


def test_gaussian_pg_agent_matches_jax():
    """The PPO-continuous agent over a model returning ((mean, log_std),
    value): eval step equal to JAX's, sampling step the Gaussian's pure
    form on the generator's next draw, value the model's."""
    w = np.random.RandomState(1).normal(size=(3, 3)).astype(np.float32)

    def model(xp):
        def apply(params, obs, pa=None, pr=None):
            h = obs @ xp.asarray(params["w"])
            return (h[..., :1], h[..., 1:2] * 0.1), h[..., 2]

        class M:
            pass
        m = M()
        m.init, m.apply, m.initial_state = None, apply, lambda b, **k: None
        return m

    obs = np.random.RandomState(2).normal(size=(8, 3)).astype(np.float32)
    jagent = jagents.make_gaussian_pg_agent(model(jnp), 1)
    tagent = tagents.make_gaussian_pg_agent(model(torch), 1)
    ja, jinfo, _ = jagent.eval_step({"w": w}, None, jnp.asarray(obs), None,
                                    None, None)
    tobs = torch.from_numpy(obs)
    ta, tinfo, _ = tagent.eval_step({"w": w}, None, tobs, None, None, None)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **F32_TOL)
    for k in ("logp", "value"):
        np.testing.assert_allclose(tinfo[k].numpy(), np.asarray(jinfo[k]),
                                   **F32_TOL)
    (mean, log_std), v = model(torch).apply({"w": w}, tobs)
    noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(4))
    ta, tinfo, _ = tagent.step({"w": w}, torch.Generator().manual_seed(4),
                               tobs, None, None, None)
    d = tdist.Gaussian(1)
    torch.testing.assert_close(ta, d.sample_given(mean, log_std, noise),
                               rtol=0, atol=0)
    torch.testing.assert_close(tinfo["logp"], d.log_likelihood(ta, mean,
                                                               log_std))
    torch.testing.assert_close(tagent.value({"w": w}, tobs, None, None, None), v)


# ---------------------------------------------------------------------------
# one update of each algorithm against JAX
# ---------------------------------------------------------------------------

def _batch(B=64, seed=4):
    rs = np.random.RandomState(seed)
    return {"observation": rs.normal(size=(B, 3)).astype(np.float32),
            "action": rs.uniform(-1, 1, (B, 1)).astype(np.float32),
            "return_": rs.normal(-3, 2, B).astype(np.float32),
            "bootstrap": (rs.rand(B) < 0.8).astype(np.float32),
            "next_observation": rs.normal(size=(B, 3)).astype(np.float32),
            "n_used": rs.randint(1, 3, B).astype(np.int32),
            "is_weights": rs.uniform(0.3, 1.0, B).astype(np.float32)}


def _adam_bound(p0, g, gj):
    return 2 * LR * np.abs(g - gj) / (np.abs(gj) + 1e-8) + 1e-6 * np.abs(p0) \
        + 1e-9


def _check_adam_step(t_new, j_new, t_old, tg, jg):
    """Params after Adam's first step against JAX's (see the module
    docstring); returns the bound per leaf."""
    bounds = []
    for p, pj, p0, g, gj in zip(_leaves(t_new), _jleaves(j_new),
                                _leaves(t_old), [x.numpy() for x in tg],
                                _jleaves(jg), strict=True):
        bound = _adam_bound(p0, g, gj)
        assert np.all(np.abs(p - pj) <= bound)
        bounds.append(bound)
    return bounds


def _check_grads(tg, jg):
    for g, gj in zip(tg, _jleaves(jg), strict=True):
        np.testing.assert_allclose(g.numpy(), gj, rtol=1e-4,
                                   atol=1e-6 * max(np.abs(gj).max(), 1.0))


def _check_targets(t_target, t_old_target, t_online, j_target, bounds):
    """Polyak identity on the port's own tensors, exactly; JAX's within tau
    times the online params' Adam bound; no target aliases an online leaf."""
    online_ptrs = {x.data_ptr() for x in pytree.tree_leaves(t_online)}
    for t, t0, o in zip(pytree.tree_leaves(t_target),
                        pytree.tree_leaves(t_old_target),
                        pytree.tree_leaves(t_online), strict=True):
        assert t.data_ptr() not in online_ptrs
        torch.testing.assert_close(t, (1 - TAU) * t0 + TAU * o, rtol=0, atol=0)
    for t, j, b in zip(_leaves(t_target), _jleaves(j_target), bounds,
                       strict=True):
        assert np.all(np.abs(t - j) <= TAU * b + 1e-6 * np.abs(j) + 1e-9)


def _setup(kind):
    """JAX and port algorithms over the same params, with targets that
    differ from the params (a second init)."""
    jp = _jax_qpg_params(seed=0)
    jt = _jax_qpg_params(seed=1)
    actor = "actor_sac" if kind == "sac" else "actor_ddpg"
    jparams = {"actor": jp[actor], "critic": jp["critic"]}
    jtarget = ({"critic": jt["critic"]} if kind == "sac" else
               {"actor": jt[actor], "critic": jt["critic"]})
    jA = (jrl.make_sac_actor if kind == "sac" else jrl.make_ddpg_actor)(3, 1, HID)
    tA = (trl.make_sac_actor if kind == "sac" else trl.make_ddpg_actor)(3, 1, HID)
    jC, tC = jrl.make_q_critic(3, 1, HID), trl.make_q_critic(3, 1, HID)
    if kind == "sac":
        kw = dict(act_dim=1, tau=TAU, init_alpha=0.3, alpha_lr=LR)
        jalgo = JSAC(jA.apply, jC.apply, joptim.adam(LR), joptim.adam(LR), **kw)
        talgo = SAC(tA.apply, tC.apply, toptim.adam(LR), toptim.adam(LR), **kw)
    else:
        jcls, tcls = {"ddpg": (JDDPG, DDPG), "td3": (JTD3, TD3)}[kind]
        jalgo = jcls(jA.apply, jC.apply, joptim.adam(LR), joptim.adam(LR),
                     tau=TAU)
        talgo = tcls(tA.apply, tC.apply, toptim.adam(LR), toptim.adam(LR),
                     tau=TAU)
    jts = jalgo.init_train_state(None, jparams)
    jts = jts._replace(extra={**jts.extra, "target": jtarget})
    tts = talgo.init_train_state(None, rl_params_from_jax(_np(jparams)))
    tts = tts._replace(extra={**tts.extra,
                              "target": rl_params_from_jax(_np(jtarget))})
    b = _batch()
    return (jalgo, jts, {k: jnp.asarray(v) for k, v in b.items()},
            talgo, tts, {k: torch.from_numpy(v) for k, v in b.items()})


def test_ddpg_update_matches_jax():
    jalgo, jts, jb, talgo, tts, tb = _setup("ddpg")
    p0, t0 = copy_params(tts.params), copy_params(tts.extra["target"])
    (jcl, jtd), jcg = jax.value_and_grad(jalgo.critic_loss, has_aux=True)(
        jts.params["critic"], jts.extra["target"], jb)
    tcl, taux, tcg = grads_of(talgo.critic_loss, p0["critic"], t0, tb)
    _check_grads(tcg, jcg)

    jts2, jinfo = jax.jit(jalgo.update)(jts, jb)
    tts2, tinfo = talgo.update(tts, tb)
    assert tts2.step == int(jts2.step) == 1
    for t, j in ((tinfo.loss, jinfo.loss), (tinfo.grad_norm, jinfo.grad_norm),
                 (tinfo.extra["actor_loss"], jinfo.extra["actor_loss"]),
                 (tinfo.extra["td_abs"], jinfo.extra["td_abs"])):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **F32_TOL)
    cb = _check_adam_step(tts2.params["critic"], jts2.params["critic"],
                          p0["critic"], tcg, jcg)
    # the actor's gradient is taken against each side's UPDATED critic
    jag = jax.grad(jalgo.actor_loss)(jts.params["actor"],
                                     jts2.params["critic"], jb)
    _, _, tag = grads_of(talgo.actor_loss, p0["actor"],
                         tts2.params["critic"], tb)
    _check_grads(tag, jag)
    ab = _check_adam_step(tts2.params["actor"], jts2.params["actor"],
                          p0["actor"], tag, jag)
    _check_targets(tts2.extra["target"], t0, tts2.params,
                   jts2.extra["target"], ab + cb)


def test_td3_update_matches_jax():
    """Step 1 (odd): the critic steps with JAX's smoothing noise, the actor,
    its Adam state and both targets stay bit for bit, actor_loss is still
    reported.  Then from a train state at step 1 (so the update is step 2):
    the actor steps against the updated critic and the targets move."""
    jalgo, jts, jb, talgo, tts, tb = _setup("td3")
    key = jax.random.PRNGKey(11)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (64, 1))))
    p0, t0 = copy_params(tts.params), copy_params(tts.extra["target"])
    a_opt0 = pytree.tree_map(
        lambda x: x.clone() if torch.is_tensor(x) else x,
        tts.opt_state["actor"])
    (_, _), jcg = jax.value_and_grad(jalgo.critic_loss, has_aux=True)(
        jts.params["critic"], jts.extra["target"], jb, key)
    _, _, tcg = grads_of(talgo.critic_loss, p0["critic"], t0, tb, noise)
    _check_grads(tcg, jcg)

    jts1, jinfo = jax.jit(jalgo.update)(jts, jb, key)
    tts1, tinfo = talgo.update(tts, tb, noise=noise)
    assert tts1.step == int(jts1.step) == 1
    for t, j in ((tinfo.loss, jinfo.loss), (tinfo.grad_norm, jinfo.grad_norm),
                 (tinfo.extra["actor_loss"], jinfo.extra["actor_loss"]),
                 (tinfo.extra["td_abs"], jinfo.extra["td_abs"])):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **F32_TOL)
    _check_adam_step(tts1.params["critic"], jts1.params["critic"],
                     p0["critic"], tcg, jcg)
    for a, b in ((tts1.params["actor"], p0["actor"]),
                 (tts1.extra["target"], t0),
                 (tts1.opt_state["actor"], a_opt0)):
        for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b),
                        strict=True):
            assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))

    jalgo, jts, jb, talgo, tts, tb = _setup("td3")
    jts = jts._replace(step=jnp.asarray(1, jnp.int32))
    tts = tts._replace(step=1)
    p0, t0 = copy_params(tts.params), copy_params(tts.extra["target"])
    _, _, tcg = grads_of(talgo.critic_loss, p0["critic"], t0, tb, noise)
    jts2, jinfo = jax.jit(jalgo.update)(jts, jb, key)
    tts2, tinfo = talgo.update(tts, tb, noise=noise)
    assert tts2.step == int(jts2.step) == 2
    np.testing.assert_allclose(float(tinfo.extra["actor_loss"]),
                               float(jinfo.extra["actor_loss"]), **F32_TOL)
    cb = _check_adam_step(tts2.params["critic"], jts2.params["critic"],
                          p0["critic"], tcg, jcg)
    jag = jax.grad(jalgo.actor_loss)(jts.params["actor"],
                                     jts2.params["critic"], jb)
    _, _, tag = grads_of(talgo.actor_loss, p0["actor"],
                         tts2.params["critic"], tb)
    ab = _check_adam_step(tts2.params["actor"], jts2.params["actor"],
                          p0["actor"], tag, jag)
    assert tts2.opt_state["actor"].step == 1
    _check_targets(tts2.extra["target"], t0, tts2.params,
                   jts2.extra["target"], ab + cb)


def test_sac_update_matches_jax():
    """JAX's two draws (k1 for the critic's next actions, k2 for the
    actor's) handed to the port: losses, td_abs, alpha, entropy, the params,
    log_alpha and the target critic after one update."""
    jalgo, jts, jb, talgo, tts, tb = _setup("sac")
    key = jax.random.PRNGKey(12)
    k1, k2 = jax.random.split(key)
    n1, n2 = (torch.from_numpy(np.array(jax.random.normal(k, (64, 1))))
              for k in (k1, k2))
    p0, t0 = copy_params(tts.params), copy_params(tts.extra["target"])
    la0 = tts.extra["log_alpha"].clone()
    jla = jts.extra["log_alpha"]
    np.testing.assert_allclose(float(la0), float(jla), rtol=0)
    (_, _), jcg = jax.value_and_grad(jalgo.critic_loss, has_aux=True)(
        jts.params["critic"], jts.params, jts.extra["target"], jla, jb, k1)
    _, _, tcg = grads_of(talgo.critic_loss, p0["critic"], p0["actor"], t0,
                         la0, tb, n1)
    _check_grads(tcg, jcg)

    jts2, jinfo = jax.jit(jalgo.update)(jts, jb, key)
    tts2, tinfo = talgo.update(tts, tb, noise=(n1, n2))
    assert tts2.step == int(jts2.step) == 1
    for k in ("actor_loss", "alpha", "entropy", "td_abs"):
        np.testing.assert_allclose(tinfo.extra[k].numpy(),
                                   np.asarray(jinfo.extra[k]),
                                   rtol=1e-5, atol=1e-5)
    for t, j in ((tinfo.loss, jinfo.loss), (tinfo.grad_norm, jinfo.grad_norm)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **F32_TOL)
    cb = _check_adam_step(tts2.params["critic"], jts2.params["critic"],
                          p0["critic"], tcg, jcg)
    (_, jlogp), jag = jax.value_and_grad(jalgo.actor_loss, has_aux=True)(
        jts.params["actor"], jts2.params["critic"], jla, jb, k2)
    _, taux, tag = grads_of(talgo.actor_loss, p0["actor"],
                            tts2.params["critic"], la0, tb, n2)
    _check_grads(tag, jag)
    _check_adam_step(tts2.params["actor"], jts2.params["actor"], p0["actor"],
                     tag, jag)
    jalg = jax.grad(jalgo.alpha_loss)(jla, jlogp)
    _, _, talg = grads_of(talgo.alpha_loss, la0, taux["logp"])
    _check_adam_step([tts2.extra["log_alpha"]], [jts2.extra["log_alpha"]],
                     [la0], talg, [jalg])
    assert tts2.extra["log_alpha"] is tts.extra["log_alpha"]  # in place
    _check_targets(tts2.extra["target"]["critic"], t0["critic"],
                   tts2.params["critic"], jts2.extra["target"]["critic"], cb)


def test_td3_delayed_policy_update():
    """The mirror of tests/test_algos.py::test_td3_delayed_policy_update:
    the actor is bit-unchanged after step 1 and moves at step 2."""
    actor = trl.make_ddpg_actor(3, 1, hidden=(8,))
    critic = trl.make_q_critic(3, 1, hidden=(8,))
    algo = TD3(actor.apply, critic.apply, toptim.adam(1e-3),
               toptim.adam(1e-3), policy_delay=2)
    g = torch.Generator().manual_seed(0)
    ts = algo.init_train_state(g, {"actor": actor.init(g),
                                   "critic": critic.init(g)})
    batch = {k: torch.from_numpy(v) for k, v in _batch(8, seed=1).items()}
    a0 = copy_params(ts.params["actor"])
    ts1, info = algo.update(ts, batch, g)
    assert all(torch.equal(a, b) for a, b in zip(
        pytree.tree_leaves(ts1.params["actor"]), pytree.tree_leaves(a0)))
    assert torch.isfinite(info.extra["actor_loss"])
    ts2, _ = algo.update(ts1, batch, g)
    assert max(float((a - b).abs().max()) for a, b in zip(
        pytree.tree_leaves(ts2.params["actor"]), pytree.tree_leaves(a0))) > 0


def test_sac_alpha_autotuning_direction():
    """The mirror of tests/test_algos.py::test_sac_alpha_autotuning_direction:
    with an unreachably high target entropy, alpha must increase."""
    actor = trl.make_sac_actor(3, 1, hidden=(8,))
    critic = trl.make_q_critic(3, 1, hidden=(8,))
    algo = SAC(actor.apply, critic.apply, toptim.adam(1e-3), toptim.adam(1e-3),
               act_dim=1, target_entropy=5.0, alpha_lr=0.1)
    g = torch.Generator().manual_seed(0)
    ts = algo.init_train_state(g, {"actor": actor.init(g),
                                   "critic": critic.init(g)})
    b = _batch(16, seed=2)
    b["return_"][:] = 0.0
    b["bootstrap"][:] = 1.0
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    a0 = float(torch.exp(ts.extra["log_alpha"]))
    for _ in range(5):
        ts, info = algo.update(ts, batch, g)
    assert float(torch.exp(ts.extra["log_alpha"])) > a0
    assert float(info.extra["alpha"]) == float(torch.exp(ts.extra["log_alpha"]))


# ---------------------------------------------------------------------------
# timeout bootstrapping through the replay, the runner
# ---------------------------------------------------------------------------

def test_timeout_bootstrap_through_both_device_replays():
    """A rollout of Pendulum envs with a 5-step limit, horizon 12, carried
    through both packages' DeviceReplay and sampled at the same ages: the
    same observation, next_observation (the pre-reset terminal_obs at the
    limit), bootstrap (1 at the limit: a timeout, not a death), return_ and
    n_used."""
    env = make_env("pendulum", max_episode_steps=5)
    actor = trl.make_ddpg_actor(3, 1, hidden=(8,))
    agent = tagents.make_ddpg_agent(actor, 1)
    sampler = SerialSampler(env, agent, n_envs=4, horizon=12)
    g = torch.Generator().manual_seed(0)
    params = actor.init(g)
    _, rb = sampler.collect(params, sampler.init(g))
    assert rb.done.sum() == 8 and rb.timeout.equal(rb.done)

    cap, B = 64, 40
    treplay = DeviceReplay(cap)
    trs = treplay.insert(treplay.init(transition_example(env)), rb)
    jreplay = JDeviceReplay(cap)
    jrb = JRolloutBatch(**{f: jnp.asarray(getattr(rb, f).numpy())
                           for f in ("observation", "prev_action",
                                     "prev_reward", "action", "reward",
                                     "done", "timeout", "next_observation")},
                        agent_info={})
    jrs = jreplay.insert(jreplay.init(jexample(jmake_env("pendulum"))), jrb)
    key = jax.random.PRNGKey(5)
    jmb, jidx, jw = jreplay.sample(jrs, key, B)
    ages = torch.from_numpy(np.array(
        jax.random.randint(key, (B,), 0, jrs.filled)))
    tmb, tidx, tw = treplay.sample(trs, None, B, draws=ages)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    tb = make_algo_batch(SAC.batch_spec, tmb, {"is_weights": tw})
    jb = jmake_algo_batch(JSAC.batch_spec, jmb, {"is_weights": jw})
    for k in ("observation", "next_observation", "action", "bootstrap",
              "return_", "n_used", "is_weights"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    flat_done = rb.done.flatten(0, 1)[tidx.long()]
    assert flat_done.any() and (tb["bootstrap"] == 1).all()
    np.testing.assert_array_equal(
        tb["next_observation"].numpy(),
        rb.next_observation.flatten(0, 1)[tidx.long()].numpy())
    # at the limit the stored next observation is the pre-reset one, not the
    # next episode's first observation
    obs_next = torch.cat([rb.observation[1:], rb.observation[-1:]]).flatten(
        0, 1)[tidx.long()]
    assert not torch.allclose(tb["next_observation"][flat_done],
                              obs_next[flat_done])


@pytest.mark.parametrize("name,prioritized", [("sac", False), ("td3", False),
                                              ("ddpg", False), ("sac", True)])
def test_qpg_family_through_off_policy_runner(name, prioritized):
    """The mirror of tests/test_train_loop.py::test_qpg_family_through_
    trainloop (and once prioritized, through the sum tree's plain version):
    2 iterations x 2 updates after the warm-up; every logged number finite;
    the tree's priorities moved off the max-priority init."""
    rows = []

    class Rows:
        def record(self, step, metrics):
            rows.append({k: float(v) for k, v in metrics.items()})

    sampler, runner, init = example.make_runner(
        name, 2, hidden=(8,), n_envs=4, horizon=16, replay_capacity=512,
        batch_size=32, updates_per_collect=2, min_replay=64,
        prioritized=prioritized, log_interval=2, logger=Rows())
    params = init(torch.Generator().manual_seed(0))
    ts, ss, info = runner.run(0, params=params, device="cpu")
    assert ts.step == 4 and math.isfinite(float(info.loss))
    assert len(rows) == 1 and all(math.isfinite(v) for v in rows[0].values())
    assert "actor_loss" in rows[0] and ("alpha" in rows[0]) == (name == "sac")
    rs = runner.replay_state
    assert rs.filled == 64 + 2 * 64 and rs.storage["action"].shape == (512, 1)
    leaves = rs.tree[512:512 + rs.filled]
    assert (len(torch.unique(leaves)) > 10) == prioritized


def test_example_defaults_to_cuda_and_runs_on_cpu(capsys):
    ap = example.build_parser()
    assert ap.get_default("device") == "cuda" and ap.get_default("algo") == "sac"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            example.main(["--iters", "1"])
    stats = example.main(["--device", "cpu", "--iters", "1", "--hidden", "8",
                          "--algo", "td3", "--prioritized"])
    assert set(stats) == {"avg_return", "avg_len", "episodes"}
    assert "final stats" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# optimizer pieces
# ---------------------------------------------------------------------------

def test_soft_update_matches_jax_and_returns_new_f32_tensors():
    jp = _jax_qpg_params()
    jt, jo = jp["critic"], _jax_qpg_params(seed=3)["critic"]
    tt, to = rl_params_from_jax(_np(jt)), rl_params_from_jax(_np(jo))
    new = toptim.soft_update(tt, to, TAU)
    _close(new, joptim.soft_update(jt, jo, TAU))
    ptrs = {x.data_ptr() for x in pytree.tree_leaves(tt) +
            pytree.tree_leaves(to)}
    assert all(x.dtype == torch.float32 and x.data_ptr() not in ptrs
               for x in pytree.tree_leaves(new))


@pytest.mark.parametrize("sched", ["constant", "warmup_cosine"])
def test_adamw_and_schedules_match_jax(sched):
    """Five AdamW steps (weight decay 0.01, grad clip 1.0) on the same
    gradients, with a constant rate or linear warm-up then cosine decay."""
    rs = np.random.RandomState(0)
    params = {"a": rs.normal(size=(4, 3)).astype(np.float32),
              "b": rs.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rs.normal(size=v.shape).astype(np.float32) * 3
              for k, v in params.items()} for _ in range(5)]
    lr = (1e-2 if sched == "constant" else
          (joptim.linear_warmup_cosine(1e-2, 2, 5),
           toptim.linear_warmup_cosine(1e-2, 2, 5)))
    jopt = joptim.adam(lr if sched == "constant" else lr[0],
                       weight_decay=0.01, grad_clip=1.0)
    topt = toptim.adam(lr if sched == "constant" else lr[1],
                       weight_decay=0.01, grad_clip=1.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = [torch.from_numpy(params[k].copy()) for k in sorted(params)]
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, js, jn = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 js, jp)
        _, ts, tn = topt.update([torch.from_numpy(g[k]) for k in sorted(g)],
                                ts, tp)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for t, k in zip(tp, sorted(params)):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=1e-6,
                                   atol=1e-7)


def test_linear_warmup_cosine_matches_jax():
    js = joptim.linear_warmup_cosine(3e-4, 10, 100, final_frac=0.2)
    ts = toptim.linear_warmup_cosine(3e-4, 10, 100, final_frac=0.2)
    steps = np.arange(0, 130, dtype=np.int32)
    np.testing.assert_allclose(ts(torch.from_numpy(steps)).numpy(),
                               np.asarray(js(jnp.asarray(steps))), **F32_TOL)


def _adam_before(lr, b1=0.9, b2=0.999, eps=1e-8):
    """The port's Adam update as it was before its per-step scalars moved to
    the params' device: built on the host, copied per tensor."""
    F32 = torch.float32

    @torch.no_grad()
    def update(grads, state, params):
        step = state.step + 1
        step_f = torch.tensor(float(step), dtype=F32)
        lr_t = torch.tensor(lr, dtype=F32)
        bc1 = 1 - torch.tensor(b1, dtype=F32) ** step_f
        bc2 = 1 - torch.tensor(b2, dtype=F32) ** step_f
        for p, g, m, v in zip(params, grads, state.mu, state.nu):
            dev = p.device
            g = g.to(F32)
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            delta = (m / bc1.to(dev)) / (torch.sqrt(v / bc2.to(dev)) + eps)
            p.copy_((p.to(F32) - lr_t.to(dev) * delta).to(p.dtype))
        return params, toptim.OptState(step, state.mu, state.nu)
    return update


def test_adam_scalars_on_the_params_device_change_no_bit():
    """Params, mu and nu bit-identical to the former host-scalar form over
    six steps."""
    rs = np.random.RandomState(1)
    shapes = [(7, 5), (5,), (3, 2, 4)]
    p_new = [torch.from_numpy(rs.normal(size=s).astype(np.float32))
             for s in shapes]
    p_old = [p.clone() for p in p_new]
    opt = toptim.adam(3e-3)
    s_new, s_old = opt.init(p_new), opt.init(p_old)
    old_update = _adam_before(3e-3)
    for _ in range(6):
        grads = [torch.from_numpy(rs.normal(size=s).astype(np.float32))
                 for s in shapes]
        _, s_new, _ = opt.update(grads, s_new, p_new)
        _, s_old = old_update(grads, s_old, p_old)
    for a, b in zip(p_new + s_new.mu + s_new.nu, p_old + s_old.mu + s_old.nu):
        assert torch.equal(a, b)
    assert s_new.step == s_old.step == 6
