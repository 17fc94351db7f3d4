"""The on-policy path of the PyTorch port against the JAX package, on the
CPU: the pytree helpers, ``as_eval``, CartPole one step at a time, the
policy-gradient head and models, the categorical PG agent, ``A2C.update``
and ``PPO.update`` (with JAX's permutations), one on-policy TrainLoop
iteration fed JAX's collected batch, ``EvalSampler``'s episode accounting,
the sentinels (against JAX's ``compute``, bit-identity on and off, the
off-policy channels) and the NaN guard; then the runner and the quickstart
entry point.

Inputs are made from a seed with numpy (or drawn by JAX and handed over as
numpy) and go through both sides.  Tolerances:
- exact for integer and boolean results (done, timeout, episode_step,
  actions, counts);
- CartPole's state after one step: 1e-5 relative + 1e-6 absolute (``cos`` /
  ``sin`` differ in the last ulp between XLA and ATen);
- model outputs, losses, logp, values and sentinel norms: 1e-5 relative +
  1e-6 absolute (the frameworks sum the products of a matmul in other
  orders);
- params after the update: A2C's one Adam step within
  2 lr |g_port - g_jax| / (|g_jax| + eps) + 1e-6 |p| (the bound of
  tests/test_torch_dqn.py); PPO's 16 Adam steps within 4e-6 absolute,
  about 0.6 % of one step of lr 7e-4 (Adam's normalised steps carry a
  gradient's rounding through m / sqrt(v) at most ~lr per step, and the
  rounding is ~1e-7 relative).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro import agents as jagents  # noqa: E402
from repro.algos import A2C as JA2C, PPO as JPPO  # noqa: E402
from repro.core import agent as jagent  # noqa: E402
from repro.core import tree as jtree  # noqa: E402
from repro.core.batch_spec import make_algo_batch as jmake_algo_batch  # noqa: E402
from repro.core.distributions import Categorical as JCategorical  # noqa: E402
from repro.envs import make_env as jmake_env  # noqa: E402
from repro.models import heads as jheads  # noqa: E402
from repro.models import rl_models as jrl  # noqa: E402
from repro.samplers import EvalSampler as JEvalSampler  # noqa: E402
from repro.samplers import SerialSampler as JSerialSampler  # noqa: E402
from repro.telemetry import sentinels as jsent  # noqa: E402
from repro.train.optim import adam as jadam  # noqa: E402
from repro_torch.agents import make_categorical_pg_agent  # noqa: E402
from repro_torch.algos import A2C, PPO  # noqa: E402
from repro_torch.core import agent as tagent  # noqa: E402
from repro_torch.core.algorithm import grads_of  # noqa: E402
from repro_torch.core import tree as ttree  # noqa: E402
from repro_torch.core.distributions import Categorical  # noqa: E402
from repro_torch.envs import cartpole as tcartpole  # noqa: E402
from repro_torch.envs import make_env  # noqa: E402
from repro_torch.examples import catch_dqn_variants as catch_example  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.models import heads as theads  # noqa: E402
from repro_torch.models import rl_models as trl  # noqa: E402
from repro_torch.models.convert import rl_params_from_jax  # noqa: E402
from repro_torch.runners import OnPolicyRunner, TrainLoop  # noqa: E402
from repro_torch.samplers import EvalSampler, RolloutBatch, SerialSampler  # noqa: E402
from repro_torch.samplers.eval import fold_seed  # noqa: E402
from repro_torch.telemetry import sentinels as tsent  # noqa: E402
from repro_torch.telemetry import trace  # noqa: E402
from repro_torch.train.optim import adam  # noqa: E402

import _torch_ranks as mesh_ranks  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-6)
LR = 7e-4


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _shapes(tree):
    """{key path: shape}: torch keeps a dict's insertion order, JAX (and so
    a converted tree) sorts its keys."""
    flat, _ = pytree.tree_flatten_with_path(tree)
    return {pytree.keystr(path): tuple(x.shape) for path, x in flat}


def _leaves(tree):
    return [x.detach().numpy().copy() for x in pytree.tree_leaves(tree)]


class _Rows:
    def __init__(self):
        self.rows = []

    def record(self, step, metrics):
        self.rows.append({k: float(v) for k, v in metrics.items()})


# ---------------------------------------------------------------------------
# core/tree.py and core/agent.py
# ---------------------------------------------------------------------------

def test_tree_helpers_match_jax():
    rs = np.random.RandomState(0)
    # keys in sorted order: JAX flattens dicts sorted, torch in insertion
    # order
    a = {"n": [rs.randint(0, 9, (5,)).astype(np.int32)],
         "w": rs.randn(3, 4).astype(np.float32)}
    b = {"n": [rs.randint(0, 9, (5,)).astype(np.int32)],
         "w": rs.randn(3, 4).astype(np.float32)}
    pred = np.array(True)
    ja, jb = (jax.tree_util.tree_map(jnp.asarray, x) for x in (a, b))
    ta, tb = (pytree.tree_map(torch.from_numpy, x) for x in (a, b))

    def same(t, j):
        for x, y in zip(pytree.tree_leaves(t), jax.tree_util.tree_leaves(j)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), **F32_TOL)
            assert x.shape == y.shape

    same(ttree.tree_select(torch.tensor(False), ta, tb),
         jtree.tree_select(~pred, ja, jb))
    same(ttree.tree_zeros_like(ta), jtree.tree_zeros_like(ja))
    same(ttree.tree_stack([ta, tb], axis=1), jtree.tree_stack([ja, jb], axis=1))
    same(ttree.tree_concat([ta, tb]), jtree.tree_concat([ja, jb]))
    assert ttree.tree_count_params(ta) == jtree.tree_count_params(ja) == 17
    assert ttree.tree_bytes(ta) == jtree.tree_bytes(ja) == 68
    np.testing.assert_allclose(float(ttree.tree_global_norm(ta)),
                               float(jtree.tree_global_norm(ja)), **F32_TOL)
    half = ttree.tree_cast(ta, torch.bfloat16)
    assert half["w"].dtype == torch.bfloat16 and half["n"][0].dtype == torch.int32
    # None leaves (an empty node to JAX) pass through and count as nothing
    assert ttree.tree_zeros_like({"a": None, "b": ta["w"]})["a"] is None
    assert ttree.tree_count_params({"a": None, "b": ta["w"]}) == 12


def test_as_eval_swaps_in_eval_step():
    model = trl.make_pg_mlp(4, 2, hidden=(8,))
    agent = make_categorical_pg_agent(model)
    ev = tagent.as_eval(agent)
    assert ev.step is agent.eval_step and ev.value is agent.value

    class Greedy(tagent.Agent):
        def step(self, *a):
            return "sample"

        def eval_step(self, *a):
            return "greedy"

    g = Greedy(model.init, model.apply, Categorical(2))
    assert tagent.as_eval(g).step() == "greedy" and g.step() == "sample"
    plain = tagent.Agent(model.init, model.apply, Categorical(2))
    assert tagent.as_eval(plain) is plain
    # the JAX function does the same on the same structure
    assert jagent.as_eval(plain) is plain


def test_alternating_mixin_halves():
    m = tagent.AlternatingAgentMixin()
    tree = {"x": torch.arange(6.0), "y": torch.arange(12).reshape(6, 2)}
    a, b = m.split_half(tree)
    assert a["x"].tolist() == [0.0, 1.0, 2.0] and b["y"].shape == (3, 2)
    joined = m.join_halves(a, b)
    assert torch.equal(joined["x"], tree["x"]) and torch.equal(joined["y"], tree["y"])


# ---------------------------------------------------------------------------
# CartPole
# ---------------------------------------------------------------------------

def _cartpole_states(n, seed):
    """Random states, then states within 1e-6 of the x and theta limits
    (velocities 0, so the step moves neither), and t = 499."""
    rs = np.random.RandomState(seed)
    phys = np.stack([rs.uniform(-2.5, 2.5, n), rs.uniform(-3, 3, n),
                     rs.uniform(-0.25, 0.25, n), rs.uniform(-3, 3, n)],
                    -1).astype(np.float32)
    t = rs.randint(0, 500, n).astype(np.int32)
    t[:20] = 499
    xl, tl = np.float32(tcartpole.X_LIMIT), np.float32(tcartpole.THETA_LIMIT)
    edges = []
    for lim, col in ((xl, 0), (tl, 2)):
        for v in (lim, np.nextafter(lim, np.float32(0)),
                  np.nextafter(lim, np.float32(9)), lim - np.float32(1e-6),
                  lim + np.float32(1e-6)):
            for sign in (1, -1):
                row = np.zeros(4, np.float32)
                row[col] = sign * v
                edges.append(row)
    edges = np.array(edges, np.float32)
    phys = np.concatenate([phys, edges])
    t = np.concatenate([t, rs.randint(0, 499, len(edges)).astype(np.int32)])
    action = rs.randint(0, 2, len(phys)).astype(np.int32)
    return phys, t, action


def test_cartpole_step_matches_jax():
    """One step of a few hundred states, from the same state, action and
    reset noise: every output of JAX's vmapped ``step``."""
    phys, t, action = _cartpole_states(300, seed=0)
    B = len(phys)
    jenv = jmake_env("cartpole")
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    jstate = {"phys": jnp.asarray(phys), "t": jnp.asarray(t)}
    js, jobs, jr, jd, jinfo = jax.vmap(jenv.step)(jstate, jnp.asarray(action),
                                                  keys)
    # JAX's reset noise of those keys, handed to the port
    fresh = np.array(jax.vmap(lambda k: jax.random.uniform(
        k, (4,), jnp.float32, -0.05, 0.05))(keys))
    ts, tobs, tr, td, tinfo = tcartpole.step_with_noise(
        {"phys": torch.from_numpy(phys), "t": torch.from_numpy(t)},
        torch.from_numpy(action), torch.from_numpy(fresh))

    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert td.numpy().sum() > 30  # limits, t = 499, random falls
    np.testing.assert_array_equal(tinfo.timeout.numpy(),
                                  np.asarray(jinfo.timeout))
    assert tinfo.timeout.numpy().sum() > 0
    np.testing.assert_array_equal(ts["t"].numpy(), np.asarray(js["t"]))
    np.testing.assert_array_equal(tinfo.episode_step.numpy(),
                                  np.asarray(jinfo.episode_step))
    np.testing.assert_allclose(ts["phys"].numpy(), np.asarray(js["phys"]),
                               **F32_TOL)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), **F32_TOL)
    np.testing.assert_allclose(tinfo.terminal_obs.numpy(),
                               np.asarray(jinfo.terminal_obs), **F32_TOL)
    np.testing.assert_array_equal(tr.numpy(), np.broadcast_to(
        np.asarray(jr), (B,)))
    # the limit rows: done exactly where |state| > the f32 limit
    edge = phys[300:]
    want = (np.abs(edge[:, 0]) > np.float32(tcartpole.X_LIMIT)) | \
        (np.abs(edge[:, 2]) > np.float32(tcartpole.THETA_LIMIT))
    np.testing.assert_array_equal(td.numpy()[300:], want | (t[300:] + 1 >= 500))


def test_cartpole_reset_and_env_spec():
    env = make_env("cartpole")
    jenv = jmake_env("cartpole")
    g = torch.Generator().manual_seed(0)
    state, obs = env.reset(64, g)
    assert obs.shape == (64, 4) and obs.dtype == torch.float32
    assert float(obs.abs().max()) <= 0.05 and state["t"].dtype == torch.int32
    assert torch.equal(state["t"], torch.zeros(64, dtype=torch.int32))
    assert env.action_space.n == jenv.action_space.n == 2
    assert env.observation_space.shape == jenv.observation_space.shape
    assert env.max_episode_steps == jenv.max_episode_steps == 500
    # a fixed action drops the pole within a few dozen steps, and the next
    # episode starts from fresh noise
    a = torch.ones(64, dtype=torch.int32)
    done_any = torch.zeros(64, dtype=torch.bool)
    for _ in range(60):
        state, obs, r, d, info = env.step(state, a, g)
        done_any |= d
        assert torch.all(r == 1.0)
        if d.any():
            assert float(obs[d].abs().max()) <= 0.05
    assert bool(done_any.all())


# ---------------------------------------------------------------------------
# PG head, models, agent
# ---------------------------------------------------------------------------

def test_pg_head_matches_jax():
    rs = np.random.RandomState(1)
    jp = _np(jheads.init_pg_head(jax.random.PRNGKey(0), 16, 3))
    h = rs.randn(5, 16).astype(np.float32)
    jl, jv = jheads.pg_head(jp, jnp.asarray(h))
    tl, tv = theads.pg_head(rl_params_from_jax(jp), torch.from_numpy(h))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **F32_TOL)
    assert tv.shape == (5,)
    tp = theads.init_pg_head(torch.Generator().manual_seed(0), 16, 3)
    assert {k: {kk: tuple(v.shape) for kk, v in d.items()}
            for k, d in tp.items()} == \
        {k: {kk: v.shape for kk, v in d.items()} for k, d in jp.items()}


MODELS = {
    "mlp": (lambda m: m.make_pg_mlp(4, 2), (4,)),
    "mlp_narrow": (lambda m: m.make_pg_mlp(6, 3, hidden=(16, 8, 8)), (6,)),
    "conv": (lambda m: m.make_pg_conv(1, 3, img_hw=(10, 5), channels=(16, 32),
                                      kernels=(3, 3), strides=(1, 1),
                                      d_out=64), (10, 5, 1)),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_pg_models_match_jax(name):
    """The JAX params carried across by ``rl_params_from_jax`` give the same
    logits and value at leading dims [], [B] and [T, B]; the port's own
    init draws the same tree of shapes."""
    make, feat = MODELS[name]
    jm, tm = make(jrl), make(trl)
    jp = _np(jm.init(jax.random.PRNGKey(2)))
    tp = rl_params_from_jax(jp)
    own = tm.init(torch.Generator().manual_seed(0))
    assert _shapes(own) == _shapes(tp)
    rs = np.random.RandomState(3)
    for lead in ((), (5,), (3, 4)):
        obs = rs.rand(*lead, *feat).astype(np.float32)
        jl, jv = jm.apply(jp, jnp.asarray(obs))
        tl, tv = tm.apply(tp, torch.from_numpy(obs))
        assert tuple(tl.shape) == jl.shape and tuple(tv.shape) == jv.shape
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **F32_TOL)


def test_categorical_pg_agent_matches_jax():
    """logp and value of the sampling step (logp of the port's own draw,
    held against JAX's log-likelihood of the same action), the eval step's
    mode and logp, and the bootstrap value; Gumbel-max draws follow the
    softmax."""
    jm, tm = jrl.make_pg_mlp(4, 2), trl.make_pg_mlp(4, 2)
    jagent_ = jagents.make_categorical_pg_agent(jm)
    tagent_ = make_categorical_pg_agent(tm)
    jp = _np(jm.init(jax.random.PRNGKey(4)))
    tp = rl_params_from_jax(jp)
    obs = np.random.RandomState(5).randn(64, 4).astype(np.float32) * 2
    tobs = torch.from_numpy(obs)
    null = (None, None, None)
    ta, tinfo, _ = tagent_.step(tp, torch.Generator().manual_seed(1), tobs,
                                *null)
    jl, jv = jm.apply(jp, jnp.asarray(obs))
    jlogp = JCategorical(2).log_likelihood(jnp.asarray(ta.numpy()), jl)
    np.testing.assert_allclose(tinfo["logp"].numpy(), np.asarray(jlogp), **F32_TOL)
    np.testing.assert_allclose(tinfo["value"].numpy(), np.asarray(jv), **F32_TOL)
    ja, jinfo, _ = jagent_.eval_step(jp, None, jnp.asarray(obs), *null)
    ea, einfo, _ = tagent_.eval_step(tp, None, tobs, *null)
    np.testing.assert_array_equal(ea.numpy(), np.asarray(ja))
    np.testing.assert_allclose(einfo["logp"].numpy(), np.asarray(jinfo["logp"]),
                               **F32_TOL)
    np.testing.assert_allclose(
        tagent_.value(tp, tobs, *null).numpy(),
        np.asarray(jagent_.value(jp, jnp.asarray(obs), *null)), **F32_TOL)
    # 20000 draws of one state: frequencies within 0.015 of the softmax
    one = tobs[:1].expand(20000, 4)
    draws, _, _ = tagent_.step(tp, torch.Generator().manual_seed(2), one, *null)
    p1 = float(torch.softmax(tm.apply(tp, tobs[:1])[0], -1)[0, 1])
    assert abs(float(draws.float().mean()) - p1) < 0.015


# ---------------------------------------------------------------------------
# A2C and PPO updates
# ---------------------------------------------------------------------------

def _rollout(T, B, seed, jparams, jm):
    """A (T, B) rollout-mode algorithm batch as numpy: random CartPole-like
    observations, actions, rewards, dones; value and logp_old from the
    model (logp_old nudged so that some ratios clip)."""
    rs = np.random.RandomState(seed)
    obs = rs.randn(T, B, 4).astype(np.float32)
    action = rs.randint(0, 2, (T, B)).astype(np.int32)
    logits, value = jm.apply(jparams, jnp.asarray(obs))
    logp = np.asarray(JCategorical(2).log_likelihood(jnp.asarray(action),
                                                     logits))
    return {"observation": obs,
            "prev_action": rs.randint(0, 2, (T, B)).astype(np.int32),
            "prev_reward": np.ones((T, B), np.float32),
            "action": action,
            "reward": rs.choice([0.0, 1.0], (T, B)).astype(np.float32),
            "done": rs.rand(T, B) < 0.15,
            "value": np.asarray(value) + rs.randn(T, B).astype(np.float32) * 0.1,
            "logp_old": logp + rs.randn(T, B).astype(np.float32) * 0.3,
            "bootstrap_value": rs.randn(B).astype(np.float32)}


def _check_info(tinfo, jinfo):
    np.testing.assert_allclose(float(tinfo.loss), float(jinfo.loss), **F32_TOL)
    np.testing.assert_allclose(float(tinfo.grad_norm), float(jinfo.grad_norm),
                               **F32_TOL)
    assert set(tinfo.extra) == set(jinfo.extra)
    for k in jinfo.extra:
        np.testing.assert_allclose(float(tinfo.extra[k]), float(jinfo.extra[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


UPDATES = {
    "a2c": ("a2c", dict(gae_lambda=0.95)),
    "a2c_norm_adv": ("a2c", dict(normalize_advantage=True)),
    "ppo": ("ppo", dict()),
    "ppo_value_clip": ("ppo", dict(value_clip=0.2)),
    "ppo_associative_gae_mb3": ("ppo", dict(associative_gae=True, minibatches=3,
                                            epochs=2)),
}


def _algo_pair(kind, kw, grad_clip=0.5):
    cls = {"a2c": (JA2C, A2C), "ppo": (JPPO, PPO)}[kind]
    return (cls[0](jrl.make_pg_mlp(4, 2).apply, jadam(LR, grad_clip=grad_clip),
                   distribution=JCategorical(2), **kw),
            cls[1](trl.make_pg_mlp(4, 2).apply, adam(LR, grad_clip=grad_clip),
                   distribution=Categorical(2), **kw))


def _jax_perms(rng, epochs, n):
    return [np.asarray(jax.random.permutation(k, n))
            for k in jax.random.split(rng, epochs)]


def _check_params(kind, tparams, jparams, tp0, tgrads=None, jgrads=None):
    if kind == "a2c":  # one Adam step: the bound of test_torch_dqn.py
        for p, jpn, p0, g, gj in zip(pytree.tree_leaves(tparams),
                                     jax.tree_util.tree_leaves(jparams), tp0,
                                     tgrads, jax.tree_util.tree_leaves(jgrads)):
            gj = np.asarray(gj)
            bound = (2 * LR * np.abs(g.numpy() - gj) / (np.abs(gj) + 1e-8)
                     + 1e-6 * np.abs(p0) + 1e-9)
            assert np.all(np.abs(p.detach().numpy() - np.asarray(jpn)) <= bound)
    else:
        for p, jpn in zip(pytree.tree_leaves(tparams),
                          jax.tree_util.tree_leaves(jparams)):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jpn),
                                       rtol=0, atol=4e-6)


@pytest.mark.parametrize("case", sorted(UPDATES))
def test_pg_update_matches_jax(case):
    """Same params, same batch (and JAX's permutations for PPO): the info
    scalars and the params after the update."""
    kind, kw = UPDATES[case]
    jalgo, talgo = _algo_pair(kind, kw)
    jm = jrl.make_pg_mlp(4, 2)
    jp = jm.init(jax.random.PRNGKey(6))
    b = _rollout(8, 6, seed=7, jparams=jp, jm=jm)
    jb = {k: jnp.asarray(v) for k, v in b.items() if k in jalgo.batch_spec.fields}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()
          if k in talgo.batch_spec.fields}
    tp = rl_params_from_jax(_np(jp))
    tp0 = _leaves(tp)
    rng = jax.random.PRNGKey(8)
    jts2, jinfo = jax.jit(jalgo.update)(jalgo.init_train_state(None, jp), jb, rng)
    tts = talgo.init_train_state(None, tp)
    tgrads = jgrads = None
    if kind == "a2c":
        _, _, tgrads = grads_of(talgo.loss, tp, tb)
        jgrads = jax.grad(lambda p: jalgo.loss(p, jb)[0])(jp)
        tts2, tinfo = talgo.update(tts, tb)
    else:
        perms = _jax_perms(rng, talgo.epochs, 48)
        tts2, tinfo = talgo.update(tts, tb, perms=perms)
    assert tts2.step == int(jts2.step) == 1
    _check_info(tinfo, jinfo)
    _check_params(kind, tts2.params, jts2.params, tp0, tgrads, jgrads)


def test_ppo_draws_its_own_permutations_and_drops_the_remainder():
    """Without perms the update draws one permutation a epoch from the
    generator (deterministic in its seed); n // minibatches samples a
    minibatch, so a 5-sample remainder is never visited."""
    _, talgo = _algo_pair("ppo", dict(minibatches=4, epochs=2))
    jm = jrl.make_pg_mlp(4, 2)
    jp = jm.init(jax.random.PRNGKey(9))
    b = _rollout(7, 3, seed=10, jparams=jp, jm=jm)  # n = 21, mb 5
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    out = []
    for _ in range(2):
        ts = talgo.init_train_state(None, rl_params_from_jax(_np(jp)))
        ts, info = talgo.update(ts, tb, torch.Generator().manual_seed(3))
        out.append(_leaves(ts.params))
    for x, y in zip(*out):
        np.testing.assert_array_equal(x, y)
    # with these permutations sample 20 is the remainder of both epochs:
    # changing its observation changes nothing (GAE reads the values, not
    # the observations), changing sample 0's does
    perms = [np.arange(21), np.arange(21)]
    res = []
    for flat_index in (None, 20, 0):
        tb2 = dict(tb)
        if flat_index is not None:
            obs = tb["observation"].clone()
            obs[flat_index // 3, flat_index % 3] += 5.0
            tb2["observation"] = obs
        ts = talgo.init_train_state(None, rl_params_from_jax(_np(jp)))
        ts, _ = talgo.update(ts, tb2, perms=perms)
        res.append(_leaves(ts.params))
    for x, y in zip(res[0], res[1]):
        np.testing.assert_array_equal(x, y)
    assert any(not np.array_equal(x, y) for x, y in zip(res[0], res[2]))


# ---------------------------------------------------------------------------
# one on-policy TrainLoop iteration fed JAX's collected batch
# ---------------------------------------------------------------------------

class _Replay(SerialSampler):
    """The port's SerialSampler whose collect hands back a batch collected
    by JAX (and the state JAX ended in)."""

    def __init__(self, env, agent, n_envs, horizon, state, batch):
        super().__init__(env, agent, n_envs, horizon)
        self._out = (state, batch)

    def collect(self, params, state):
        return self._out


def _port_batch(jbatch):
    nb = _np(jbatch)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    return RolloutBatch(**{f: (
        {k: t(v) for k, v in getattr(nb, f).items()} if f == "agent_info"
        else t(getattr(nb, f))) for f in RolloutBatch._fields})


@pytest.mark.parametrize("kind", ["a2c", "ppo"])
def test_on_policy_iteration_matches_jax(kind):
    """JAX collects 4 CartPole envs x 8 steps and runs its TrainLoop
    iteration (collect -> bootstrap_value -> make_algo_batch -> update);
    the port's iteration gets JAX's batch and final sampler state and must
    land on the same params and info.  A2C goes through ``iteration`` with
    sentinels on; PPO through ``on_policy_update`` with JAX's
    permutations."""
    jalgo, talgo = _algo_pair(kind, dict(gae_lambda=0.95), grad_clip=1.0)
    jm, tm = jrl.make_pg_mlp(4, 2), trl.make_pg_mlp(4, 2)
    jsampler = JSerialSampler(jmake_env("cartpole"),
                              jagents.make_categorical_pg_agent(jm), 4, 8)
    jp = jm.init(jax.random.PRNGKey(11))
    jss = jsampler.init(jax.random.PRNGKey(12))
    jss2, jbatch = jax.jit(jsampler.collect)(jp, jss)
    jbootstrap = jsampler.bootstrap_value(jp, jss2)
    jab = jmake_algo_batch(jalgo.batch_spec, jbatch,
                           {"bootstrap_value": jbootstrap})
    k = jax.random.PRNGKey(13)
    jts2, jinfo = jax.jit(jalgo.update)(jalgo.init_train_state(None, jp), jab, k)

    tagent_ = make_categorical_pg_agent(tm)
    real = SerialSampler(make_env("cartpole"), tagent_, 4, 8)
    ss = real.init(torch.Generator().manual_seed(0))
    ss2 = ss._replace(obs=torch.from_numpy(np.array(jss2.obs)),
                      prev_action=torch.from_numpy(np.array(jss2.prev_action)),
                      prev_reward=torch.from_numpy(np.array(jss2.prev_reward)))
    sampler = _Replay(make_env("cartpole"), tagent_, 4, 8, ss2,
                      _port_batch(jbatch))
    np.testing.assert_allclose(
        sampler.bootstrap_value(rl_params_from_jax(_np(jp)), ss2).numpy(),
        np.asarray(jbootstrap), **F32_TOL)
    loop = TrainLoop(sampler, talgo, sentinels=True)
    ts = talgo.init_train_state(None, rl_params_from_jax(_np(jp)))
    if kind == "a2c":
        ts2, _, rs, tinfo, sent = loop.iteration(ts, ss, None,
                                                 torch.Generator())
        assert rs is None and int(sent.env_steps) == 32
        assert float(sent.loss) == float(tinfo.loss)
        assert float(sent.update_norm) > 0
    else:
        perms = _jax_perms(k, talgo.epochs, 32)
        ss_out, batch = sampler.collect(None, ss)
        ts2, tinfo = loop.on_policy_update(ts, ss_out, batch, None, draws=perms)
    _check_info(tinfo, jinfo)
    for p, jpn in zip(pytree.tree_leaves(ts2.params),
                      jax.tree_util.tree_leaves(jts2.params)):
        np.testing.assert_allclose(p.numpy(), np.asarray(jpn), rtol=0,
                                   atol=4e-6)


# ---------------------------------------------------------------------------
# EvalSampler
# ---------------------------------------------------------------------------

class _FakeBatch:
    def __init__(self, reward, done):
        self.reward, self.done = reward, done


def _jax_episode_stats(reward, done, max_episodes):
    """JAX's EvalSampler accounting on a handmade batch: its collect is
    replaced on the instance, the rest of ``_run_impl`` runs as shipped."""
    T, B = reward.shape
    jm = jrl.make_pg_mlp(4, 2)
    ev = JEvalSampler(jmake_env("cartpole"),
                      jagents.make_categorical_pg_agent(jm), B, T * B,
                      max_episodes=max_episodes)
    ev._sampler.collect = lambda params, state: (
        state, _FakeBatch(jnp.asarray(reward), jnp.asarray(done)))
    return ev._run_impl(jm.init(jax.random.PRNGKey(0)), jax.random.PRNGKey(1))


EPISODES = {
    # three envs, six steps: env 0 ends at t 1 and 4, env 1 at t 1, 2 and 5,
    # env 2 never; completion order decides which count under a budget
    "no_cap": None, "cap_2": 2, "cap_4": 4, "none_done": 3,
}


@pytest.mark.parametrize("case", sorted(EPISODES))
def test_eval_episode_accounting_matches_jax(case):
    rs = np.random.RandomState(14)
    reward = rs.uniform(0.0, 2.0, (6, 3)).astype(np.float32)
    done = np.zeros((6, 3), bool)
    if case != "none_done":
        done[[1, 4], 0] = True
        done[[1, 2, 5], 1] = True
    cap = EPISODES[case]
    want = _jax_episode_stats(reward, done, cap)
    ev = EvalSampler(make_env("cartpole"),
                     make_categorical_pg_agent(trl.make_pg_mlp(4, 2)), 3, 18,
                     max_episodes=cap)
    got = ev.episode_stats(torch.from_numpy(reward), torch.from_numpy(done))
    assert int(got["episodes"]) == int(want["episodes"])
    assert int(got["episodes"]) == {"no_cap": 5, "cap_2": 2, "cap_4": 4,
                                    "none_done": 0}[case]
    for k in ("avg_return", "avg_len"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)


def test_eval_sampler_run_is_greedy_and_deterministic():
    tm = trl.make_pg_mlp(4, 2)
    agent = make_categorical_pg_agent(tm)
    ev = EvalSampler(make_env("cartpole"), agent, 4, 200, max_episodes=3)
    assert ev.agent.step is agent.eval_step and ev.horizon == 50
    params = tm.init(torch.Generator().manual_seed(0))
    a = ev.run(params, torch.Generator().manual_seed(5))
    b = ev.run(params, torch.Generator().manual_seed(5))
    assert {k: float(v) for k, v in a.items()} == \
        {k: float(v) for k, v in b.items()}
    assert set(a) == {"avg_return", "avg_len", "episodes", "steps",
                      "param_nonfinite"}
    assert int(a["steps"]) == 200 and int(a["param_nonfinite"]) == 0
    assert 0 < int(a["episodes"]) <= 3
    bad = pytree.tree_map(lambda p: p.clone(), params)
    bad["head"]["pi"]["b"][0] = float("nan")
    assert int(ev.run(bad, torch.Generator().manual_seed(5))
               ["param_nonfinite"]) == 1
    with pytest.raises(ValueError, match="max_steps"):
        EvalSampler(make_env("cartpole"), agent, 8, 4)


def test_fold_seed_forks_distinct_streams():
    s = fold_seed(2, 0xE7A1)
    assert s == fold_seed(2, 0xE7A1) and 0 <= s < 2 ** 63
    seeds = {fold_seed(s, it) for it in range(0, 1000, 10)}
    assert len(seeds) == 100 and s not in seeds
    assert fold_seed(3, 0xE7A1) != s


def _a2c_runner(n_iterations, log_interval, logger, lr=1e-3, **kw):
    env = make_env("cartpole")
    tm = trl.make_pg_mlp(4, 2)
    agent = make_categorical_pg_agent(tm)
    algo = A2C(tm.apply, adam(lr), distribution=Categorical(2))
    sampler = SerialSampler(env, agent, n_envs=8, horizon=16)
    return sampler, OnPolicyRunner(sampler, algo, n_iterations=n_iterations,
                                   log_interval=log_interval, logger=logger,
                                   **kw)


def test_evaluation_changes_no_training_draw():
    """Runs with and without an EvalSampler end on the same params bit for
    bit; the eval columns are in every row."""
    out = []
    for with_eval in (False, True):
        logger = _Rows()
        ev = (EvalSampler(make_env("cartpole"),
                          make_categorical_pg_agent(trl.make_pg_mlp(4, 2)),
                          4, 80, max_episodes=4) if with_eval else None)
        _, runner = _a2c_runner(6, 2, logger, eval_sampler=ev)
        ts, _, _ = runner.run(0, device="cpu")
        out.append((_leaves(ts.params), logger.rows))
    for x, y in zip(out[0][0], out[1][0]):
        np.testing.assert_array_equal(x, y)
    assert len(out[1][1]) == 3
    assert all("eval_avg_return" in r and "eval_avg_return" not in r0
               for r, r0 in zip(out[1][1], out[0][1]))


# ---------------------------------------------------------------------------
# sentinels and the NaN guard
# ---------------------------------------------------------------------------

def test_sentinels_compute_matches_jax():
    jm = jrl.make_pg_mlp(4, 2)
    prev = _np(jm.init(jax.random.PRNGKey(15)))
    new = _np(jm.init(jax.random.PRNGKey(16)))
    new["trunk"][0]["w"][0, :3] = [np.nan, np.inf, -np.inf]
    js = jsent.compute(prev, new, 1.5, 2.5, None, 128)
    ts = tsent.compute(rl_params_from_jax(prev), rl_params_from_jax(new),
                       torch.tensor(1.5), torch.tensor(2.5), None, 128)
    assert ts._fields == js._fields
    for name in js._fields:  # nan norms compare equal
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), **F32_TOL,
                                   err_msg=name)
    assert int(ts.nonfinite_params) == 3
    clean = _np(jm.init(jax.random.PRNGKey(16)))
    js = jsent.compute(prev, clean, 1.5, 2.5, None, 128)
    ts = tsent.compute(rl_params_from_jax(prev), rl_params_from_jax(clean),
                       torch.tensor(1.5), torch.tensor(2.5), None, 128)
    for name in ("param_norm", "update_norm"):
        np.testing.assert_allclose(float(getattr(ts, name)),
                                   float(getattr(js, name)), **F32_TOL)
    stacked = ttree.tree_stack([ts, ts._replace(loss=torch.tensor(3.5))])
    row = tsent.summarize(stacked)
    jrow = jsent.summarize(jtree.tree_stack([js, js._replace(
        loss=jnp.float32(3.5))]))
    assert row.keys() == jrow.keys()
    for k in row:
        np.testing.assert_allclose(row[k], jrow[k], rtol=1e-6, err_msg=k)
    assert tsent.first_nonfinite_iter(stacked) is None
    # replicate on 2 gloo ranks (rank i holding shard i) against JAX's
    # under vmap(axis_name="data"): pmean / pmax / psum field by field,
    # bit for bit (two terms a sum)
    shards = [ts, ts._replace(loss=torch.tensor(3.5),
                              env_steps=torch.tensor(64, dtype=torch.int32),
                              nonfinite_grads=torch.tensor(
                                  1, dtype=torch.int32))]
    vals = {k: np.stack([getattr(x, k).numpy() for x in shards])
            for k in ts._fields}
    want = jax.vmap(lambda s: jsent.replicate(s, "data"), axis_name="data")(
        jsent.Sentinels(**{k: jnp.asarray(v) for k, v in vals.items()}))
    for r, got in enumerate(mesh_ranks.run_ranks(
            mesh_ranks.replicate_body, 2, vals)):
        for k in ts._fields:
            w = np.asarray(getattr(want, k)[r])
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_sentinels_are_pure_reads():
    """Sentinels on and off: the same params bit for bit after a window;
    the update norm is > 0 (the loop copies the params before the in-place
    update); the window's row is finite."""
    out = []
    for on in (False, True):
        sampler, runner = _a2c_runner(5, 5, _Rows())
        loop = TrainLoop(sampler, runner.algo, sentinels=on)
        ts = runner.algo.init_train_state(
            None, sampler.agent.init_params(torch.Generator().manual_seed(0)))
        ss = sampler.init(torch.Generator().manual_seed(1))
        ts, ss, _, info, sents = loop.run_window(
            ts, ss, None, torch.Generator().manual_seed(2), 5)
        out.append((_leaves(ts.params), sents, info))
    for x, y in zip(out[0][0], out[1][0]):
        np.testing.assert_array_equal(x, y)
    assert out[0][1] is None
    sents = out[1][1]
    assert sents.loss.shape == (5,)
    assert float(sents.update_norm.min()) > 0
    row = tsent.summarize(sents)
    assert row["sent_window_iters"] == 5 and row["sent_env_steps"] == 5 * 128
    assert row["sent_nonfinite_params"] == 0 and row["sent_grad_norm"] > 0
    assert all(math.isfinite(v) for v in row.values())
    assert float(sents.loss[-1]) == float(out[1][2].loss)


def test_nan_guard_reports_first_bad_iteration():
    """An lr that goes inf at the 3rd update poisons the params at window
    index 2: the guard names iteration 2 and emits a nan_guard event."""
    tracer = trace.configure(None)
    try:
        env = make_env("cartpole")
        tm = trl.make_pg_mlp(4, 2)
        algo = A2C(tm.apply, adam(lambda step: torch.where(
            step >= 3, torch.inf, 1e-3)), distribution=Categorical(2))
        sampler = SerialSampler(env, make_categorical_pg_agent(tm), 8, 16)
        runner = OnPolicyRunner(sampler, algo, n_iterations=6, log_interval=6,
                                logger=_Rows(), nan_guard=True)
        with pytest.raises(tsent.NonFiniteError) as ei:
            runner.run(0, device="cpu")
        assert ei.value.iteration == 2 and ei.value.n_bad > 0
        guards = [e for e in tracer.events if e["kind"] == "nan_guard"]
        assert guards and guards[-1]["iteration"] == 2
    finally:
        trace.reset()


def _lm_ppo_step(record: bool):
    """One LM-PPO train step of smoke gemma2-2b over two microbatches, from
    the same weights and batch each call; the tracer configured or not.
    Returns (metrics, params, the tracer's span events)."""
    import copy
    from repro_torch.algos.pg.ppo import make_lm_ppo_train_step
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import backbones as bb
    cfg = get_smoke_config("gemma2-2b")
    lm = bb.init_lm(cfg, device="cpu", dtype=torch.float32,
                    generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    rng = np.random.RandomState(1)
    B, T = 4, 6
    batch = {"tokens": torch.from_numpy(
                 rng.randint(0, cfg.vocab, (B, T)).astype(np.int32)),
             "actions": torch.from_numpy(
                 rng.randint(0, cfg.vocab, (B, T)).astype(np.int32))}
    for k in ("logp_old", "advantage", "return_"):
        batch[k] = torch.from_numpy(rng.randn(B, T).astype(np.float32))
    batch["logp_old"] = -batch["logp_old"].abs() - 5.0
    opt = adam(1e-3, grad_clip=1.0)
    state = opt.init(lm.parameters())
    step = make_lm_ppo_train_step(cfg, opt, n_microbatches=2)
    tracer = trace.configure(None) if record else trace.reset()
    try:
        lm, state, met = step(copy.deepcopy(lm), state, batch)
    finally:
        trace.reset()
    spans = [e for e in tracer.events if e["kind"] == "span"]
    return met, [p.detach() for p in lm.parameters()], spans


def test_lm_ppo_step_spans_and_bit_identity():
    """The LM-PPO step records ``ppo.step`` holding ``ppo.forward`` and
    ``ppo.backward`` once a microbatch and ``optim.update`` once; with the
    tracer on, the loss and the updated weights are bit for bit those of
    a step that records nothing (which leaves no event)."""
    met_off, params_off, spans_off = _lm_ppo_step(False)
    met_on, params_on, spans = _lm_ppo_step(True)
    assert spans_off == []
    for k in met_off:
        assert torch.equal(met_off[k], met_on[k]), k
    for a, b in zip(params_off, params_on):
        assert torch.equal(a, b)
    (top,) = [e for e in spans if e["name"] == "ppo.step"]
    assert top["parent"] is None and top["microbatches"] == 2
    kids = [(e["name"], e.get("microbatch")) for e in spans
            if e["parent"] == top["id"]]
    assert kids == [("ppo.forward", 0), ("ppo.backward", 0),
                    ("ppo.forward", 1), ("ppo.backward", 1),
                    ("optim.update", None)]
    assert all(e["t0_ns"] >= top["t0_ns"] and e["t1_ns"] <= top["t1_ns"]
               for e in spans if e["parent"] == top["id"])


def test_off_policy_sentinels_read_the_replay():
    """sentinels on the replayed path: the replay channels are the ring's
    fill, the tree's root and its largest leaf."""
    sampler, runner = catch_example.make_runner("rainbow", 2,
                                                replay_capacity=1024,
                                                min_replay=256,
                                                log_interval=2, logger=_Rows())
    loop = TrainLoop(sampler, runner.algo, replay=runner.replay, batch_size=64,
                     updates_per_collect=2, sentinels=True)
    ts, ss, _ = runner.run(0, device="cpu")
    ts, ss, rs, info, sent = loop.iteration(ts, ss, runner.replay_state,
                                            torch.Generator().manual_seed(4))
    size = rs.tree.shape[0] // 2
    assert float(sent.replay_filled) == rs.filled == 1024
    assert float(sent.replay_priority_mass) == float(rs.tree[1]) > 0
    assert float(sent.replay_priority_max) == float(rs.tree[size:].max())
    assert int(sent.env_steps) == 256 and int(sent.nonfinite_params) == 0


# ---------------------------------------------------------------------------
# runner and entry point
# ---------------------------------------------------------------------------

def test_on_policy_runner_defaults_to_cuda_and_refuses_checkpoints(tmp_path):
    """The runner defaults to the card.  Checkpoints are no longer refused
    (their tests are in tests/test_torch_checkpoint.py): ``restore=True``
    with no checkpoint to restore trains from iteration 0, and ``ckpt_dir``
    constructs and saves."""
    _, runner = _a2c_runner(1, 1, _Rows())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            runner.run(0)
    ts, _, _ = runner.run(0, restore=True, device="cpu")
    assert ts.step == 1
    _, runner = _a2c_runner(2, 1, _Rows(), ckpt_dir=str(tmp_path),
                            ckpt_interval=1)
    ts, _, _ = runner.run(0, restore=True, device="cpu")
    assert ts.step == 2
    assert sorted(p.name for p in tmp_path.glob("*.json")) == [
        "step_0000000001.json", "step_0000000002.json"]


def test_quickstart_defaults_and_cpu_run(tmp_path, capsys):
    ap = quickstart.build_parser()
    assert ap.get_default("device") == "cuda" and ap.get_default("iters") == 50
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            quickstart.main(["--iters", "1"])
    stats = quickstart.main(["--device", "cpu", "--iters", "10",
                             "--log-dir", str(tmp_path)])
    assert set(stats) == {"avg_return", "avg_len", "episodes"}
    assert "final stats" in capsys.readouterr().out
    import json
    rows = [json.loads(ln) for ln in
            (tmp_path / "progress.jsonl").read_text().splitlines()]
    assert len(rows) == 1
    row = rows[0]
    assert row["iter"] == 10 and row["sent_nonfinite_params"] == 0
    assert row["eval_steps"] == 2000 and 0 <= row["eval_episodes"] <= 8
    assert row["sent_env_steps"] == 10 * 16 * 64
    assert all(math.isfinite(v) for v in row.values()
               if isinstance(v, float))


def test_discounted_returns_matches_jax():
    """``algos/pg/gae.py::discounted_returns`` (A2C's n-step target) and
    its ``repro_torch.algos`` re-export against JAX's on the same (T, B)
    rewards, dones and bootstrap: within 1e-6 (f32, one recurrence)."""
    from repro.algos import discounted_returns as jret
    from repro_torch.algos import discounted_returns as tret
    r = np.random.RandomState(5)
    rew = r.randn(9, 4).astype(np.float32)
    done = r.rand(9, 4) < 0.2
    boot = r.randn(4).astype(np.float32)
    want = jret(jnp.asarray(rew), jnp.asarray(boot), jnp.asarray(done),
                gamma=0.97)
    got = tret(torch.from_numpy(rew), torch.from_numpy(boot),
               torch.from_numpy(done), gamma=0.97)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
