"""The RL core of the PyTorch port against the JAX package, on the CPU:
namedarraytuple (the cases of tests/test_narrtup.py), the leading-dims
protocol, spaces, the discrete distributions, the batch contract, the Catch
env, the Q models (plain, dueling, C51; conv and MLP) with JAX weights
carried by ``models/convert.py``, and the DQN agent.

Inputs are made from a seed with numpy (or drawn by JAX and handed over as
numpy) and go through both sides.  Tolerances: exact for integer and
boolean results (env state, actions, indices); f32 results within 1e-5
relative + 1e-6 absolute (the two frameworks sum the products of a matmul
or a convolution in other orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro import agents as jagents  # noqa: E402
from repro.core import distributions as jdist  # noqa: E402
from repro.core import leading_dims as jld  # noqa: E402
from repro.core import batch_spec as jbs  # noqa: E402
from repro.envs import make_env as jmake_env  # noqa: E402
from repro.models import rl_models as jrl  # noqa: E402
from repro_torch import agents as tagents  # noqa: E402
from repro_torch.core import batch_spec as tbs  # noqa: E402
from repro_torch.core import distributions as tdist  # noqa: E402
from repro_torch.core import leading_dims as tld  # noqa: E402
from repro_torch.core.narrtup import (buffer_from_example, buffer_method,  # noqa: E402
                                      get_leading_dims, is_namedarraytuple,
                                      namedarraytuple)
from repro_torch.core.spaces import Box, Discrete  # noqa: E402
from repro_torch.envs import catch as tcatch  # noqa: E402
from repro_torch.envs import make_env  # noqa: E402
from repro_torch.envs.base import EnvInfo  # noqa: E402
from repro_torch.models import rl_models as trl  # noqa: E402
from repro_torch.models.convert import rl_params_from_jax  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-6)

Pair = namedarraytuple("Pair", ["a", "b"])
Nested = namedarraytuple("Nested", ["x", "pair"])


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def _shapes(tree):
    flat, _ = pytree.tree_flatten_with_path(tree)
    return {pytree.keystr(path): tuple(x.shape) for path, x in flat}


# ---------------------------------------------------------------------------
# namedarraytuple: the cases of tests/test_narrtup.py, on torch leaves
# ---------------------------------------------------------------------------

def test_narrtup_memoized_class():
    assert namedarraytuple("Pair", ["a", "b"]) is Pair


def test_narrtup_indexed_write_syntax():
    dest = Pair(a=torch.zeros(10, 3), b=torch.zeros(10))
    dest[3:5] = Pair(a=torch.ones(2, 3), b=np.ones(2))
    assert float(dest.a[3:5].sum()) == 6 and float(dest.b[3:5].sum()) == 2
    assert float(dest.a[:3].sum()) == 0


def test_narrtup_none_placeholder_and_scalar_broadcast():
    dest = Pair(a=torch.zeros(4), b=None)
    dest[1] = Pair(a=np.float64(5), b=None)
    assert float(dest.a[1]) == 5
    dest = Pair(a=torch.zeros(4, 2), b=torch.zeros(4))
    dest[2] = 7
    assert float(dest.a[2].sum()) == 14 and float(dest.b[2]) == 7


def test_narrtup_nested_write_and_read():
    dest = Nested(x=torch.zeros(6), pair=Pair(a=torch.zeros(6, 2), b=None))
    dest[4] = Nested(x=torch.ones(()), pair=Pair(a=torch.full((2,), 3.0), b=None))
    out = dest[4]
    assert float(out.x) == 1 and bool((out.pair.a == 3).all()) and out.pair.b is None


def test_narrtup_pytree_roundtrip():
    """Flatten / unflatten / tree_map through torch.utils._pytree keep the
    class and the fields; the same tree through JAX's pytree gives the same
    leaves."""
    p = Nested(x=torch.arange(4.0), pair=Pair(a=torch.ones(4, 2), b=torch.zeros(4)))
    leaves, spec = pytree.tree_flatten(p)
    assert len(leaves) == 3
    back = pytree.tree_unflatten([x * 2 for x in leaves], spec)
    assert is_namedarraytuple(back) and is_namedarraytuple(back.pair)
    assert torch.equal(back.x, torch.arange(4.0) * 2)
    doubled = pytree.tree_map(lambda x: x * 2, p)
    assert type(doubled) is Nested and torch.equal(doubled.pair.a, back.pair.a)
    JPair = __import__("repro.core.narrtup", fromlist=["x"]).namedarraytuple(
        "Pair", ["a", "b"])
    jp = JPair(a=jnp.arange(4.0), b=jnp.ones((4, 2)))
    jl = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda x: x * 2, jp))
    tl = pytree.tree_leaves(pytree.tree_map(
        lambda x: x * 2, Pair(a=torch.arange(4.0), b=torch.ones(4, 2))))
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_narrtup_functional_at_set_and_add():
    p = Pair(a=torch.zeros(5), b=torch.zeros(5, 2))
    q = p.at[2].set(Pair(a=1.0, b=torch.ones(2)))
    assert float(q.a[2]) == 1 and bool((q.b[2] == 1).all()) and float(q.a[0]) == 0
    assert float(p.a[2]) == 0  # functional: the source is unchanged
    r = p.at[torch.tensor([1, 1, 3])].add(Pair(a=1.0, b=None))
    assert r.a.tolist() == [0.0, 2.0, 0.0, 1.0, 0.0]


def test_narrtup_buffers_and_leading_dims():
    ex = Pair(a=np.zeros((3,), np.float32), b=np.zeros((), np.int32))
    buf = buffer_from_example(ex, (7, 2))
    assert buf.a.shape == (7, 2, 3) and buf.b.shape == (7, 2)
    tbuf = buffer_from_example(ex, 5, use_numpy=False)
    assert tbuf.a.dtype == torch.float32 and tbuf.b.dtype == torch.int32
    assert get_leading_dims(buf, 2) == (7, 2)
    with pytest.raises(ValueError):
        get_leading_dims(Pair(a=torch.zeros(3, 2), b=torch.zeros(4)), 1)
    out = buffer_method(Pair(a=torch.zeros(2), b=None), "to", torch.int64)
    assert out.a.dtype == torch.int64 and out.b is None


@pytest.mark.parametrize("n,i,k", [(2, 1, 1), (7, 3, 5), (20, 19, 2)])
def test_narrtup_write_read_roundtrip(n, i, k):
    rs = np.random.RandomState(n * 100 + i)
    dest = Pair(a=torch.zeros(n, k, dtype=torch.float64),
                b=torch.zeros(n, dtype=torch.float64))
    val = Pair(a=rs.randn(k), b=rs.randn())
    dest[i] = val
    out = dest[i]
    np.testing.assert_array_equal(out.a.numpy(), val.a)
    assert float(out.b) == val.b


def test_narrtup_fancy_index():
    idxs = np.asarray([0, 9, 3, 3, 7])
    dest = Pair(a=torch.arange(10.0), b=torch.arange(10.0) * 2)
    out = dest[torch.from_numpy(idxs)]
    np.testing.assert_array_equal(out.a.numpy(), idxs.astype(np.float32))
    np.testing.assert_array_equal(out.b.numpy(), idxs.astype(np.float32) * 2)


# ---------------------------------------------------------------------------
# leading dims, spaces, distributions, batch spec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3,), (5, 3), (4, 5, 3)])
def test_leading_dims_match_jax(shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    jl, jT, jB, jf = jld.infer_leading_dims(jnp.asarray(x), 1)
    tl, tT, tB, tf = tld.infer_leading_dims(torch.from_numpy(x), 1)
    assert (jl, jT, jB) == (tl, tT, tB)
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    np.testing.assert_array_equal(
        np.asarray(jld.restore_leading_dims(jf * 2, jl, jT, jB)),
        tld.restore_leading_dims(tf * 2, tl, tT, tB).numpy())
    with pytest.raises(ValueError):
        tld.infer_leading_dims(torch.zeros((1,) * 4 + (3,)), 1)


def test_spaces_null_values_and_samples():
    box = Box(0.0, 1.0, shape=(10, 5, 1))
    assert box.null_value().shape == (10, 5, 1) and box.null_value().dtype == np.float32
    assert Discrete(3).null_value().dtype == np.int32
    g = torch.Generator().manual_seed(0)
    s = box.sample(g, (4,))
    assert s.shape == (4, 10, 5, 1) and float(s.min()) >= 0 and float(s.max()) <= 1
    a = Discrete(3).sample(g, (100,))
    assert a.dtype == torch.int32 and set(a.tolist()) <= {0, 1, 2}


def test_categorical_matches_jax():
    rs = np.random.RandomState(1)
    lp, lq = rs.randn(2, 6, 5).astype(np.float32)
    act = rs.randint(0, 5, size=6)
    jc, tc = jdist.Categorical(5), tdist.Categorical(5)
    tp, tq = torch.from_numpy(lp), torch.from_numpy(lq)
    for jv, tv in ((jc.log_likelihood(jnp.asarray(act), jnp.asarray(lp)),
                    tc.log_likelihood(torch.from_numpy(act), tp)),
                   (jc.entropy(jnp.asarray(lp)), tc.entropy(tp)),
                   (jc.kl(jnp.asarray(lp), jnp.asarray(lq)), tc.kl(tp, tq))):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **F32_TOL)
    np.testing.assert_array_equal(tc.mode(tp).numpy(), np.asarray(jc.mode(jnp.asarray(lp))))
    draws = tc.sample(torch.Generator().manual_seed(0), tp.expand(4000, 6, 5)[:, 0])
    freq = np.bincount(draws.numpy(), minlength=5) / 4000
    np.testing.assert_allclose(freq, np.asarray(jax.nn.softmax(lp[0])), atol=0.03)


@pytest.mark.parametrize("eps", [0.0, 0.3, "vector"])
def test_epsilon_greedy_same_draws_same_actions(eps):
    """JAX's EpsilonGreedy.sample draws u and the random action from split
    keys; handed those draws, the port's select gives the same actions."""
    B, A = 64, 3
    q = np.random.RandomState(2).randn(B, A).astype(np.float32)
    epsilon = (jnp.linspace(0.0, 1.0, B) if eps == "vector" else eps)
    key = jax.random.PRNGKey(5)
    want = jdist.EpsilonGreedy(A).sample(key, jnp.asarray(q), epsilon)
    rng_u, rng_a = jax.random.split(key)
    greedy = jnp.argmax(jnp.asarray(q), axis=-1)
    rand = jax.random.randint(rng_a, greedy.shape, 0, A, dtype=greedy.dtype)
    u = jax.random.uniform(rng_u, greedy.shape)
    got = tdist.EpsilonGreedy.select(torch.from_numpy(q),
                                     torch.tensor(np.asarray(epsilon, np.float32)),
                                     torch.tensor(np.asarray(u)),
                                     torch.tensor(np.asarray(rand)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(
        tdist.EpsilonGreedy.apex_epsilons(8).numpy(),
        np.asarray(jdist.EpsilonGreedy.apex_epsilons(8)), **F32_TOL)


def test_batch_spec_derives_transition_fields_like_jax():
    rs = np.random.RandomState(3)
    data = {"observation": rs.randn(6, 2).astype(np.float32),
            "action": rs.randint(0, 3, 6).astype(np.int32),
            "reward": rs.randn(6).astype(np.float32),
            "done": rs.rand(6) < 0.5, "timeout": rs.rand(6) < 0.5,
            "next_observation": rs.randn(6, 2).astype(np.float32)}
    fields = ("observation", "action", "return_", "bootstrap",
              "next_observation", "n_used", "is_weights")
    w = rs.rand(6).astype(np.float32)
    jb = jbs.make_algo_batch(jbs.BatchSpec("transition", fields),
                             {k: jnp.asarray(v) for k, v in data.items()},
                             {"is_weights": jnp.asarray(w)})
    tb = tbs.make_algo_batch(tbs.BatchSpec("transition", fields),
                             {k: torch.from_numpy(v) for k, v in data.items()},
                             {"is_weights": torch.from_numpy(w)})
    assert list(tb) == list(fields)
    for k in fields:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    with pytest.raises(KeyError):
        tbs.make_algo_batch(tbs.BatchSpec("transition", ("bogus",)),
                            {k: torch.from_numpy(v) for k, v in data.items()})


# ---------------------------------------------------------------------------
# Catch
# ---------------------------------------------------------------------------

def test_catch_matches_jax_over_random_steps():
    """The same state, action and reset noise give JAX's next state, obs,
    reward, done and info, over 300 steps of 8 envs with random actions."""
    B, steps = 8, 300
    jenv = jmake_env("catch")
    jstep = jax.jit(jax.vmap(jenv.step))
    fresh_col = jax.jit(jax.vmap(lambda k: jax.random.randint(k, (), 0, 5)))
    key = jax.random.PRNGKey(11)
    js, jobs = jax.vmap(jenv.reset)(jax.random.split(key, B))
    ts = {k: torch.tensor(np.asarray(v)) for k, v in js.items()}
    np.testing.assert_array_equal(
        np.asarray(jobs),
        tcatch._obs(ts["ball_r"], ts["ball_c"], ts["paddle_c"], 10, 5).numpy())
    acts = np.random.RandomState(4).randint(0, 3, size=(steps, B)).astype(np.int32)
    n_done = 0
    for t in range(steps):
        keys = jax.random.split(jax.random.fold_in(key, t), B)
        js, jobs, jr, jd, jinfo = jstep(js, jnp.asarray(acts[t]), keys)
        ts, tobs, tr, td, tinfo = tcatch.step_with_noise(
            ts, torch.from_numpy(acts[t]),
            torch.tensor(np.asarray(fresh_col(keys))))
        for k in ("ball_r", "ball_c", "paddle_c"):
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        assert isinstance(tinfo, EnvInfo)
        for k in ("timeout", "episode_step", "terminal_obs"):
            np.testing.assert_array_equal(getattr(tinfo, k).numpy(),
                                          np.asarray(getattr(jinfo, k)))
        n_done += int(td.sum())
    assert n_done == B * (steps // 9)  # one episode every rows - 1 steps


def test_make_env_catch_and_token_lm():
    env = make_env("catch", rows=6, cols=5)
    g = torch.Generator().manual_seed(0)
    state, obs = env.reset(3, g)
    assert obs.shape == (3, 6, 5, 1)
    done = 0
    for _ in range(5):
        state, obs, r, d, info = env.step(state, torch.ones(3, dtype=torch.int32), g)
        done += int(d.sum())
    assert done == 3  # exactly one boundary per env in rows - 1 steps
    lm = make_env("token_lm", vocab=16, episode_len=4)
    s, tok = lm.reset(2, g)
    s, tok, r, d, info = lm.step(s, tok, g)
    assert isinstance(info, EnvInfo) and info.terminal_obs.shape == (2,)


# ---------------------------------------------------------------------------
# Q models and the DQN agent, with JAX weights
# ---------------------------------------------------------------------------

CONV = dict(img_hw=(10, 5), channels=(16, 32), kernels=(3, 3), strides=(1, 1),
            d_out=128)
MODEL_CASES = [("conv", False, 0), ("conv", True, 0), ("conv", True, 21),
               ("mlp", False, 0), ("mlp", True, 0), ("mlp", False, 11)]


def _models(kind, dueling, n_atoms):
    if kind == "conv":
        return (jrl.make_q_conv(1, 3, dueling=dueling, n_atoms=n_atoms, **CONV),
                trl.make_q_conv(1, 3, dueling=dueling, n_atoms=n_atoms, **CONV),
                (10, 5, 1))
    return (jrl.make_q_mlp(4, 3, hidden=(32, 16), dueling=dueling, n_atoms=n_atoms),
            trl.make_q_mlp(4, 3, hidden=(32, 16), dueling=dueling, n_atoms=n_atoms),
            (4,))


@pytest.mark.parametrize("kind,dueling,n_atoms", MODEL_CASES)
def test_q_models_match_jax(kind, dueling, n_atoms):
    """JAX params carried by rl_params_from_jax give the same Q values (or
    C51 logits) in f32, at [B], [T, B] and [] leading dims."""
    jm, tm, obs_shape = _models(kind, dueling, n_atoms)
    jp = jm.init(jax.random.PRNGKey(7))
    tp = rl_params_from_jax(_np(jp))
    # the same leaves, by path and shape (JAX orders dict keys, the port
    # keeps insertion order)
    assert _shapes(tp) == _shapes(tm.init(torch.Generator().manual_seed(0)))
    rs = np.random.RandomState(8)
    for lead in ((6,), (2, 3), ()):
        obs = rs.rand(*lead, *obs_shape).astype(np.float32)
        want = np.asarray(jm.apply(jp, jnp.asarray(obs)))
        got = tm.apply(tp, torch.from_numpy(obs)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("n_atoms", [0, 21])
def test_dqn_agent_matches_jax(n_atoms):
    """Greedy eval_step actions and Q values equal JAX's; the sampling step
    with JAX's draws gives JAX's epsilon-greedy actions."""
    jm, tm, _ = _models("conv", True, n_atoms)
    ja = jagents.make_dqn_agent(jm, 3, n_atoms=n_atoms, v_min=-1, v_max=1)
    ta = tagents.make_dqn_agent(tm, 3, n_atoms=n_atoms, v_min=-1, v_max=1)
    jp = jm.init(jax.random.PRNGKey(3))
    tp = rl_params_from_jax(_np(jp))
    B = 16
    obs = np.random.RandomState(9).rand(B, 10, 5, 1).astype(np.float32)
    key = jax.random.PRNGKey(1)
    jst = ja.initial_state(B, epsilon=0.5)
    tst = ta.initial_state(B, epsilon=0.5)
    np.testing.assert_array_equal(tst["epsilon"].numpy(), np.asarray(jst["epsilon"]))
    ja_, jinfo, _ = ja.eval_step(jp, key, jnp.asarray(obs), None, None, jst)
    ta_, tinfo, _ = ta.eval_step(tp, None, torch.from_numpy(obs), None, None, tst)
    np.testing.assert_allclose(tinfo["q"].numpy(), np.asarray(jinfo["q"]),
                               rtol=1e-5, atol=2e-6)
    np.testing.assert_array_equal(ta_.numpy(), np.asarray(ja_))
    np.testing.assert_allclose(
        ta.value(tp, torch.from_numpy(obs), None, None, tst).numpy(),
        np.asarray(ja.value(jp, jnp.asarray(obs), None, None, jst)),
        rtol=1e-5, atol=2e-6)
    ja_s, _, _ = ja.step(jp, key, jnp.asarray(obs), None, None, jst)
    rng_u, rng_a = jax.random.split(key)
    rand = jax.random.randint(rng_a, (B,), 0, 3)
    u = jax.random.uniform(rng_u, (B,))
    got = tdist.EpsilonGreedy.select(tinfo["q"], tst["epsilon"],
                                     torch.tensor(np.asarray(u)),
                                     torch.tensor(np.asarray(rand)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ja_s))
    a, _, _ = ta.step(tp, torch.Generator().manual_seed(0), torch.from_numpy(obs),
                      None, None, tst)
    assert a.shape == (B,) and set(a.tolist()) <= {0, 1, 2}


def test_composite_space_and_dist_info_match_jax():
    """``core/spaces.py::Composite`` (namedarraytuple samples and null
    values of its sub-spaces) and ``core/distributions.py``'s ``DistInfo``
    / ``DistInfoStd`` / ``EPS``, as JAX's."""
    from repro.core import spaces as jspaces
    from repro_torch.core import Composite
    from repro_torch.core.distributions import DistInfo, DistInfoStd, EPS
    jc = jspaces.Composite("Obs", pos=jspaces.Box(-1.0, 1.0, shape=(3,)),
                           tok=jspaces.Discrete(5))
    tc = Composite("Obs", pos=Box(-1.0, 1.0, shape=(3,)), tok=Discrete(5))
    assert tc.shape == jc.shape == {"pos": (3,), "tok": ()}
    assert repr(tc) == repr(jc)
    jn, tn = jc.null_value(), tc.null_value()
    assert type(tn)._fields == type(jn)._fields == ("pos", "tok")
    for a, b in zip(tn, jn):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype
    s = tc.sample(torch.Generator().manual_seed(0), (4,))
    assert tuple(s.pos.shape) == (4, 3) and tuple(s.tok.shape) == (4,)
    assert bool((s.pos.abs() <= 1).all()) and bool(((s.tok >= 0)
                                                    & (s.tok < 5)).all())
    assert DistInfo._fields == jdist.DistInfo._fields == ("mean", "log_std")
    assert DistInfoStd is DistInfo and EPS == jdist.EPS
