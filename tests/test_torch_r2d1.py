"""R2D1 of the PyTorch port against the JAX package, on the CPU: the LSTM
(JAX's layout, gate order and forget offset) over a sequence,
``make_recurrent_q`` with its MLP and its conv trunk on params carried by
``rl_params_from_jax``, the R2D1 agent's q, action and LSTM state,
``value_rescale`` and its inverse, the ``R2D1`` loss, aux and gradients
with ``done`` inside the sequences (rescale on and off, with and without
burn-in), one update with Adam, and the target refresh at its interval.

Inputs are made from a seed with numpy (params drawn by JAX and handed
over) and go through both sides.  Tolerances (f32 on the CPU):
- LSTM outputs and state, q, losses, td_abs, q_mean, value_rescale(_inv):
  1e-5 relative + 1e-5 absolute (the frameworks sum a product's terms in
  other orders);
- gradients: 1e-4 relative + 1e-6 absolute of the largest entry of the
  leaf (small entries are sums of cancelling terms);
- params after one Adam step: within 2 lr |g_port - g_jax| / (|g_jax| +
  eps) + 1e-6 |p| (the bound of tests/test_torch_dqn.py);
- actions (greedy) and the target copy: exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro import agents as jagents  # noqa: E402
from repro.algos import R2D1 as JR2D1  # noqa: E402
from repro.algos.dqn import r2d1 as jr2d1  # noqa: E402
from repro.models import rl_models as jrl  # noqa: E402
from repro.replay.host import SequenceSamples as JSequenceSamples  # noqa: E402
from repro.train.optim import adam as jadam  # noqa: E402
from repro_torch import agents as tagents  # noqa: E402
from repro_torch.algos import R2D1, value_rescale, value_rescale_inv  # noqa: E402
from repro_torch.models import rl_models as trl  # noqa: E402
from repro_torch.models.convert import rl_params_from_jax  # noqa: E402
from repro_torch.replay.host import SequenceSamples  # noqa: E402
from repro_torch.runners import TrainLoop  # noqa: E402
from repro_torch.samplers import SerialSampler  # noqa: E402
from repro_torch.envs import make_env  # noqa: E402
from repro_torch.train.optim import adam  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
LR = 5e-4
CONV = dict(conv=True, img_hw=(10, 5), channels=(8, 16), kernels=(3, 3),
            strides=(1, 1), d_conv_out=32)
MLP = dict(trunk_hidden=(16,))
H = 12


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _models(kind):
    if kind == "conv":
        return (jrl.make_recurrent_q(1, 3, d_lstm=H, **CONV),
                trl.make_recurrent_q(1, 3, d_lstm=H, **CONV), (10, 5, 1))
    return (jrl.make_recurrent_q(6, 3, d_lstm=H, **MLP),
            trl.make_recurrent_q(6, 3, d_lstm=H, **MLP), (6,))


def _inputs(T, B, obs_shape, seed):
    rs = np.random.RandomState(seed)
    obs = (rs.rand(T, B, *obs_shape) < 0.3).astype(np.float32) \
        if len(obs_shape) == 3 else rs.randn(T, B, *obs_shape).astype(np.float32)
    return (obs, rs.randint(0, 3, (T, B)).astype(np.int32),
            rs.randn(T, B).astype(np.float32),
            (0.5 * rs.randn(B, H).astype(np.float32),
             0.5 * rs.randn(B, H).astype(np.float32)))


def test_lstm_sequence_matches_jax():
    """The cell over 7 steps from a nonzero state: every h, and the final
    (h, c); the bias is nonzero so the +1 forget offset and the gate order
    both show."""
    rs = np.random.RandomState(0)
    jp = jrl.init_lstm(jax.random.PRNGKey(3), 5, H)
    jp = dict(jp, b=jnp.asarray(rs.randn(4 * H).astype(np.float32)))
    xs = rs.randn(7, 4, 5).astype(np.float32)
    st = (rs.randn(4, H).astype(np.float32), rs.randn(4, H).astype(np.float32))
    jhs, (jh, jc) = jrl.lstm_seq(jp, jnp.asarray(xs),
                                 tuple(jnp.asarray(s) for s in st))
    tp = rl_params_from_jax(_np(jp))
    assert tuple(tp["wx"].shape) == (5, 4 * H) and \
        tuple(tp["wh"].shape) == (H, 4 * H)
    ths, (th, tc) = trl.lstm_seq(tp, _t(xs), tuple(_t(s) for s in st))
    np.testing.assert_allclose(ths.numpy(), np.asarray(jhs), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    z = trl.lstm_zero_state(H, 3)
    assert all(tuple(x.shape) == (3, H) and not x.any() for x in z)


@pytest.mark.parametrize("kind", ["mlp", "conv"])
def test_recurrent_q_matches_jax(kind):
    """``apply`` on (T, B) sequences with prev_action / prev_reward and a
    nonzero state: q and the final (h, c); the param trees carry across leaf
    for leaf, ``lstm`` included."""
    jm, tm, obs_shape = _models(kind)
    jp = jm.init(jax.random.PRNGKey(1))
    tp = rl_params_from_jax(_np(jp))
    assert set(tp) == {"trunk", "lstm", "head"} and "val" in tp["head"]
    obs, pa, pr, st = _inputs(6, 5, obs_shape, seed=2)
    jq, jst = jm.apply(jp, jnp.asarray(obs), jnp.asarray(pa), jnp.asarray(pr),
                       tuple(jnp.asarray(s) for s in st))
    tq, tst = tm.apply(tp, _t(obs), _t(pa), _t(pr), tuple(_t(s) for s in st))
    assert tuple(tq.shape) == (6, 5, 3)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    h, c = tm.initial_state(5)
    assert tuple(h.shape) == (5, H) and not h.any() and not c.any()
    # the port's init draws the same tree of shapes
    ti = tm.init(torch.Generator().manual_seed(0))
    def shapes(tree):
        return {str(path): tuple(x.shape) for path, x in
                pytree.tree_flatten_with_path(tree)[0]}
    assert shapes(ti) == shapes(tp)


def test_r2d1_agent_matches_jax():
    """One step of the agent on a batch: q, the greedy action at epsilon 0,
    the new LSTM state, ``value`` and ``eval_step``; the state layout is
    ``{"lstm": (h, c), "epsilon"}``."""
    jm, tm, obs_shape = _models("conv")
    jag, tag = jagents.make_r2d1_agent(jm, 3), tagents.make_r2d1_agent(tm, 3)
    assert tag.recurrent and jag.recurrent
    jp = jm.init(jax.random.PRNGKey(4))
    tp = rl_params_from_jax(_np(jp))
    obs, pa, pr, st = _inputs(1, 6, obs_shape, seed=5)
    tstate = tag.initial_state(6, epsilon=0.0)
    assert set(tstate) == {"lstm", "epsilon"} and \
        float(tstate["epsilon"].abs().sum()) == 0.0
    tstate = dict(tstate, lstm=tuple(_t(s) for s in st))
    jstate = dict(jag.initial_state(6, epsilon=0.0),
                  lstm=tuple(jnp.asarray(s) for s in st))
    ja, jinfo, jst = jag.step(jp, jax.random.PRNGKey(0), jnp.asarray(obs[0]),
                              jnp.asarray(pa[0]), jnp.asarray(pr[0]), jstate)
    ta, tinfo, tst = tag.step(tp, torch.Generator().manual_seed(0),
                              _t(obs[0]), _t(pa[0]), _t(pr[0]), tstate)
    np.testing.assert_allclose(tinfo["q"].numpy(), np.asarray(jinfo["q"]),
                               **TOL)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for a, b in zip(tst["lstm"], jst["lstm"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    v = tag.value(tp, _t(obs[0]), _t(pa[0]), _t(pr[0]), tstate)
    np.testing.assert_allclose(v.numpy(), np.asarray(jinfo["q"]).max(-1),
                               **TOL)
    ea, _, est = tag.eval_step(tp, None, _t(obs[0]), _t(pa[0]), _t(pr[0]),
                               tstate)
    np.testing.assert_array_equal(ea.numpy(), ta.numpy())
    assert torch.equal(est["lstm"][0], tst["lstm"][0])


def test_value_rescale_matches_jax():
    x = np.concatenate([np.linspace(-300, 300, 2001),
                        np.array([0.0, -1e-4, 1e-4])]).astype(np.float32)
    for fn, jfn in ((value_rescale, jr2d1.value_rescale),
                    (value_rescale_inv, jr2d1.value_rescale_inv)):
        np.testing.assert_allclose(fn(_t(x)).numpy(), np.asarray(jfn(x)),
                                   **TOL)
    # the pair inverts (within f32 rounding of the forward map)
    x64 = torch.from_numpy(x.astype(np.float64))
    np.testing.assert_allclose(value_rescale_inv(value_rescale(x64)).numpy(),
                               x.astype(np.float64), rtol=1e-9, atol=1e-9)


def _seq_batch(B, L1, obs_shape, seed):
    rs = np.random.RandomState(seed)
    obs = (rs.rand(B, L1, *obs_shape) < 0.3).astype(np.float32)
    fields = dict(observation=obs,
                  prev_action=rs.randint(0, 3, (B, L1)).astype(np.int32),
                  prev_reward=rs.choice([-1.0, 0.0, 1.0], (B, L1)).astype(
                      np.float32),
                  action=rs.randint(0, 3, (B, L1)).astype(np.int32),
                  reward=rs.choice([-1.0, 0.0, 1.0], (B, L1)).astype(
                      np.float32) * 3,
                  done=rs.rand(B, L1) < 0.2)
    st = (0.3 * rs.randn(B, H).astype(np.float32),
          0.3 * rs.randn(B, H).astype(np.float32))
    w = rs.uniform(0.3, 1.0, B).astype(np.float32)
    assert fields["done"][:, 1:-1].any()   # done inside the sequences
    tb = {"sequence": SequenceSamples(**{k: _t(v) for k, v in fields.items()},
                                      init_state=None),
          "init_state": tuple(_t(s) for s in st), "is_weights": _t(w)}
    jb = {"sequence": JSequenceSamples(
        **{k: jnp.asarray(v) for k, v in fields.items()}, init_state=None),
        "init_state": tuple(jnp.asarray(s) for s in st),
        "is_weights": jnp.asarray(w)}
    return tb, jb


def _algos(burn_in, rescale, interval=100):
    jm, tm, obs_shape = _models("conv")
    kw = dict(gamma=0.97, n_step=3, burn_in=burn_in, use_rescale=rescale,
              target_update_interval=interval)
    return (jm, tm, obs_shape, JR2D1(jm.apply, jadam(LR), **kw),
            R2D1(tm.apply, adam(LR), **kw))


@pytest.mark.parametrize("burn_in,rescale", [(3, True), (3, False),
                                             (0, True)])
def test_r2d1_loss_grads_and_update_match_jax(burn_in, rescale):
    """Same params, a different target, a batch of 5 sequences of 13 steps
    with ``done`` inside: loss, td_abs_max / td_abs_mean per sequence,
    q_mean, every gradient, then one Adam update's loss, grad norm and
    params."""
    jm, tm, obs_shape, jalgo, talgo = _algos(burn_in, rescale)
    jp = jm.init(jax.random.PRNGKey(1))
    jt = jm.init(jax.random.PRNGKey(2))
    tb, jb = _seq_batch(5, 13, obs_shape, seed=3)
    (jloss, jaux), jg = jax.jit(jax.value_and_grad(jalgo.loss, has_aux=True))(
        jp, jt, jb)
    tp, tt = rl_params_from_jax(_np(jp)), rl_params_from_jax(_np(jt))
    tloss, taux, tg = talgo.grads(tp, tt, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    for k in ("td_abs_max", "td_abs_mean", "q_mean"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]),
                                   **TOL)
    assert tuple(taux["td_abs_max"].shape) == (5,)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(tg) == len(jleaves)
    for g, gj in zip(tg, jleaves):
        gj = np.asarray(gj)
        np.testing.assert_allclose(g.numpy(), gj, rtol=1e-4,
                                   atol=1e-6 * max(np.abs(gj).max(), 1.0))

    jts = jalgo.init_train_state(None, jp)._replace(extra={"target": jt})
    jts2, jinfo = jax.jit(jalgo.update)(jts, jb)
    tts = talgo.init_train_state(None, tp)._replace(extra={"target": tt})
    old = pytree.tree_map(lambda p: p.clone(), tp)
    tts2, tinfo = talgo.update(tts, tb)
    assert tts2.step == int(jts2.step) == 1
    np.testing.assert_allclose(float(tinfo.loss), float(jinfo.loss), **TOL)
    np.testing.assert_allclose(float(tinfo.grad_norm),
                               float(jinfo.grad_norm), rtol=1e-5)
    for p, jpn, p0, g, gj in zip(pytree.tree_leaves(tts2.params),
                                 jax.tree_util.tree_leaves(jts2.params),
                                 pytree.tree_leaves(old), tg, jleaves):
        gj = np.asarray(gj)
        bound = (2 * LR * np.abs(g.numpy() - gj) / (np.abs(gj) + 1e-8)
                 + 1e-6 * np.abs(p0.numpy()) + 1e-9)
        assert np.all(np.abs(p.numpy() - np.asarray(jpn)) <= bound)


def test_r2d1_burn_in_carries_no_gradient():
    """A burn-in step's observations change the loss only through the
    stored state: the gradient with respect to them is zero, while a
    training step's is not."""
    _, tm, obs_shape, _, talgo = _algos(3, True)
    tp = tm.init(torch.Generator().manual_seed(0))
    tb, _ = _seq_batch(4, 11, obs_shape, seed=7)
    obs = tb["sequence"].observation.clone().requires_grad_(True)
    tb["sequence"] = tb["sequence"]._replace(observation=obs)
    loss, _ = talgo.loss(tp, pytree.tree_map(lambda p: p.clone(), tp), tb)
    (g,) = torch.autograd.grad(loss, obs)
    assert float(g[:, :3].abs().sum()) == 0.0
    assert float(g[:, 3:].abs().sum()) > 0.0


def test_r2d1_target_refresh_at_the_interval():
    """With interval 2: after update 1 the target is still the initial copy;
    after update 2 it equals the (in-place updated) params bit for bit, as
    JAX's ``where`` picks them, and is never an alias of them."""
    jm, tm, obs_shape, jalgo, talgo = _algos(2, True, interval=2)
    jp = jm.init(jax.random.PRNGKey(5))
    tp = rl_params_from_jax(_np(jp))
    tts = talgo.init_train_state(None, tp)
    jts = jalgo.init_train_state(None, jp)
    targ0 = [t.clone() for t in pytree.tree_leaves(tts.extra["target"])]
    for leaf, p in zip(pytree.tree_leaves(tts.extra["target"]),
                       pytree.tree_leaves(tp)):
        assert leaf.data_ptr() != p.data_ptr() and torch.equal(leaf, p)
    jupdate = jax.jit(jalgo.update)
    for i in range(2):
        tb, jb = _seq_batch(4, 11, obs_shape, seed=20 + i)
        tts, _ = talgo.update(tts, tb)
        jts, _ = jupdate(jts, jb)
        targ = pytree.tree_leaves(tts.extra["target"])
        params = pytree.tree_leaves(tts.params)
        if i == 0:
            assert all(torch.equal(a, b) for a, b in zip(targ, targ0))
            assert not all(torch.equal(a, b) for a, b in zip(targ, params))
        else:
            assert all(torch.equal(a, b) for a, b in zip(targ, params))
            assert all(a.data_ptr() != b.data_ptr()
                       for a, b in zip(targ, params))
            for a, b in zip(targ, jax.tree_util.tree_leaves(
                    jts.extra["target"])):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-4, atol=1e-5)


def test_train_loop_points_sequence_mode_to_the_async_runner():
    """TrainLoop refuses sequence mode with JAX's pointer to the runner
    that takes it."""
    _, tm, _, _, talgo = _algos(2, True)
    sampler = SerialSampler(make_env("catch"),
                            tagents.make_r2d1_agent(tm, 3), 4, 8)
    with pytest.raises(ValueError, match="use AsyncR2D1Runner"):
        TrainLoop(sampler, talgo)
