"""The port's CUDA-graph paths on the CPU (core/graphs.py and its callers).

A CPU has no graphs: there every captured body runs eagerly, through the
same ``StepGraph`` code (state at fixed addresses, outputs copied back).
So this file checks what the card cannot show cheaply:

- no host read in any body the card captures.  Each runs under
  ``NoHostReads``, a ``TorchDispatchMode`` that raises on a read of a
  tensor's value by the host (``aten._local_scalar_dense``: ``item``,
  ``int``, ``bool``), a shape that depends on the data (``nonzero``,
  ``masked_select``, ``unique``), a tensor made from host data inside the
  body (``aten.lift_fresh``, or an input that no op made and that did not
  exist before the body ran: ``torch.as_tensor`` of a numpy array), and a
  copy across devices.  The bodies: the engine's decode block and serve's
  decode step (every smoke config), the rollout step (every smoke config
  the train launcher takes) and the TrainLoop iteration (DQN, prioritized
  DQN, PPO, A2C, DDPG, TD3, SAC);
- ``StepGraph``'s contract: the state keeps its addresses, a state made
  elsewhere is copied in, plain leaves pass, another generator is refused;
- ``TrainLoop(fuse=True)`` equals ``fuse=False`` bit for bit (every state
  leaf, every generator's state, every logged number but the clock's),
  over iterations that cross DQN's target copies and TD3's delayed actor
  steps; and matches JAX's ``TrainLoop(fuse=True)`` window on pre-drawn
  inputs (DQN on Catch, PPO on CartPole; tolerances at the test);
- serve's decode, the engine and the rollout with ``graph=True`` equal
  ``graph=False`` bit for bit; ``train --fuse-window 2`` equals two
  unfused steps bit for bit and logs JAX's keys;
- ``embed``'s scale as a Python float gives the 0-d tensor's product bit
  for bit (gemma2 and whisper, bf16 and f32).

Replay against eager on the card is ``tests/test_torch_graphs_cuda.py``
and ``chip_smoke.py``.
"""
import dataclasses
import gc
import json
import math
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro import agents as jagents  # noqa: E402
from repro.algos import DQN as JDQN, PPO as JPPO  # noqa: E402
from repro.core.distributions import Categorical as JCategorical  # noqa: E402
from repro.envs import make_env as jmake_env  # noqa: E402
from repro.models import rl_models as jrl  # noqa: E402
from repro.replay import DeviceReplay as JDeviceReplay  # noqa: E402
from repro.runners import TrainLoop as JTrainLoop  # noqa: E402
from repro.runners.train_loop import split_keys  # noqa: E402
from repro.samplers import SerialSampler as JSerialSampler  # noqa: E402
from repro.train.optim import adam as jadam  # noqa: E402
from repro_torch.algos import A2C, DQN, PPO  # noqa: E402
from repro_torch.agents import make_categorical_pg_agent  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.distributions import Categorical, EpsilonGreedy  # noqa: E402
from repro_torch.core.graphs import StepGraph  # noqa: E402
from repro_torch.envs import make_env  # noqa: E402
from repro_torch.envs import cartpole as tcartpole  # noqa: E402
from repro_torch.envs import catch as tcatch  # noqa: E402
from repro_torch.envs.token_lm import make_token_lm  # noqa: E402
from repro_torch.examples import catch_dqn_variants as catch_ex  # noqa: E402
from repro_torch.examples import pendulum_qpg as qpg_ex  # noqa: E402
from repro_torch.examples import quickstart as pg_ex  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as lm_train  # noqa: E402
from repro_torch.models import backbones as bb  # noqa: E402
from repro_torch.models import rl_models as trl  # noqa: E402
from repro_torch.models.convert import rl_params_from_jax  # noqa: E402
from repro_torch.models.rl_models import make_pg_mlp  # noqa: E402
from repro_torch.replay.interface import DeviceReplay, transition_example  # noqa: E402
from repro_torch.runners import OnPolicyRunner, TrainLoop  # noqa: E402
from repro_torch.samplers import SerialSampler  # noqa: E402
from repro_torch.serving import ContinuousBatchEngine, poisson_trace  # noqa: E402
from repro_torch.train.optim import adam  # noqa: E402
from repro_torch.utils.logger import Logger  # noqa: E402

aten = torch.ops.aten
ARCHS = ("gemma2-2b", "glm4-9b", "phi3-mini-3.8b", "granite-34b",
         "qwen2-moe-a2.7b", "mixtral-8x7b", "mamba2-1.3b", "zamba2-7b",
         "llama-3.2-vision-90b", "whisper-medium")
TRAIN_ARCHS = tuple(a for a in ARCHS if a != "whisper-medium")
RL_ALGOS = ("dqn", "rainbow", "ppo", "a2c", "ddpg", "td3", "sac")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run many small ops, and the suite's
    workers share the machine's cores (with a pool each, they wait on each
    other).  Each comparison runs both sides under the same setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the host-read detector
# ---------------------------------------------------------------------------
class HostRead(AssertionError):
    pass


class NoHostReads(TorchDispatchMode):
    """Raise on what a CUDA graph capture refuses or silently freezes (see
    the module docstring).  Tensors alive when the mode is entered (state,
    weights, cached constants) are known; so is every op's output."""

    BANNED = {aten._local_scalar_dense, aten.nonzero, aten.lift_fresh,
              aten.lift_fresh_copy, aten.masked_select, aten._unique2,
              aten.unique_consecutive, aten.unique_dim}
    # indexing by a boolean mask runs nonzero inside the op
    INDEXING = {aten.index, aten.index_put, aten.index_put_,
                aten._index_put_impl_}

    def __enter__(self):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            self._alive = [t for t in gc.get_objects()
                           if isinstance(t, torch.Tensor)]
        self._known = {id(t) for t in self._alive}
        self._made = []
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket in self.BANNED:
            raise HostRead(f"host read or host data: {func}")
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if func.overloadpacket in self.INDEXING and any(
                t is not None and t.dtype == torch.bool for t in args[1]):
            raise HostRead(f"{func} by a boolean mask")
        if len({t.device for t in ins}) > 1:
            raise HostRead(f"{func} across devices "
                           f"{sorted(str(t.device) for t in ins)}")
        for t in ins:
            if id(t) not in self._known:
                raise HostRead(f"{func} reads a {tuple(t.shape)} tensor that "
                               "no op made (host data)")
        out = func(*args, **kwargs)
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._known.add(id(t))
                self._made.append(t)
        return out


def test_no_host_reads_catches_what_a_capture_refuses():
    x = torch.ones(4)
    for bad in (lambda: float(x.sum()), lambda: x[x > 0],
                lambda: x + torch.tensor([1.0, 2.0, 3.0, 4.0]),
                lambda: x + torch.as_tensor(np.ones(4, np.float32)),
                lambda: x.nonzero()):
        with pytest.raises(HostRead):
            with NoHostReads():
                bad()
    with NoHostReads():
        y = torch.where(x > 0, x, 0.0) * 2 + torch.arange(4)
        torch.randint(0, 3, (4,), generator=torch.Generator())
    assert y.shape == (4,)


# ---------------------------------------------------------------------------
# StepGraph's contract on the CPU
# ---------------------------------------------------------------------------
def test_step_graph_keeps_the_state_in_place():
    def fn(x, n, gen):
        y = x + torch.rand(x.shape, generator=gen)
        return (y, n + 1, gen), y.sum()

    gen = torch.Generator().manual_seed(0)
    x = torch.zeros(3)
    step = StepGraph(fn, device="cpu")
    (x1, n1, _), s1 = step(x, 0, gen)
    # the graph keeps its own copy: the caller's tensor is never written
    assert x1 is not x and not x.any() and n1 == 1
    assert float(s1) == float(x1.sum())
    other = torch.full((3,), 5.0)
    (x2, n2, _), _ = step(other, 7, gen)        # copied in, then stepped
    assert x2 is x1 and n2 == 8 and bool((x1 > 5).all())
    with pytest.raises(ValueError, match="Generator"):
        step(x1, 0, torch.Generator())
    ref = torch.Generator().manual_seed(0)
    torch.rand(3, generator=ref)            # the first call's draw
    want = 5.0 + torch.rand(3, generator=ref)
    torch.testing.assert_close(x1, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the RL runners: fused against unfused
# ---------------------------------------------------------------------------
class _Rows(Logger):
    def __init__(self):
        super().__init__(sinks=())
        self.rows = []

    def record(self, step, row):
        self.rows.append((step, {k: float(v) for k, v in row.items()}))


def _rl_runner(name, n_iterations, fuse, logger):
    if name in ("dqn", "rainbow"):
        _, r = catch_ex.make_runner(name, n_iterations, replay_capacity=1024,
                                    min_replay=256, log_interval=2,
                                    logger=logger)
        r.algo.target_interval = 3   # cross target copies in a few updates
        init = None
    elif name == "ppo":
        _, r = pg_ex.make_runner(n_iterations, log_interval=2, logger=logger)
        r.sampler.horizon = 16
        init = None
    elif name == "a2c":
        model = make_pg_mlp(4, 2)
        algo = A2C(model.apply, adam(7e-4, grad_clip=1.0),
                   distribution=Categorical(2), gae_lambda=0.95)
        sampler = SerialSampler(make_env("cartpole"),
                                make_categorical_pg_agent(model), n_envs=8,
                                horizon=16)
        r = OnPolicyRunner(sampler, algo, n_iterations=n_iterations,
                           log_interval=2, logger=logger, sentinels=True)
        init = None
    else:
        _, r, init = qpg_ex.make_runner(
            name, n_iterations, hidden=(16, 16), n_envs=4, horizon=8,
            replay_capacity=512, batch_size=32, updates_per_collect=3,
            min_replay=64, prioritized=name == "td3", log_interval=2,
            logger=logger)
    r.loop.fuse = fuse
    return r, init


def _run_rl(name, fuse, n=5):
    logger = _Rows()
    r, init = _rl_runner(name, n, fuse, logger)
    params = None if init is None else init(torch.Generator().manual_seed(0))
    ts, ss, info = r.run(0, params=params, device="cpu")
    rs = getattr(r, "replay_state", None)
    return (ts, ss, rs), info, logger.rows


def _flat(tree):
    out = []
    for x in pytree.tree_leaves(tree, is_leaf=lambda v: isinstance(
            v, torch.Generator)):
        out.append(x.get_state() if isinstance(x, torch.Generator) else x)
    return out


def _assert_bit_equal(a, b):
    la, lb = _flat(a), _flat(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x, y), (x, y)
        else:
            assert x == y


@pytest.mark.parametrize("name", RL_ALGOS)
def test_fused_train_loop_equals_unfused_bit_for_bit(name):
    """Five iterations (log windows of two): every state leaf, generator
    state, the last info and every logged number but samples_per_sec."""
    fused, finfo, frows = _run_rl(name, True)
    plain, pinfo, prows = _run_rl(name, False)
    _assert_bit_equal(fused, plain)
    _assert_bit_equal(finfo, pinfo)
    assert [s for s, _ in frows] == [s for s, _ in prows] and frows
    for (_, fr), (_, pr) in zip(frows, prows):
        assert fr.keys() == pr.keys()
        for k in fr:
            if k != "samples_per_sec":
                assert fr[k] == pr[k] or (math.isnan(fr[k])
                                          and math.isnan(pr[k])), k


def _rl_state(name):
    r, init = _rl_runner(name, 2, True, _Rows())
    gens = [torch.Generator().manual_seed(i) for i in range(3)]
    params = (init or r.sampler.agent.init_params)(gens[0])
    ts = r.algo.init_train_state(gens[0], params)
    if hasattr(r, "replay"):
        ss = r.sampler.init(gens[1], r.agent_state_kwargs)
        rs = r.replay.init(transition_example(r.sampler.env, device="cpu"))
        for _ in range(4):
            ss, rs = r.loop.collect_insert(ts.params, ss, rs)
    else:
        ss, rs = r.sampler.init(gens[1]), None
    return r.loop, (ts, ss, rs, gens[2])


@pytest.mark.parametrize("name", RL_ALGOS)
def test_train_loop_iteration_reads_nothing_on_the_host(name):
    loop, state = _rl_state(name)
    with NoHostReads():
        for _ in range(3):
            ts, ss, rs, _, _ = loop.fused_iteration(*state)
            state = (ts, ss, rs, state[3])


def test_fused_train_loop_keeps_one_graph_per_branch():
    """DQN with its target copy every 3 updates, 2 updates an iteration:
    the loop keys its graphs by the branch tuple the host computes."""
    loop, state = _rl_state("dqn")
    for _ in range(6):
        ts, ss, rs, _, _ = loop.fused_iteration(*state)
        state = (ts, ss, rs, state[3])
    assert state[0].step == 12
    assert set(loop.graphs) == {(False, False), (False, True), (True, False)}


# ---------------------------------------------------------------------------
# the fused loop against JAX's fused window, on JAX's draws
# ---------------------------------------------------------------------------
def _n(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _t(tree):
    return pytree.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _sampler_draws(jss_rng, steps, B, agent_draw, env_draw):
    """The draws JAX's SerialSampler makes from its state's key over
    ``steps`` env steps: the agent's (from k_act) and each env's (from the
    split k_env), in order."""
    rng, agent, env = jss_rng, [], []
    for _ in range(steps):
        rng, k_act, k_env = jax.random.split(rng, 3)
        agent.append(agent_draw(k_act))
        env.append(np.stack([np.asarray(env_draw(k))
                             for k in jax.random.split(k_env, B)]))
    return agent, env


def _scripted(env_spec, agent, env_noise, agent_noise, step_env, act):
    """The port's env and agent drawing JAX's numbers in order (host
    counters: the CPU runs the fused body eagerly)."""
    it_env, it_agent = iter(env_noise), iter(agent_noise)

    def env_step(state, action, generator):
        return step_env(state, action, torch.from_numpy(next(it_env)))

    def agent_step(params, generator, obs, pa, pr, state):
        return act(params, obs, pa, pr, state, next(it_agent))

    return env_spec._replace(step=env_step), agent._replace(step=agent_step)


class _DrawnReplay(DeviceReplay):
    """The uniform device replay, with JAX's ages in order."""

    def __init__(self, capacity, ages):
        super().__init__(capacity)
        self.ages = iter(ages)

    def sample(self, state, generator, batch_size, *, draws=None):
        return super().sample(state, generator, batch_size,
                              draws=torch.from_numpy(next(self.ages)))


def _port_state(ss, jss):
    """The port's sampler state holding JAX's initial env state and obs."""
    return ss._replace(env_state=_t(_n(jss.env_state)), obs=_t(_n(jss.obs)),
                       agent_state=None if jss.agent_state is None
                       else _t(_n(jss.agent_state)))


def test_fused_dqn_on_catch_matches_jax_fused_window():
    """DQN (double, conv Q) on Catch, 4 envs x 4 steps, uniform replay of
    256, batch 16, one update an iteration, target copy every 2 updates: the
    port's ``TrainLoop(fuse=True)`` window of 3 iterations against JAX's
    ``TrainLoop(fuse=True)._window`` on the same initial state and keys,
    the port drawing JAX's numbers (epsilon-greedy u and actions, the
    fresh ball columns, the replay ages).  Exact: every replay slot (the
    envs' outputs and the actions); f32, conv and matmul sums in other
    orders: the losses within 1e-5 relative, the params after 3 Adam steps
    within 1e-5 relative + 3 lr |g| eps-scaled (Adam moves a param by
    about lr where |g| >> eps, so rounding moves it by far less): 1e-4
    relative + 2e-6 absolute."""
    B, T, cap, batch, n, warm = 4, 4, 256, 16, 3, 2
    conv = dict(img_hw=(10, 5), channels=(16, 32), kernels=(3, 3),
                strides=(1, 1), d_out=128)
    kw = dict(gamma=0.99, double=True, target_update_interval=2)
    jm = jrl.make_q_conv(1, 3, **conv)
    tm = trl.make_q_conv(1, 3, **conv)
    jalgo, talgo = JDQN(jm.apply, jadam(5e-4), **kw), DQN(tm.apply,
                                                          adam(5e-4), **kw)
    jsampler = JSerialSampler(jmake_env("catch"),
                              jagents.make_dqn_agent(jm, 3), B, T)
    jloop = JTrainLoop(jsampler, jalgo, replay=JDeviceReplay(cap),
                       batch_size=batch, fuse=True)
    jp = jm.init(jax.random.PRNGKey(0))
    jts = jalgo.init_train_state(None, jp)
    jss = jsampler.init(jax.random.PRNGKey(1), {"epsilon": 0.5})
    # JAX's draws: the sampler's (warm-up + window), then the ages
    def eps_draw(k):
        ku, ka = jax.random.split(k)
        return (np.asarray(jax.random.uniform(ku, (B,))),
                np.asarray(jax.random.randint(ka, (B,), 0, 3,
                                              dtype=jnp.int32)))

    agent_noise, env_noise = _sampler_draws(
        jss.rng, (warm + n) * T, B, eps_draw,
        lambda k: jax.random.randint(k, (), 0, 5))
    _, keys = split_keys(jax.random.PRNGKey(7), n)
    ages = []
    for i, k in enumerate(keys):
        filled = min((warm + i + 1) * B * T, cap)
        (k_up,) = jax.random.split(k, 1)
        k_s, _ = jax.random.split(k_up)
        ages.append(np.asarray(jax.random.randint(k_s, (batch,), 0,
                                                  max(filled, 1))))
    jrs = jloop.replay.init({
        "observation": jnp.zeros((10, 5, 1)), "action": jnp.zeros((),
                                                                  jnp.int32),
        "reward": jnp.zeros(()), "done": jnp.zeros((), bool),
        "timeout": jnp.zeros((), bool),
        "next_observation": jnp.zeros((10, 5, 1))})
    for _ in range(warm):
        jss, jrs = jloop.collect_insert(jp, jss, jrs)
    jts2, _, jrs2, jinfos, _ = jloop._window(jts, jss, jrs, keys)

    eg = EpsilonGreedy(3)

    def act(params, obs, pa, pr, state, draw):
        q = tm.apply(params, obs, pa, pr)
        u, rand = (torch.from_numpy(x) for x in draw)
        return eg.select(q, state["epsilon"], u, rand), {"q": q}, state

    env, agent = _scripted(
        tcatch.make_catch(), agents_dqn(tm), env_noise, agent_noise,
        lambda s, a, f: tcatch.step_with_noise(s, a, f), act)
    sampler = SerialSampler(env, agent, B, T)
    loop = TrainLoop(sampler, talgo, replay=_DrawnReplay(cap, ages),
                     batch_size=batch, fuse=True)
    params = rl_params_from_jax(_n(jp))
    ts = talgo.init_train_state(None, params)
    ss = _port_state(sampler.init(torch.Generator(), {"epsilon": 0.5}),
                     jsampler.init(jax.random.PRNGKey(1), {"epsilon": 0.5}))
    rs = loop.replay.init(transition_example(env))
    for _ in range(warm):
        ss, rs = loop.collect_insert(ts.params, ss, rs)
    losses, gen = [], torch.Generator()
    for _ in range(n):
        ts, ss, rs, info, _ = loop.run_window(ts, ss, rs, gen, 1)
        losses.append(float(info.loss))
    for name, leaf in rs.storage.items():
        np.testing.assert_array_equal(leaf.numpy(),
                                      np.asarray(jrs2.storage[name]), name)
    assert int(rs.cursor) == int(jrs2.cursor) and ts.step == int(jts2.step)
    np.testing.assert_allclose(losses, np.asarray(jinfos.loss), rtol=1e-5,
                               atol=1e-7)
    for p, q in zip(pytree.tree_leaves(ts.params),
                    jax.tree_util.tree_leaves(jts2.params)):
        np.testing.assert_allclose(p.numpy(), np.asarray(q), rtol=1e-4,
                                   atol=2e-6)


def agents_dqn(model):
    from repro_torch.agents import make_dqn_agent
    return make_dqn_agent(model, 3)


def test_fused_ppo_on_cartpole_matches_jax_fused_window():
    """PPO (2 epochs x 2 minibatches, Adam 7e-4, clip 0.5) on CartPole, 4
    envs x 8 steps, the port's ``TrainLoop(fuse=True)`` window of 2
    iterations against JAX's ``TrainLoop(fuse=True)._window`` on the same
    initial state and keys, the port drawing JAX's numbers (the Gumbel
    noise of JAX's categorical sample, the fresh CartPole states, the
    epochs' permutations).  The actions equal; f32 (JAX's physics and
    matmuls round elsewhere): observations within 1e-6, the losses within
    1e-5 relative, the params after 8 Adam steps within 1e-5 absolute
    (a few lr-sized steps of rounding where |g| is near eps)."""
    B, T, n, epochs, mbs = 4, 8, 2, 2, 2
    jm, tm = jrl.make_pg_mlp(4, 2), trl.make_pg_mlp(4, 2)
    kw = dict(epochs=epochs, minibatches=mbs)
    jalgo = JPPO(jm.apply, jadam(7e-4, grad_clip=0.5),
                 distribution=JCategorical(2), **kw)
    jsampler = JSerialSampler(jmake_env("cartpole"),
                              jagents.make_categorical_pg_agent(jm), B, T)
    jloop = JTrainLoop(jsampler, jalgo, fuse=True)
    jp = jm.init(jax.random.PRNGKey(2))
    jts = jalgo.init_train_state(None, jp)
    jss = jsampler.init(jax.random.PRNGKey(3))
    agent_noise, env_noise = _sampler_draws(
        jss.rng, n * T, B,
        lambda k: np.asarray(jax.random.gumbel(k, (B, 2), jnp.float32)),
        lambda k: jax.random.uniform(k, (4,), jnp.float32, -0.05, 0.05))
    _, keys = split_keys(jax.random.PRNGKey(8), n)
    perms = [[np.asarray(jax.random.permutation(k, B * T))
              for k in jax.random.split(key, epochs)] for key in keys]
    jts2, jss2, _, jinfos, _ = jloop._window(jts, jss, None, keys)

    dist = Categorical(2)

    def act(params, obs, pa, pr, state, gumbel):
        logits, value = tm.apply(params, obs, pa, pr)
        action = torch.argmax(logits + torch.from_numpy(gumbel), -1)
        return action, {"logp": dist.log_likelihood(action, logits),
                        "value": value}, state

    env, agent = _scripted(
        tcartpole.make_cartpole(), make_categorical_pg_agent(tm), env_noise,
        agent_noise, tcartpole.step_with_noise, act)
    it_perms = iter(perms)

    class _DrawnPPO(PPO):
        def update(self, train_state, batch, generator=None, **_):
            return super().update(train_state, batch, generator,
                                  perms=next(it_perms))

    talgo = _DrawnPPO(tm.apply, adam(7e-4, grad_clip=0.5),
                      distribution=dist, **kw)
    sampler = SerialSampler(env, agent, B, T)
    loop = TrainLoop(sampler, talgo, fuse=True)
    ts = talgo.init_train_state(None, rl_params_from_jax(_n(jp)))
    ss = _port_state(sampler.init(torch.Generator()), jss)
    losses, gen = [], torch.Generator()
    for _ in range(n):
        ts, ss, _, info, _ = loop.run_window(ts, ss, None, gen, 1)
        losses.append(float(info.loss))
    np.testing.assert_array_equal(ss.prev_action.numpy(),
                                  np.asarray(jss2.prev_action))
    np.testing.assert_allclose(ss.obs.numpy(), np.asarray(jss2.obs),
                               atol=1e-6)
    assert int(ss.completed_count) == int(jss2.completed_count)
    np.testing.assert_allclose(losses, np.asarray(jinfos.loss), rtol=1e-5,
                               atol=1e-7)
    for p, q in zip(pytree.tree_leaves(ts.params),
                    jax.tree_util.tree_leaves(jts2.params)):
        np.testing.assert_allclose(p.numpy(), np.asarray(q), rtol=0,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the LM paths
# ---------------------------------------------------------------------------
B, PROMPT, GEN = 2, 12, 6


def _lm(cfg, seed=0):
    return bb.init_lm(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(seed))


def _serve(arch, graph, temperature=1.0, rounds=2):
    cfg = get_smoke_config(arch)
    params = _lm(cfg)
    prefill, decode = serve.make_phases(cfg, B, PROMPT, GEN, temperature,
                                        device="cpu", graph=graph)
    gen = torch.Generator().manual_seed(5)
    out = []
    for _ in range(rounds):
        prompts = serve.make_prompts(cfg, B, PROMPT, gen, "cpu")
        logits, cache = prefill(params, prompts)
        out.append(decode(params, logits, cache, gen))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_decode_step_reads_nothing_on_the_host(arch):
    cfg = get_smoke_config(arch)
    params = _lm(cfg)
    prefill, decode = serve.make_phases(cfg, B, PROMPT, GEN, 1.0,
                                        device="cpu")
    gen = torch.Generator().manual_seed(1)
    logits, cache = prefill(params, serve.make_prompts(cfg, B, PROMPT, gen,
                                                       "cpu"))
    with NoHostReads():
        toks = decode(params, logits, cache, gen)
    assert toks.shape == (B, GEN)


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-1.3b", "zamba2-7b"])
def test_serve_decode_graph_equals_eager(arch):
    """Two sampled rounds (temperature 1) from one generator: the graph
    path's tokens equal the eager path's."""
    for a, b in zip(_serve(arch, True), _serve(arch, False)):
        assert torch.equal(a, b)


def _engine(arch, graph):
    cfg = get_smoke_config(arch)
    return ContinuousBatchEngine(cfg, _lm(cfg), n_slots=3, max_context=40,
                                 device="cpu", buckets=(8, 16),
                                 decode_block=4, temperature=1.0,
                                 graph=graph, seed=2)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_decode_block_reads_nothing_on_the_host(arch):
    engine = _engine(arch, True)
    engine.slots.write_prefill_at(engine.params, 0,
                                  np.arange(9, dtype=np.int32))
    active = torch.tensor([True, False, True])
    remaining = torch.tensor([5, 0, 2], dtype=torch.int32)
    with NoHostReads():
        _, (toks, emitted) = engine._block_fn(
            engine.params, engine.slots.logits, engine.slots.cache, active,
            remaining, engine._gen)
    assert toks.shape == emitted.shape == (4, 3)


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-1.3b"])
def test_engine_graph_equals_eager(arch):
    """A sampled trace, run twice per engine (the generator re-seeded per
    run): every request's tokens agree between the graph and eager
    engines, and across the two runs."""
    toks = []
    for graph in (True, False):
        engine = _engine(arch, graph)
        engine.warmup()
        for _ in range(2):
            reqs = poisson_trace(3, 6, 100.0, prompt_len_range=(8, 20),
                                 max_tokens_range=(4, 12),
                                 vocab=engine.cfg.vocab)
            engine.run(reqs, realtime=False)
            toks.append([r.tokens for r in reqs])
    for run in toks[1:]:
        for a, b in zip(toks[0], run):
            np.testing.assert_array_equal(a, b)


def _rollout(arch, graph, steps=2):
    cfg = get_smoke_config(arch)
    env = make_token_lm(vocab=cfg.vocab, episode_len=5, device="cpu")
    params = bb.init_lm(cfg, device="cpu", dtype=torch.float32,
                        generator=torch.Generator().manual_seed(0),
                        requires_grad=True)
    rollout = lm_train.make_lm_rollout(cfg, env, B, 5, device="cpu",
                                       graph=graph)
    gen = torch.Generator().manual_seed(3)
    outs = []
    for _ in range(steps):
        traj, v_last = rollout(params, gen)
        outs.append(({k: v.clone() for k, v in traj.items()}, v_last.clone()))
    return rollout, params, gen, outs


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_rollout_step_reads_nothing_on_the_host(arch):
    rollout, params, gen, _ = _rollout(arch, True, steps=1)
    with NoHostReads():
        traj, _ = rollout(params, gen)
    assert traj["tokens"].shape == (5, B)


def test_token_env_rows_read_nothing_on_the_host():
    """Above the table's vocabulary (full-width gemma2's 256 000) the env
    computes the rows a step reads (``chain_rows``) inside the captured
    rollout step."""
    env = make_token_lm(vocab=70_000, episode_len=3, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(2, gen)
    with NoHostReads():
        for _ in range(4):
            action = torch.randint(0, 70_000, (2,), generator=gen)
            state, obs, reward, done, _ = env.step(state, action, gen)
    assert reward.shape == (2,) and bool(torch.isfinite(reward).all())


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-1.3b"])
def test_rollout_graph_equals_eager(arch):
    """Two rollouts from one generator: every (T, B) leaf and v_last."""
    *_, a = _rollout(arch, True)
    *_, b = _rollout(arch, False)
    _assert_bit_equal(a, b)


def _train(tmp_path, name, window, steps=2):
    d = tmp_path / name
    params = lm_train.main(["--device", "cpu", "--steps", str(steps),
                            "--batch", "2", "--horizon", "4",
                            "--fuse-window", str(window), "--log-dir",
                            str(d)])
    with open(d / "progress.jsonl") as f:
        rows = [json.loads(line) for line in f]
    return params, rows


def test_train_fuse_window_equals_unfused_steps(tmp_path):
    """``--fuse-window 2`` over two steps: the params of two unfused steps,
    bit for bit, and one row at the window's end with JAX's keys."""
    fused, frows = _train(tmp_path, "fused", 2)
    plain, prows = _train(tmp_path, "plain", 1)
    for (n, p), (_, q) in zip(fused.named_parameters(),
                              plain.named_parameters()):
        assert torch.equal(p, q), n
    assert len(frows) == 1 and len(prows) == 2
    keys = {"avg_reward", "loss", "entropy", "samples_per_sec"}
    assert keys <= set(frows[0]) and not {"rollout_s", "update_s"} & set(
        frows[0])
    for k in ("avg_reward", "loss", "entropy"):
        assert frows[0][k] == prows[-1][k], k


@pytest.mark.parametrize("arch", ["gemma2-2b", "whisper-medium"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_embed_scale_as_a_python_float_is_bit_identical(arch, dtype):
    """sqrt(d_model) rounded to the compute dtype, as a Python float, gives
    the product the 0-d tensor of that dtype gave."""
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=dtype)
    params = _lm(cfg)
    tokens = torch.arange(2 * 7, dtype=torch.int32).reshape(2, 7) % cfg.vocab
    got = bb.embed(params, tokens, cfg)
    x = params.tok_embed.index_select(0, tokens.reshape(-1))
    x = x.reshape(2, 7, -1).to(got.dtype)
    want = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    assert torch.equal(got, want)
