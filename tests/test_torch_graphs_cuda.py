"""The port's CUDA-graph paths replayed on the card against their eager runs,
bit for bit.  Needs an NVIDIA GPU with the CUDA toolkit (sm_90a); every
test here skips on a machine without CUDA.  Imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_graphs_cuda.py

- ``StepGraph``: a replay draws what an eager call draws from a registered
  generator, the state stays at its addresses, a kernel's launch counter
  counts each replay's launches, a host read in the body refuses to
  capture (no eager fallback);
- ``TrainLoop(fuse=True)`` against ``fuse=False`` after every iteration
  (every state leaf, generator state and info; cuDNN's deterministic
  algorithms, since its default conv backward is not): DQN, prioritized DQN
  (rainbow, whose sum-tree kernel runs inside the graph: one launch an
  update, counted under replay), PPO, A2C, DDPG, TD3 and SAC at small
  widths, across DQN's target copies and TD3's delayed actor steps;
- serve's decode and the engine's decode block (smoke configs of every
  family), the rollout (smoke gemma2-2b and mamba2-1.3b) and
  ``train --fuse-window 2`` (smoke gemma2-2b) against their eager runs:
  tokens, trajectories and params bit for bit, the attention kernels'
  launches exact.
"""
import math

import numpy as np
import pytest

pytestmark = pytest.mark.cuda

torch = pytest.importorskip("torch")

from torch.utils import _pytree as pytree  # noqa: E402

from repro_torch.algos import A2C  # noqa: E402
from repro_torch.agents import make_categorical_pg_agent  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.distributions import Categorical  # noqa: E402
from repro_torch.core.graphs import StepGraph  # noqa: E402
from repro_torch.envs import make_env  # noqa: E402
from repro_torch.envs.token_lm import make_token_lm  # noqa: E402
from repro_torch.examples import catch_dqn_variants as catch_ex  # noqa: E402
from repro_torch.examples import pendulum_qpg as qpg_ex  # noqa: E402
from repro_torch.examples import quickstart as pg_ex  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.sum_tree import ops as st_ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as lm_train  # noqa: E402
from repro_torch.models import backbones as bb  # noqa: E402
from repro_torch.models.rl_models import make_pg_mlp  # noqa: E402
from repro_torch.runners import OnPolicyRunner  # noqa: E402
from repro_torch.samplers import SerialSampler  # noqa: E402
from repro_torch.serving import ContinuousBatchEngine, poisson_trace  # noqa: E402
from repro_torch.train.optim import adam  # noqa: E402
from repro_torch.utils.logger import Logger  # noqa: E402

DEV = "cuda"
RL_ALGOS = ("dqn", "rainbow", "ppo", "a2c", "ddpg", "td3", "sac")
SERVE_ARCHS = ("gemma2-2b", "qwen2-moe-a2.7b", "mamba2-1.3b", "zamba2-7b",
               "llama-3.2-vision-90b", "whisper-medium")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graphs and kernels have no CPU "
                    "mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _snap(tree):
    return [x.get_state() if isinstance(x, torch.Generator)
            else x.detach().clone() if torch.is_tensor(x) else x
            for x in pytree.tree_leaves(tree, is_leaf=lambda v: isinstance(
                v, torch.Generator))]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x, y)
        else:
            assert x == y


# ---------------------------------------------------------------------------
# StepGraph
# ---------------------------------------------------------------------------
def test_step_graph_replays_draw_what_eager_draws(cuda):
    def fn(x, gen):
        y = x + torch.rand(x.shape, generator=gen, device=x.device)
        y = y + torch.multinomial(torch.softmax(y, -1), 2,
                                  generator=gen).sum(-1, keepdim=True)
        return (y, gen), y.sum()

    outs = {}
    for graph in (False, True):
        gen = torch.Generator(device=DEV).manual_seed(3)
        x = torch.zeros((4, 16), device=DEV)
        step = StepGraph(fn, device=DEV) if graph else fn
        sums = []
        state = (x, gen)
        for _ in range(5):
            state, s = step(*state)
            sums.append(s.clone())
        outs[graph] = (_snap(state), torch.stack(sums))
        if graph:
            assert step.replays == 4 and state[0] is step.args[0]
    _same(outs[False][0], outs[True][0])
    assert torch.equal(outs[False][1], outs[True][1])


def test_step_graph_counts_launches_under_replay(cuda):
    tree = torch.rand(2 * 8192, device=DEV)

    def fn(tree):
        u = torch.rand(64, device=DEV) * tree[1]
        idx, _ = st_ops.tree_sample_blocked(tree, u)
        return (tree,), idx

    step = StepGraph(fn, device=DEV)
    st_ops.tree_sample_blocked.launches = 0
    for _ in range(6):
        step(tree)
    assert step.replays == 5 and st_ops.tree_sample_blocked.launches == 6


# ---------------------------------------------------------------------------
# TrainLoop(fuse=True) against fuse=False
# ---------------------------------------------------------------------------
def _runner(name, n):
    logger = Logger(sinks=())
    if name in ("dqn", "rainbow"):
        _, r = catch_ex.make_runner(name, n, replay_capacity=2048,
                                    min_replay=256, log_interval=4,
                                    logger=logger)
        r.algo.target_interval = 3
        return r, None
    if name == "ppo":
        _, r = pg_ex.make_runner(n, log_interval=4, logger=logger)
        return r, None
    if name == "a2c":
        model = make_pg_mlp(4, 2)
        algo = A2C(model.apply, adam(7e-4, grad_clip=1.0),
                   distribution=Categorical(2), gae_lambda=0.95)
        sampler = SerialSampler(make_env("cartpole"),
                                make_categorical_pg_agent(model), n_envs=16,
                                horizon=32)
        return OnPolicyRunner(sampler, algo, n_iterations=n, log_interval=4,
                              logger=logger, sentinels=True), None
    _, r, init = qpg_ex.make_runner(
        name, n, hidden=(64, 64), replay_capacity=4096, batch_size=64,
        updates_per_collect=3, min_replay=256, prioritized=name == "td3",
        log_interval=4, logger=logger)
    return r, init(torch.Generator(device=DEV).manual_seed(0))


def _trail(name, fuse, n=6):
    runner, params = _runner(name, n)
    loop, trail = runner.loop, []
    loop.fuse = fuse
    inner = loop.run_window

    def run_window(ts, ss, rs, gen, k):
        sents = []
        for _ in range(k):
            ts, ss, rs, info, sent = inner(ts, ss, rs, gen, 1)
            trail.append(_snap((ts, ss, rs, gen, info)))
            sents.append(sent)
        stacked = None if sents[0] is None else pytree.tree_map(
            lambda *x: torch.cat(x), *sents)
        return ts, ss, rs, info, stacked

    loop.run_window = run_window
    st_ops.tree_sample_blocked.launches = 0
    runner.run(0, params=params, device=DEV)
    return trail, loop, st_ops.tree_sample_blocked.launches


@pytest.fixture
def deterministic():
    """cuDNN's default convolution backward adds in an order that changes
    from run to run (two eager runs of Catch's conv model differ in the
    1e-10s): bit-for-bit comparisons run its deterministic algorithms."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = was


@pytest.mark.parametrize("name", RL_ALGOS)
def test_fused_iterations_equal_unfused_bit_for_bit(name, cuda,
                                                    deterministic):
    fused, loop, f_launches = _trail(name, True)
    plain, _, p_launches = _trail(name, False)
    assert len(fused) == len(plain) == 6
    for a, b in zip(fused, plain):
        _same(a, b)
    # each graph's first iteration is its eager warm-up
    assert sum(g.replays for g in loop.graphs.values()) == 6 - len(
        loop.graphs)
    assert f_launches == p_launches
    if name == "rainbow":
        assert f_launches == 6 * loop.k


# ---------------------------------------------------------------------------
# the LM paths
# ---------------------------------------------------------------------------
def _lm(cfg, **kw):
    return bb.init_lm(cfg, device=DEV,
                      generator=torch.Generator(device=DEV).manual_seed(0),
                      **kw)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_decode_graph_equals_eager(arch, cuda):
    cfg = get_smoke_config(arch)
    params = _lm(cfg)
    B, P, G = 8, 64, 32
    out, launches = {}, {}
    for graph in (False, True):
        prefill, decode = serve.make_phases(cfg, B, P, G, 1.0, device=DEV,
                                            graph=graph)
        gen = torch.Generator(device=DEV).manual_seed(1)
        fa_ops.flash_attention_decode.launches = 0
        out[graph] = []
        for _ in range(2):
            prompts = serve.make_prompts(cfg, B, P, gen, DEV)
            logits, cache = prefill(params, prompts)
            out[graph].append(decode(params, logits, cache, gen))
        launches[graph] = fa_ops.flash_attention_decode.launches
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a, b)
    assert launches[False] == launches[True]


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-1.3b"])
def test_engine_graph_equals_eager(arch, cuda):
    cfg = get_smoke_config(arch)
    params = _lm(cfg)
    toks = {}
    for graph in (False, True):
        engine = ContinuousBatchEngine(cfg, params, n_slots=4,
                                       max_context=97, device=DEV,
                                       buckets=(8, 16, 32, 64),
                                       temperature=1.0, graph=graph)
        engine.warmup()
        reqs = poisson_trace(0, 10, 100.0, prompt_len_range=(8, 64),
                             max_tokens_range=(4, 32), vocab=cfg.vocab)
        engine.run(reqs, realtime=False)
        toks[graph] = [np.asarray(r.tokens) for r in reqs]
    for a, b in zip(toks[False], toks[True]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-1.3b"])
def test_rollout_graph_equals_eager(arch, cuda):
    cfg = get_smoke_config(arch)
    env = make_token_lm(vocab=cfg.vocab, episode_len=16, device=DEV)
    params = _lm(cfg, dtype=torch.float32, requires_grad=True)
    snaps = {}
    for graph in (False, True):
        rollout = lm_train.make_lm_rollout(cfg, env, 8, 16, device=DEV,
                                           graph=graph)
        gen = torch.Generator(device=DEV).manual_seed(2)
        snaps[graph] = [_snap(rollout(params, gen)) for _ in range(2)]
    for a, b in zip(snaps[False], snaps[True]):
        _same(a, b)


def test_train_fuse_window_equals_unfused_steps(tmp_path, cuda):
    args = ["--device", "cuda", "--steps", "2", "--batch", "4", "--horizon",
            "8"]
    plain = lm_train.main(args + ["--log-dir", str(tmp_path / "a")])
    fused = lm_train.main(args + ["--fuse-window", "2", "--log-dir",
                                  str(tmp_path / "b")])
    for p, q in zip(plain.parameters(), fused.parameters()):
        assert torch.equal(p, q)
    assert all(math.isfinite(float(p.sum())) for p in fused.parameters())


# last: a refused capture is the file's final use of the card
def test_step_graph_refuses_a_host_read(cuda):
    def fn(x):
        return (x + float(x.sum()),), None

    step = StepGraph(fn, device=DEV)
    x = torch.ones(3, device=DEV)
    step(x)                         # the eager warm-up reads freely
    with pytest.raises(Exception):
        step(x)                     # the capture does not
