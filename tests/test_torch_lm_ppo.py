"""Port parity for the LM-PPO training slice on the CPU (smoke mamba2 and
smoke gemma2).

The same inputs, made from a seed with numpy, go through the JAX function
and its counterpart in the port:

- token env: one batched ``step`` from the same state, action and chain
  gives the same reward, done, episode step and (where not done) next token
  as JAX's ``vmap(step)``; the chain is JAX's own ``chain_log_probs``,
  passed in.  Rewards equal exactly (a gather of the same f32 table);
- GAE: ``gae_associative`` and ``gae_scan`` against JAX's within 1e-5 +
  1e-5 |adv| (f32, sums in another order); ``build_batch`` against JAX's
  (population std, as ``jnp.std``);
- Adam: three steps with grad clip on the same gradients, params and
  moments within 1e-6 (f32, the same formula);
- the update: ``make_lm_ppo_train_step`` on one fixed batch at an f32
  compute dtype: every metric within 1e-4 relative, params after the Adam
  step within 1e-5 + lr * 2 on at most 0.1 % of entries (Adam's first step
  moves every weight by lr * sign(grad); a gradient within rounding of 0
  can flip its sign), within 1e-5 elsewhere;

and the invariants the JAX tests hold, in the port:

- the serve-path logp of a rollout equals the train-path logp of
  ``forward_train`` (atol 5e-2, tests/test_learning.py:140-150);
- ``n_microbatches`` 1 and 2 give the same SGD step (3e-3) and loss (1e-5)
  (tests/test_algos.py:204-235, on the smoke mamba2 instead of glm4, whose
  training is not ported);
- ``train.main(["--device", "cpu", "--arch", "mamba2-1.3b", "--steps",
  "3"])`` runs and logs finite metrics.

The dense family (smoke gemma2, local / global layer pairs), against JAX on
the same params and batch, on both routes (the JAX kernel in interpret mode
against the port's kernel route, ``ref`` against ``ref``):

- ``forward_train``'s hidden states, ``lm_logits`` and ``value_out`` in f32
  within 1e-4 (measured 3e-6: sums in another order);
- one ``make_lm_ppo_train_step`` in f32 (the kernel route with ``remat``,
  so the backward runs the recompute and the reference vjp): metrics within
  1e-4 relative, params as in the mamba2 test;
- remat and no remat give bit-identical gradients (the recompute is the
  forward); serve-path logp == train-path logp (atol 5e-2, as JAX's test);
- the moe family (smoke qwen2-moe): one update against JAX's on both
  routes with the same bounds (its loss carries 0.01 x the load-balance
  loss in both packages), and ``train.main --arch qwen2-moe-a2.7b`` on the
  CPU with finite metrics;
- the ``lm_ppo_end2end`` twin at ``test_lm_ppo_pipeline_exact_and_stable``'s
  budget (60 steps, batch 16, horizon 16, lr 1e-3) keeps the reward of a
  fresh rollout above the uniform floor's -6.5;
- LM checkpoints: one written by JAX's ``save_checkpoint`` of ``(params,
  opt_state)`` restores into the port's LM and Adam state, and the port's
  restores in JAX, with equal values (a checkpoint copies bytes);
  ``train.main``'s ``--ckpt-dir`` / ``--ckpt-interval`` / ``--restore``
  resume at the saved step and ``--profile`` writes a Chrome trace.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import j2n, port_lm, t2n, to_numpy, torch_cfg  # noqa: E402
from repro.algos.pg import gae as jgae  # noqa: E402
from repro.algos.pg.ppo import make_lm_ppo_train_step as jax_ppo_step  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.envs.token_lm import chain_log_probs as jax_chain  # noqa: E402
from repro.envs.token_lm import make_token_lm as jax_make_token_lm  # noqa: E402
from repro.kernels import registry as jax_registry  # noqa: E402
from repro.models import backbones as jbb  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch.algos.pg import gae as tgae  # noqa: E402
from repro_torch.algos.pg.ppo import make_lm_ppo_train_step  # noqa: E402
from repro_torch.envs import token_lm  # noqa: E402
from repro_torch.examples import lm_ppo_end2end  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import backbones as bb  # noqa: E402
from repro_torch.models.convert import params_of_jax  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402

ARCH = "mamba2-1.3b"
DENSE = "gemma2-2b"
MOE = "qwen2-moe-a2.7b"
# JAX registry spec, port registry spec: the kernel route, the plain one
BACKENDS = {"kernel": ("interpret", "cuda"), "ref": ("ref", "ref")}
V = 256


# ---------------------------------------------------------------------------
# token env
# ---------------------------------------------------------------------------
def test_token_env_step_matches_jax():
    episode_len, B = 5, 64
    jenv = jax_make_token_lm(vocab=V, episode_len=episode_len)
    chain = np.array(jax_chain(V), np.float32)  # a writable copy
    tenv = token_lm.make_token_lm(vocab=V, episode_len=episode_len,
                                  chain_logp=chain)
    r = np.random.RandomState(0)
    tok = r.randint(0, V, B).astype(np.int32)
    t = r.randint(0, episode_len, B).astype(np.int32)
    act = r.randint(0, V, B).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    js, jobs, jrew, jdone, jinfo = jax.vmap(jenv.step)(
        {"tok": jnp.asarray(tok), "t": jnp.asarray(t)}, jnp.asarray(act), keys)
    ts, tobs, trew, tdone, tinfo = tenv.step(
        {"tok": torch.from_numpy(tok), "t": torch.from_numpy(t)},
        torch.from_numpy(act), torch.Generator().manual_seed(1))
    done = np.asarray(jdone)
    assert done.any() and not done.all()
    np.testing.assert_array_equal(t2n(trew), j2n(jrew))
    np.testing.assert_array_equal(tdone.numpy(), done)
    np.testing.assert_array_equal(ts["t"].numpy(), np.asarray(js["t"]))
    np.testing.assert_array_equal(tobs.numpy()[~done], np.asarray(jobs)[~done])
    np.testing.assert_array_equal(tinfo.terminal_obs.numpy(), act)
    assert tobs.dtype == torch.int32 and ((tobs >= 0) & (tobs < V)).all()
    s0, obs0 = tenv.reset(B, torch.Generator().manual_seed(2))
    assert (s0["t"] == 0).all() and torch.equal(s0["tok"], obs0)


def test_chain_log_probs_in_row_blocks(monkeypatch):
    want = torch.log_softmax(2.0 * torch.randn(
        (37, 37), generator=torch.Generator().manual_seed(3)), dim=-1)
    monkeypatch.setattr(token_lm, "_ROW_BLOCK", 8)
    got = token_lm.chain_log_probs(37, temp=2.0, seed=3)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(torch.logsumexp(got, 1), torch.zeros(37),
                               atol=1e-5, rtol=0)


def test_table_free_chain_above_table_max(monkeypatch):
    """Above TABLE_MAX_VOCAB the env holds no (V, V) table: its rewards are
    the rows of ``chain_rows``, a fixed chain of (seed, V) -- rows
    normalised (logsumexp 0 within 1e-5), each row the same wherever it
    sits in a batch, N(0, 1) draws (over 90 000 draws: std within 2 %, the
    share within one sigma 0.6827 +- 0.01), another seed another chain."""
    Vs = 300
    monkeypatch.setattr(token_lm, "TABLE_MAX_VOCAB", 256)
    table = token_lm.chain_rows(torch.arange(Vs), Vs, 1.0, 3)
    torch.testing.assert_close(torch.logsumexp(table, 1), torch.zeros(Vs),
                               atol=1e-5, rtol=0)
    z = table - table.mean(1, keepdim=True)
    assert abs(float(z.std()) - 1.0) < 0.02
    assert abs(float((z.abs() < 1).float().mean()) - 0.6827) < 0.01
    torch.testing.assert_close(
        token_lm.chain_rows(torch.tensor([5, 7, 5]), Vs, 1.0, 3),
        table[[5, 7, 5]], atol=1e-6, rtol=0)
    assert not torch.allclose(token_lm.chain_rows(torch.tensor([5]), Vs,
                                                  1.0, 4), table[5:6])
    env = token_lm.make_token_lm(vocab=Vs, episode_len=5, seed=3)
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(16, gen)
    act = torch.randint(0, Vs, (16,), generator=gen, dtype=torch.int32)
    _, _, reward, _, _ = env.step(state, act, gen)
    torch.testing.assert_close(reward, table[obs.long(), act.long()],
                               atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# GAE and the batch
# ---------------------------------------------------------------------------
def _traj(T=33, B=5, seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(T, B).astype(np.float32), r.randn(T, B).astype(np.float32),
            r.randn(B).astype(np.float32), r.rand(T, B) < 0.1)


@pytest.mark.parametrize("name", ["gae_scan", "gae_associative"])
def test_gae_matches_jax(name):
    rew, val, boot, done = _traj()
    ja, jr = getattr(jgae, name)(*map(jnp.asarray, (rew, val, boot, done)),
                                 gamma=0.99, lam=0.95)
    ta, tr = getattr(tgae, name)(*map(torch.from_numpy, (rew, val, boot, done)),
                                 gamma=0.99, lam=0.95)
    np.testing.assert_allclose(t2n(ta), j2n(ja), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(t2n(tr), j2n(jr), atol=1e-5, rtol=1e-5)


def test_build_batch_matches_jax():
    rew, val, boot, done = _traj(T=8, B=3, seed=1)
    r = np.random.RandomState(2)
    toks = r.randint(0, V, (8, 3)).astype(np.int32)
    acts = r.randint(0, V, (8, 3)).astype(np.int32)
    logp = r.randn(8, 3).astype(np.float32)
    adv, ret = jgae.gae_associative(*map(jnp.asarray, (rew, val, boot, done)),
                                    gamma=0.99, lam=0.95)
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    traj = {"tokens": toks, "actions": acts, "logp": logp, "value": val,
            "reward": rew, "done": done}
    got = train.build_batch({k: torch.from_numpy(v) for k, v in traj.items()},
                            torch.from_numpy(boot))
    want = {"tokens": toks.T, "actions": acts.T, "logp_old": logp.T,
            "advantage": j2n(adv).T, "return_": j2n(ret).T}
    for k, w in want.items():
        np.testing.assert_allclose(t2n(got[k]), w, atol=1e-5, rtol=1e-5,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
def test_adam_three_steps_match_jax():
    r = np.random.RandomState(0)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}
    params = {k: r.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (r.randn(*s) * 0.7).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    jopt = joptim.adam(1e-2, grad_clip=1.0)
    topt = toptim.adam(1e-2, grad_clip=1.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    keys = sorted(shapes)
    tp = [torch.from_numpy(params[k].copy()) for k in keys]
    ts = topt.init(tp)
    for g in grads:
        jp, js, jn = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 js, jp)
        tp, ts, tn = topt.update([torch.from_numpy(g[k]) for k in keys], ts,
                                 tp)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert ts.step == int(js.step) == 3
    for i, k in enumerate(keys):
        np.testing.assert_allclose(t2n(tp[i]), j2n(jp[k]), atol=1e-6, rtol=0)
        np.testing.assert_allclose(t2n(ts.mu[i]), j2n(js.mu[k]), atol=1e-6)
        np.testing.assert_allclose(t2n(ts.nu[i]), j2n(js.nu[k]), atol=1e-6)


def test_sgd_momentum_matches_jax():
    r = np.random.RandomState(1)
    p, g = r.randn(6).astype(np.float32), r.randn(6).astype(np.float32)
    jopt, topt = joptim.sgd(0.1, momentum=0.9), toptim.sgd(0.1, momentum=0.9)
    jp, js = {"w": jnp.asarray(p)}, None
    js = jopt.init(jp)
    tp = [torch.from_numpy(p.copy())]
    ts = topt.init(tp)
    for _ in range(2):
        jp, js, _ = jopt.update({"w": jnp.asarray(g)}, js, jp)
        tp, ts, _ = topt.update([torch.from_numpy(g)], ts, tp)
    np.testing.assert_allclose(t2n(tp[0]), j2n(jp["w"]), atol=1e-6)


# ---------------------------------------------------------------------------
# the update
# ---------------------------------------------------------------------------
def _ppo_batch(B=4, T=16, seed=0):
    r = np.random.RandomState(seed)
    return {"tokens": r.randint(0, V, (B, T)).astype(np.int32),
            "actions": r.randint(0, V, (B, T)).astype(np.int32),
            "logp_old": (r.randn(B, T) * 0.1 - 5.5).astype(np.float32),
            "advantage": r.randn(B, T).astype(np.float32),
            "return_": r.randn(B, T).astype(np.float32)}


def _flat_jax(tree, lm):
    """The JAX params tree in the order of ``lm.parameters()``."""
    flat = {}
    for name, _ in lm.named_parameters():
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            node = tree["blocks"]
            for part in rest.split("."):
                node = node[part]
            flat[name] = np.asarray(node)[int(i)]
        else:
            node = tree
            for part in name.split("."):
                node = node[part]
            flat[name] = np.asarray(node)
    return flat


def test_lm_ppo_train_step_matches_jax():
    jc = dataclasses.replace(jax_smoke(ARCH), compute_dtype="float32")
    tc = torch_cfg(jc)
    params = jbb.init_lm(jax.random.PRNGKey(0), jc)
    lm = port_lm(params, jc, requires_grad=True)
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in lm.parameters())
    batch = _ppo_batch()
    lr = 1e-3
    jopt = joptim.adam(lr, grad_clip=1.0)
    jstep = jax.jit(jax_ppo_step(jc, jopt, entropy_coeff=0.003))
    jp, _, jm = jstep(params, jopt.init(params),
                      {k: jnp.asarray(v) for k, v in batch.items()})
    topt = toptim.adam(lr, grad_clip=1.0)
    tstep = make_lm_ppo_train_step(tc, topt, entropy_coeff=0.003)
    lm, _, tm = tstep(lm, topt.init(lm.parameters()),
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(tm) == {"loss", "grad_norm", "pi_loss", "v_loss", "entropy"}
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    want = _flat_jax(to_numpy(jp), lm)
    n_flip = n_all = 0
    for name, p in lm.named_parameters():
        err = np.abs(t2n(p) - want[name])
        assert err.max() <= 1e-5 + 2 * lr, name
        n_flip += int((err > 1e-5).sum())
        n_all += err.size
    assert n_flip <= 1e-3 * n_all, (n_flip, n_all)


# ---------------------------------------------------------------------------
# invariants of the JAX tests
# ---------------------------------------------------------------------------
def test_serve_logp_equals_train_logp():
    cfg = torch_cfg(jax_smoke(ARCH))
    env = token_lm.make_token_lm(vocab=cfg.vocab, episode_len=16)
    gen = torch.Generator().manual_seed(0)
    lm = bb.init_lm(cfg, device="cpu", generator=gen, dtype=torch.float32,
                    requires_grad=True)
    roll = train.make_lm_rollout(cfg, env, 8, 16, device="cpu")
    traj, v_last = roll(lm, torch.Generator().manual_seed(123))
    assert tuple(traj["logp"].shape) == (16, 8) and tuple(v_last.shape) == (8,)
    tokens, actions = traj["tokens"].T, traj["actions"].T
    with torch.no_grad():
        hidden, _ = bb.forward_train(lm, tokens, cfg)
        logits = bb.lm_logits(lm, hidden, cfg).float()
    logp_train = torch.gather(torch.log_softmax(logits, -1), -1,
                              actions.long()[..., None])[..., 0]
    np.testing.assert_allclose(t2n(logp_train), t2n(traj["logp"].T),
                               atol=5e-2)


def test_lm_ppo_microbatch_invariance():
    cfg = torch_cfg(jax_smoke(ARCH))
    batch = {k: torch.from_numpy(v) for k, v in _ppo_batch(seed=1).items()}
    outs, metrics = [], []
    for n_micro in (1, 2):
        lm = bb.init_lm(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0),
                        dtype=torch.float32, requires_grad=True)
        opt = toptim.sgd(1.0)
        step = make_lm_ppo_train_step(cfg, opt, n_microbatches=n_micro)
        lm, _, m = step(lm, opt.init(lm.parameters()), batch)
        outs.append([t2n(p) for p in lm.parameters()])
        metrics.append(m)
    # params_after = params - grad: compare the implied gradients; the bf16
    # forward's summation order across micro splits costs ~1e-3 relative
    assert max(np.abs(a - b).max() for a, b in zip(*outs)) < 3e-3
    assert abs(float(metrics[0]["loss"]) - float(metrics[1]["loss"])) < 1e-5


def test_train_main_on_cpu_logs_finite_metrics(tmp_path):
    lm = train.main(["--device", "cpu", "--arch", ARCH, "--steps", "3",
                     "--batch", "4", "--horizon", "8", "--log-dir",
                     str(tmp_path)])
    rows = [json.loads(ln) for ln in
            (tmp_path / "progress.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3]
    keys = ("avg_reward", "loss", "grad_norm", "pi_loss", "v_loss",
            "entropy", "samples_per_sec", "rollout_s", "update_s")
    for r in rows:
        assert all(np.isfinite(r[k]) for k in keys), r
    assert (tmp_path / "progress.csv").read_text().startswith("step,")
    assert all(torch.isfinite(p).all() for p in lm.parameters())


def test_train_defaults():
    ap = train.build_parser()
    assert ap.get_default("device") == "cuda"
    assert ap.get_default("arch") == "gemma2-2b"


# ---------------------------------------------------------------------------
# the dense family (smoke gemma2)
# ---------------------------------------------------------------------------
def _dense(remat=False, seed=0):
    jc = dataclasses.replace(jax_smoke(DENSE), compute_dtype="float32",
                             remat=remat)
    return jc, torch_cfg(jc), jbb.init_lm(jax.random.PRNGKey(seed), jc)


def _named_jax(jax_tree, lm, cfg):
    """The JAX params tree as numpy, by the port's parameter names."""
    names = [n for n, _ in lm.named_parameters()]
    return dict(zip(names, params_of_jax(to_numpy(jax_tree), names, cfg)))


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_dense_forward_train_matches_jax(backend):
    jc, tc, params = _dense()
    lm = port_lm(params, jc)
    toks = np.random.RandomState(0).randint(0, V, (2, 24)).astype(np.int32)
    jspec, tspec = BACKENDS[backend]
    with jax_registry.override(jspec):
        jh, _ = jax.jit(lambda p, t: jbb.forward_train(p, t, jc))(
            params, jnp.asarray(toks))
        want = (jh, jbb.lm_logits(params, jh, jc), jbb.value_out(params, jh))
    with registry.override(tspec), torch.no_grad():
        th, aux = bb.forward_train(lm, torch.from_numpy(toks), tc)
        got = (th, bb.lm_logits(lm, th, tc), bb.value_out(lm, th))
    assert float(aux) == 0.0
    for name, a, b in zip(("hidden", "logits", "value"), got, want):
        np.testing.assert_allclose(t2n(a), j2n(b), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_dense_lm_ppo_train_step_matches_jax(backend):
    remat = backend == "kernel"
    jc, tc, params = _dense(remat=remat)
    lm = port_lm(params, jc, requires_grad=True)
    batch = _ppo_batch()
    lr = 1e-3
    jspec, tspec = BACKENDS[backend]
    jopt = joptim.adam(lr, grad_clip=1.0)
    with jax_registry.override(jspec):
        jp, _, jm = jax.jit(jax_ppo_step(jc, jopt, entropy_coeff=0.003))(
            params, jopt.init(params),
            {k: jnp.asarray(v) for k, v in batch.items()})
    topt = toptim.adam(lr, grad_clip=1.0)
    with registry.override(tspec):
        lm, _, tm = make_lm_ppo_train_step(tc, topt, entropy_coeff=0.003)(
            lm, topt.init(lm.parameters()),
            {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    want = _named_jax(jp, lm, tc)
    n_flip = n_all = 0
    for name, p in lm.named_parameters():
        err = np.abs(t2n(p) - want[name])
        assert err.max() <= 1e-5 + 2 * lr, name
        n_flip += int((err > 1e-5).sum())
        n_all += err.size
    assert n_flip <= 1e-3 * n_all, (n_flip, n_all)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_moe_lm_ppo_train_step_matches_jax(backend):
    """The moe family (smoke qwen2-moe, shared experts): one update, whose
    loss adds 0.01 x the layers' load-balance loss in both packages, with
    the bounds of the dense test (the kernel route with remat)."""
    jc = dataclasses.replace(jax_smoke(MOE), compute_dtype="float32",
                             remat=backend == "kernel")
    tc = torch_cfg(jc)
    params = jbb.init_lm(jax.random.PRNGKey(3), jc)
    lm = port_lm(params, jc, requires_grad=True)
    batch = _ppo_batch()
    lr = 1e-3
    jspec, tspec = BACKENDS[backend]
    jopt = joptim.adam(lr, grad_clip=1.0)
    with jax_registry.override(jspec):
        jp, _, jm = jax.jit(jax_ppo_step(jc, jopt, entropy_coeff=0.003))(
            params, jopt.init(params),
            {k: jnp.asarray(v) for k, v in batch.items()})
    topt = toptim.adam(lr, grad_clip=1.0)
    with registry.override(tspec):
        lm, _, tm = make_lm_ppo_train_step(tc, topt, entropy_coeff=0.003)(
            lm, topt.init(lm.parameters()),
            {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    want = _named_jax(jp, lm, tc)
    n_flip = n_all = 0
    for name, p in lm.named_parameters():
        err = np.abs(t2n(p) - want[name])
        assert err.max() <= 1e-5 + 2 * lr, name
        n_flip += int((err > 1e-5).sum())
        n_all += err.size
    assert n_flip <= 1e-3 * n_all, (n_flip, n_all)


def test_moe_train_main_on_cpu_logs_finite_metrics(tmp_path):
    lm = train.main(["--device", "cpu", "--arch", MOE, "--steps", "2",
                     "--batch", "4", "--horizon", "8", "--log-dir",
                     str(tmp_path)])
    rows = [json.loads(ln) for ln in
            (tmp_path / "progress.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in rows)
    assert all(torch.isfinite(p).all() for p in lm.parameters())


def test_dense_remat_gradients_equal_plain():
    """Checkpointed superblocks recompute the same forward: the gradients
    of both routes with and without remat are bit-identical."""
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, V, (2, 20)).astype(np.int32))
    for spec in ("cuda", "ref"):
        grads = []
        for remat in (False, True):
            jc, tc, params = _dense(remat=remat)
            lm = port_lm(params, jc, requires_grad=True)
            with registry.override(spec):
                hidden, _ = bb.forward_train(lm, toks, tc)
                loss = (bb.lm_logits(lm, hidden, tc).square().mean()
                        + bb.value_out(lm, hidden).square().mean())
                grads.append(torch.autograd.grad(loss, list(lm.parameters())))
        for a, b in zip(*grads):
            assert torch.equal(a, b), spec


def test_dense_serve_logp_equals_train_logp():
    cfg = torch_cfg(jax_smoke(DENSE))
    env = token_lm.make_token_lm(vocab=cfg.vocab, episode_len=16)
    lm = bb.init_lm(cfg, device="cpu", generator=torch.Generator().manual_seed(0),
                    dtype=torch.float32, requires_grad=True)
    roll = train.make_lm_rollout(cfg, env, 8, 16, device="cpu")
    traj, _ = roll(lm, torch.Generator().manual_seed(123))
    tokens, actions = traj["tokens"].T, traj["actions"].T
    with torch.no_grad():
        hidden, _ = bb.forward_train(lm, tokens, cfg)
        logits = bb.lm_logits(lm, hidden, cfg).float()
    logp_train = torch.gather(torch.log_softmax(logits, -1), -1,
                              actions.long()[..., None])[..., 0]
    np.testing.assert_allclose(t2n(logp_train), t2n(traj["logp"].T),
                               atol=5e-2)


def test_lm_ppo_end2end_learning_bar():
    """tests/test_learning.py::test_lm_ppo_pipeline_exact_and_stable's bar
    on the twin's model (smoke gemma2): after 60 steps at batch 16, horizon
    16, lr 1e-3, a fresh rollout's mean reward stays above -6.5 (the
    uniform policy's is about -6.2)."""
    lm = lm_ppo_end2end.main(["--device", "cpu", "--steps", "60", "--batch",
                              "16", "--horizon", "16"])
    cfg = torch_cfg(jax_smoke(DENSE))
    env = token_lm.make_token_lm(vocab=cfg.vocab, episode_len=16)
    roll = train.make_lm_rollout(cfg, env, 16, 16, device="cpu")
    traj, _ = roll(lm, torch.Generator().manual_seed(123))
    r = float(torch.mean(traj["reward"]))
    assert np.isfinite(r) and r > -6.5, r


def test_lm_checkpoint_crosses_both_ways(tmp_path):
    jc, tc, params = _dense()
    r = np.random.RandomState(6)

    def rand(a):
        return jnp.asarray(r.randn(*np.shape(a)).astype(np.float32))

    jstate = joptim.OptState(step=jnp.asarray(7, jnp.int32),
                             mu=jax.tree_util.tree_map(rand, params),
                             nu=jax.tree_util.tree_map(
                                 lambda a: jnp.abs(rand(a)), params))
    jckpt.save_checkpoint(str(tmp_path / "jax"), 5, (params, jstate))
    lm = bb.init_lm(tc, device="cpu", generator=torch.Generator().manual_seed(1),
                    dtype=torch.float32, requires_grad=True)
    state = toptim.adam(1e-3).init(lm.parameters())
    state, manifest = tckpt.restore_lm_checkpoint(str(tmp_path / "jax"), lm,
                                                  state, tc)
    assert manifest["step"] == 5 and state.step == 7
    names = [n for n, _ in lm.named_parameters()]
    for tree, got in ((params, [p for _, p in lm.named_parameters()]),
                      (jstate.mu, state.mu), (jstate.nu, state.nu)):
        for want, t in zip(params_of_jax(to_numpy(tree), names, tc), got):
            np.testing.assert_array_equal(t2n(t), want)
    tckpt.save_lm_checkpoint(str(tmp_path / "port"), 6, lm, state, tc)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    like = (zeros, joptim.OptState(step=jnp.asarray(0, jnp.int32), mu=zeros,
                                   nu=zeros))
    (jp, js), manifest = jckpt.restore_checkpoint(str(tmp_path / "port"), like)
    assert manifest["step"] == 6 and int(js.step) == 7
    for a, b in zip(jax.tree_util.tree_leaves((params, jstate.mu, jstate.nu)),
                    jax.tree_util.tree_leaves((jp, js.mu, js.nu))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_train_main_checkpoints_restore_and_profile(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    common = ["--device", "cpu", "--batch", "2", "--horizon", "4",
              "--ckpt-dir", ck, "--ckpt-interval", "1"]
    lm = train.main(common + ["--steps", "2", "--log-dir",
                              str(tmp_path / "a"), "--profile"])
    assert tckpt.latest_step(ck) == 2
    assert (tmp_path / "a" / "profile" / "train_trace.json").stat().st_size
    spans = [json.loads(ln)["name"] for ln in
             (tmp_path / "a" / "trace.jsonl").read_text().splitlines()]
    assert spans.count("checkpoint") == 2
    cfg = torch_cfg(jax_smoke(DENSE))
    fresh = bb.init_lm(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(9),
                       dtype=torch.float32, requires_grad=True)
    state, _ = tckpt.restore_lm_checkpoint(
        ck, fresh, toptim.adam(1e-3).init(fresh.parameters()), cfg)
    assert state.step == 2
    for a, b in zip(fresh.parameters(), lm.parameters()):
        assert torch.equal(a, b)
    train.main(common + ["--steps", "3", "--restore", "--log-dir",
                         str(tmp_path / "b")])
    assert "restored step 2" in capsys.readouterr().out
    rows = [json.loads(ln) for ln in
            (tmp_path / "b" / "progress.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [3]
    assert tckpt.latest_step(ck) == 3


@pytest.mark.parametrize("arch", [DENSE, ARCH])
def test_apply_superblock_train_matches_jax(arch):
    """``backbones.apply_superblock_train`` (the public name of one
    superblock's training forward) against JAX's on superblock 0 of the
    smoke config at an f32 compute dtype, the plain routes: within 1e-4
    (sums in another order)."""
    jc = dataclasses.replace(jax_smoke(arch), compute_dtype="float32")
    tc = torch_cfg(jc)
    params = jbb.init_lm(jax.random.PRNGKey(0), jc)
    lm = port_lm(params, jc)
    x = np.random.RandomState(7).randn(2, 16, jc.d_model).astype(np.float32)
    block = jax.tree_util.tree_map(lambda a: a[0], params["blocks"])
    with jax_registry.override("ref"):
        jy, jaux = jbb.apply_superblock_train(block, jnp.asarray(x), jc)
    _, per_block, _ = bb.superblock_layout(tc)
    with registry.override("ref"), torch.no_grad():
        ty, taux = bb.apply_superblock_train(
            torch.from_numpy(x), tc, (None, None, None),
            *lm.layers[:per_block])
    np.testing.assert_allclose(t2n(ty), j2n(jy), atol=1e-4, rtol=1e-4)
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("n_micro", [1, 2])
def test_cast_weights_bf16_update_matches_jax(n_micro):
    """``cfg.cast_weights_bf16`` (JAX's ``maybe_cast``): the forward and its
    recompute read bf16 casts of every weight whose JAX leaf has two or
    more dims, the gradients reach the f32 masters; one update of the
    smoke gemma2 at an f32 compute dtype (remat on), in one microbatch and
    in two (each enters its own cast), against JAX's with the same flag,
    the plain routes: the dense test's bounds, and the casts move the loss
    (it differs from the uncast update's)."""
    jc, _, params = _dense(remat=True)
    jc = dataclasses.replace(jc, cast_weights_bf16=True)
    tc = torch_cfg(jc)
    lm = port_lm(params, jc, requires_grad=True)
    batch = _ppo_batch()
    lr = 1e-3
    jopt = joptim.adam(lr, grad_clip=1.0)
    with jax_registry.override("ref"):
        jstep = jax_ppo_step(jc, jopt, entropy_coeff=0.003,
                             n_microbatches=n_micro)
        jp, _, jm = jax.jit(jstep)(
            params, jopt.init(params),
            {k: jnp.asarray(v) for k, v in batch.items()})
    topt = toptim.adam(lr, grad_clip=1.0)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with registry.override("ref"):
        plain = make_lm_ppo_train_step(
            dataclasses.replace(tc, cast_weights_bf16=False), topt,
            entropy_coeff=0.003, n_microbatches=n_micro)
        _, _, ref = plain(port_lm(params, jc, requires_grad=True),
                          topt.init(lm.parameters()), tbatch)
        lm, _, tm = make_lm_ppo_train_step(tc, topt, entropy_coeff=0.003,
                                           n_microbatches=n_micro)(
            lm, topt.init(lm.parameters()), tbatch)
    assert all(p.dtype == torch.float32 for p in lm.parameters())
    assert float(tm["loss"]) != float(ref["loss"])
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    want = _named_jax(jp, lm, tc)
    n_flip = n_all = 0
    for name, p in lm.named_parameters():
        err = np.abs(t2n(p) - want[name])
        assert err.max() <= 1e-5 + 2 * lr, name
        n_flip += int((err > 1e-5).sum())
        n_all += err.size
    assert n_flip <= 1e-3 * n_all, (n_flip, n_all)
