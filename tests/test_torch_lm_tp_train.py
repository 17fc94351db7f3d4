"""The LM mesh's 'model' axis in training: the PPO step, compression,
rollouts, checkpoints and ``train.main --mesh DxM`` on gloo ranks on the
CPU, held against the JAX package's unsharded step (and, for 2 x 2, its
step under ``jax.vmap(axis_name="data")``, as
``tests/test_torch_lm_mesh.py`` holds the data axis), f32 compute:

- 3 Adam steps (clip 1.0, whose norm is the logical tensors') at 1 x 2 on
  smoke qwen2-moe (its experts, shared experts, router and vocab split)
  and smoke mamba2 (its SSD heads): every metric within 1e-4 relative
  (+1e-6) of JAX's, the gathered parameters within 1e-5 + 6 lr everywhere
  and within 1e-5 on all but 1e-3 of the elements (the bounds of the data
  axis' test: an Adam step moves a weight by about lr, and a gradient
  within rounding of 0 may take the other side), every replicated leaf
  equal on the two ranks bit for bit;
- 2 x 2 with ``int8_ef`` on smoke gemma2 against JAX's step under vmap
  over 'data': the same bounds, and the gathered EF residual within 1e-5
  + one int8 step of its leaf and within 1e-5 + 0.01 step on all but 1e-3
  of the elements (the data axis' bounds; a scale is the amax over the
  logical leaf, maxed over the model axis);
- a rollout on a model group: every rank samples the same actions from the
  same gathered logits, bit for bit;
- checkpoints: saved at 1 x 2 and restored at 1 x 1, and saved at 1 x 1
  and restored at 1 x 2, bit for bit;
- ``train.main --mesh 1x2`` and ``--mesh 2x2 --compress``: rows with
  ``tp_allreduce_s``, and a restore equal to an unbroken run bit for bit.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_ranks as R  # noqa: E402
import _torch_tp as TP  # noqa: E402
from _torch_parity import to_numpy, torch_cfg  # noqa: E402
from repro.algos.pg.ppo import make_lm_ppo_train_step as jax_ppo_step  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import registry as jax_registry  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch.algos.pg.ppo import make_lm_ppo_train_step  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import backbones as tbb  # noqa: E402
from repro_torch.models import sharding as tshd  # noqa: E402
from repro_torch.models.convert import (params_from_jax,  # noqa: E402
                                        params_of_jax, params_to_jax)
from repro_torch.train import optim as toptim  # noqa: E402
from repro_torch.train.checkpoint import (restore_lm_checkpoint,  # noqa: E402
                                          save_lm_checkpoint)

LR = 1e-3
PPO_ARCHS = ("qwen2-moe-a2.7b", "mamba2-1.3b")


def smoke(arch, **kw):
    return dataclasses.replace(jax_smoke(arch), compute_dtype="float32",
                               n_layers=2, **kw)


def init(jc, seed=0):
    tc = torch_cfg(jc)
    lm = tbb.init_lm(tc, device="cpu", generator=torch.Generator()
                     .manual_seed(seed), dtype=torch.float32)
    return to_numpy(params_to_jax(lm.named_parameters(), tc))


def batches(vocab, n_steps, D, B, T, seed):
    """``n_steps`` LM-PPO batches of D x B rows ({key: (D, B, T)})."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n_steps):
        shape = (D, B, T)
        out.append({
            "tokens": r.randint(0, vocab, shape).astype(np.int32),
            "actions": r.randint(0, vocab, shape).astype(np.int32),
            "logp_old": (-np.abs(r.randn(*shape))).astype(np.float32),
            "advantage": r.randn(*shape).astype(np.float32),
            "return_": r.randn(*shape).astype(np.float32)})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of 2 ranks (1 x 2: the PPO cases, the rollout, the
    checkpoints both ways) and one of 4 (2 x 2 compressed)."""
    inputs, two = {}, {}
    for arch in PPO_ARCHS:
        jc = smoke(arch)
        params = init(jc)
        bs = batches(jc.vocab, 3, 1, 2, 8, seed=1)
        inputs[arch] = (jc, params, bs)
        two[f"ppo_{arch}"] = dict(kind="ppo", np_params=params,
                                  cfg=torch_cfg(jc), batches=bs, lr=LR)
    jc, params, bs = inputs["qwen2-moe-a2.7b"]
    tc = torch_cfg(jc)
    two["rollout"] = dict(kind="rollout", np_params=params, cfg=tc, batch=4,
                          horizon=6, seed=3)
    # a 1 x 1 checkpoint for the ranks to restore at 1 x 2
    d = tmp_path_factory.mktemp("tp_ckpt")
    one = d / "one"
    lm = params_from_jax(params, tc, device="cpu", requires_grad=True)
    opt = toptim.adam(LR, grad_clip=1.0)
    state = opt.init(lm.parameters())
    step = make_lm_ppo_train_step(tc, opt, entropy_coeff=0.003)
    b2 = {k: torch.from_numpy(v[0]) for k, v in
          batches(jc.vocab, 1, 1, 2, 8, seed=5)[0].items()}
    with R.one_thread():
        lm, state, _ = step(lm, state, b2)
    save_lm_checkpoint(str(one), 1, lm, state, tc)
    inputs["one"] = (lm, state, tc, str(one), str(d / "two"))
    two["ckpt"] = dict(kind="ckpt", np_params=params, cfg=tc,
                       batch={k: v.numpy() for k, v in b2.items()}, lr=LR,
                       save_dir=str(d / "two"), restore_dir=str(one))
    out2 = R.run_ranks(TP.tp_body, 2, 2, two)
    gjc = smoke("gemma2-2b")
    gparams = init(gjc)
    gbs = batches(gjc.vocab, 3, 2, 2, 8, seed=2)
    inputs["gemma2_22"] = (gjc, gparams, gbs)
    four = {"ppo22": dict(kind="ppo", np_params=gparams, cfg=torch_cfg(gjc),
                          batches=gbs, lr=LR, compress="int8_ef")}
    out4 = R.run_ranks(TP.tp_body, 4, 2, four)
    return inputs, out2, out4


def _jax_steps(jc, params, bs, compress=None, n_data=1):
    """JAX's unsharded step (n_data 1) or its step under vmap over
    'data'."""
    base = joptim.adam(LR, grad_clip=1.0)
    if n_data == 1:
        step = jax.jit(jax_ppo_step(jc, base, entropy_coeff=0.003))
        p = jax.tree_util.tree_map(jnp.asarray, params)
        s = base.init(p)
        ms = []
        with jax_registry.override("ref"):
            for b in bs:
                p, s, m = step(p, s, {k: jnp.asarray(v[0])
                                      for k, v in b.items()})
                ms.append(m)
        return p, s, ms
    opt = joptim.cross_replica(base, "data", compress=compress, ef_shards=1)
    step = jax.jit(jax.vmap(jax_ppo_step(jc, opt, entropy_coeff=0.003),
                            axis_name="data"))
    pn = jax.tree_util.tree_map(lambda x: jnp.stack([jnp.asarray(x)]
                                                    * n_data), params)
    with jax_registry.override("ref"):
        sn = jax.vmap(opt.init)(pn)
        ms = []
        for b in bs:
            pn, sn, m = step(pn, sn, {k: jnp.asarray(v)
                                      for k, v in b.items()})
            ms.append(m)
    return pn, sn, ms


def _params_close(got, want_tree, names, tc):
    want = params_of_jax(to_numpy(want_tree), names, tc)
    n_off = n_all = 0
    for name, b in zip(names, want):
        err = np.abs(got[name] - b)
        assert err.max() <= 1e-5 + 6 * LR, (name, err.max())
        n_off += int((err > 1e-5).sum())
        n_all += err.size
    assert n_off <= 1e-3 * n_all, (n_off, n_all)


def _metrics_close(got, want, r=None):
    for t, (tm, jm) in enumerate(zip(got, want)):
        assert set(tm) == set(jm), (set(tm), set(jm))
        for k in tm:
            j = jm[k] if r is None else jm[k][r]
            np.testing.assert_allclose(tm[k], float(j), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{k} step {t}")


@pytest.mark.parametrize("arch", PPO_ARCHS)
def test_ppo_step_on_two_model_ranks_matches_jax(runs, arch):
    inputs, out2, _ = runs
    jc, params, bs = inputs[arch]
    p, _, ms = _jax_steps(jc, params, bs)
    for got in (o[f"ppo_{arch}"] for o in out2):
        _metrics_close(got["metrics"], ms)
        _params_close(got["params"], p, got["names"], torch_cfg(jc))
    a, b = (o[f"ppo_{arch}"] for o in out2)
    assert any(a["split"])
    for sharded, x, y, name in zip(a["split"], a["local"], b["local"],
                                   a["names"]):
        if sharded:
            assert x.shape == y.shape
        else:   # replicated leaves stay equal across the model group
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_compressed_2x2_matches_jax_under_vmap(runs):
    inputs, _, out4 = runs
    jc, params, bs = inputs["gemma2_22"]
    tc = torch_cfg(jc)
    pn, sn, ms = _jax_steps(jc, params, bs, compress="int8_ef", n_data=2)
    for rank, o in enumerate(out4):
        got, d = o["ppo22"], rank // 2     # row-major: data = rank // M
        _metrics_close(got["metrics"], ms, d)
        assert {"compress_err_norm", "grad_norm_shard_max"} <= \
            set(got["metrics"][0])
        _params_close(got["params"], jax.tree_util.tree_map(
            lambda x: x[d], pn), got["names"], tc)
        res = jax.tree_util.tree_map(lambda x: x[d, 0], sn.ef.residual)
        want = params_of_jax(to_numpy(res), got["names"], tc)
        n_off = n_all = 0
        for name, b in zip(got["names"], want):
            quantum = 2 * np.abs(b).max()
            err = np.abs(got["residual"][name] - b)
            assert err.max() <= 1e-5 + quantum, name
            n_off += int((err > 1e-5 + 0.01 * quantum).sum())
            n_all += err.size
        assert n_off <= 1e-3 * n_all, (n_off, n_all)
    for a, b in ((out4[0], out4[1]), (out4[2], out4[3])):
        for sharded, x, y in zip(a["ppo22"]["split"], a["ppo22"]["local"],
                                 b["ppo22"]["local"]):
            if not sharded:
                np.testing.assert_array_equal(x, y)


def test_model_group_takes_the_same_actions(runs):
    _, out2, _ = runs
    a, b = (o["rollout"] for o in out2)
    for k in ("actions", "logp", "value"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert np.isfinite(a["logp"]).all() and a["actions"].shape == (6, 4)


def test_params_to_jax_gathers_a_ranks_blocks(runs):
    """``params_from_jax`` gives each rank its blocks and
    ``params_to_jax(specs=, mesh=)`` gathers them back into JAX's leaves,
    bit for bit."""
    inputs, out2, _ = runs
    _, params, _ = inputs["qwen2-moe-a2.7b"]
    want = jax.tree_util.tree_leaves(params)
    for o in out2:
        got = o["rollout"]
        assert got["local_vocab"] == params["tok_embed"].shape[0] // 2
        leaves = jax.tree_util.tree_leaves(got["to_jax"])
        assert len(leaves) == len(want)
        for x, y in zip(leaves, want):
            np.testing.assert_array_equal(x, y)


def test_checkpoints_between_one_and_two_model_ranks(runs):
    """Saved at 1 x 2, restored at 1 x 1; saved at 1 x 1, restored at
    1 x 2: bit for bit."""
    inputs, out2, _ = runs
    lm1, state1, tc, one_dir, two_dir = inputs["one"]
    saved = out2[0]["ckpt"]["saved"]
    assert out2[0]["ckpt"]["manifest_mesh"] is None   # written at 1 x 1
    fresh = params_from_jax(init(smoke("qwen2-moe-a2.7b")), tc,
                            device="cpu", requires_grad=True)
    opt = toptim.adam(LR, grad_clip=1.0)
    st, manifest = restore_lm_checkpoint(two_dir, fresh, opt.init(
        fresh.parameters()), tc)
    assert manifest["mesh_shape"] == [1, 2] and int(st.step) == 1
    names = [n for n, _ in fresh.named_parameters()]
    for i, (n, p) in enumerate(fresh.named_parameters()):
        np.testing.assert_array_equal(p.detach().numpy(), saved["params"][n])
        np.testing.assert_array_equal(st.mu[i].numpy(), saved["mu"][n])
        np.testing.assert_array_equal(st.nu[i].numpy(), saved["nu"][n])
    specs = tshd.param_pspecs(lm1, tc, tp=2)
    for r, o in enumerate(out2):
        got = o["ckpt"]["restored"]
        assert got["step"] == 1 and got["names"] == names
        for i, n in enumerate(names):
            mesh = type("Rank", (), {"index": r, "size": 2})()
            for want, have in ((dict(lm1.named_parameters())[n],
                                got["params"][i]),
                               (state1.mu[i], got["mu"][i]),
                               (state1.nu[i], got["nu"][i])):
                block = tshd.local_slice(n, want.detach(), specs[n], mesh)
                np.testing.assert_array_equal(have, block.numpy(),
                                              err_msg=n)


# ---------------------------------------------------------------------------
# train.main --mesh DxM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh, extra", [("1x2", []),
                                         ("2x2", ["--compress"])])
def test_main_runs_the_model_axis(tmp_path, mesh, extra):
    """``train --device cpu --mesh DxM``: main spawns D x M ranks; rank 0's
    rows carry ``tp_allreduce_s``; every rank logs."""
    log = tmp_path / "log"
    assert train.main(["--device", "cpu", "--mesh", mesh, "--steps", "2",
                       "--batch", "4", "--horizon", "6", "--log-dir",
                       str(log)] + extra) is None
    n = 4 if mesh == "2x2" else 2
    for d in [log] + [log / f"rank_{r}" for r in range(1, n)]:
        rows = [json.loads(x) for x in
                (d / "progress.jsonl").read_text().splitlines()]
        assert [row["step"] for row in rows] == [1, 2]
        for row in rows:
            keys = {"avg_reward", "loss", "entropy", "tp_allreduce_s",
                    "allreduce_s"}
            assert keys <= set(row) and all(math.isfinite(row[k])
                                            for k in keys)
            assert row["tp_allreduce_s"] > 0
            if extra:
                assert row["compress_err_norm"] > 0


def test_main_on_a_model_group_restores_bit_for_bit(tmp_path):
    """``train.main --mesh 1x2`` joined from the caller's group: a run
    saved at step 2 and resumed equals the unbroken 4-step run, and the
    two ranks' replicated leaves agree."""
    argv = ["--device", "cpu", "--mesh", "1x2", "--batch", "2", "--horizon",
            "6"]
    out = R.run_ranks(R.train_main_restore_body, 2, str(tmp_path / "ck"),
                      argv)
    for o in out:
        for a, b in zip(o["whole"], o["resumed"]):
            np.testing.assert_array_equal(a, b)
    shapes = [[a.shape for a in o["whole"]] for o in out]
    assert shapes[0] == shapes[1]
