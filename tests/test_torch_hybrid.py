"""Port parity for the hybrid family (zamba2-7b) on the CPU.

Against JAX, on zamba2's smoke config (5 layers: 2 superblocks of 2 Mamba-2
layers and the shared attention block, then 1 tail layer; d_head 16, SSD
P 16, N 16, chunk 8), with the JAX ``init_lm`` weights carried over by
``params_from_jax`` and tokens from a numpy seed, in an f32 compute dtype:

- ``forward_train``'s hidden states, logits and value within 1e-4 of each
  one's largest entry (the two sides sum in other orders, the SSD scan's
  f32 chunk sums carried through five layers), aux 0, on the kernel route (JAX's
  Pallas kernels in interpret mode against the port's ``cuda`` spec, whose
  CPU path is the plain version) and the ``ref`` route;
- ``prefill`` then three greedy ``decode_step``s: every cache leaf (the
  superblocks' conv / SSM states, the shared block's K/V a site, the tail's
  states, lengths) and every step's logits within 1e-4 of the largest
  entry;
- a decode step writes each site's K/V at the new position only, site i
  into site i's cache;
- one LM-PPO update (remat on the kernel route, as JAX's
  ``jax.checkpoint`` per superblock and tail layer): the metrics within
  1e-3 relative and the parameters as the dense test bounds them.  The
  smoke hybrid's gradients are large and ill-conditioned (norm 129.6 at
  this batch): JAX's own two routes give grad_norm 129.657 and 129.639
  (1.4e-4 apart) and the port 129.588 on both; leaf by leaf the port's
  gradients sit within 5e-4 of the largest entry of JAX's (1e-5 for the
  smoke mamba2), so the bound is on rounding, not on the math;
- ``params_to_jax`` gives JAX's tree back exactly (``shared_attn`` once,
  ``blocks/mamba`` stacked (n_sb, attn_every, ...), ``tail_blocks``), and
  at full size (on the meta device) the leaves have JAX's names and shapes;
- ``train.main --arch zamba2-7b`` on the CPU: two PPO steps, finite; and
  ``--layers`` cuts the depth.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (assert_close_to_largest,  # noqa: E402
                           assert_serving_matches, assert_update_matches,
                           flat_tree, jax_prefill_steps, leaf_shapes,
                           port_lm, port_prefill_steps, ppo_batch, t2n,
                           to_numpy, torch_cfg)
from repro.algos.pg.ppo import make_lm_ppo_train_step as jax_ppo_step  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import registry as jax_registry  # noqa: E402
from repro.models import backbones as jbb  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch.algos.pg.ppo import make_lm_ppo_train_step  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import backbones as bb  # noqa: E402
from repro_torch.models.convert import params_to_jax  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402

ARCH = "zamba2-7b"
BACKENDS = {"kernel": ("interpret", "cuda"), "ref": ("ref", "ref")}
B, T, STEPS = 2, 20, 3
S = T + STEPS + 1


def _smoke(remat=False, seed=0):
    jc = dataclasses.replace(jax_smoke(ARCH), compute_dtype="float32",
                             remat=remat)
    return jc, torch_cfg(jc), jbb.init_lm(jax.random.PRNGKey(seed), jc)


def _tokens(vocab, shape=(B, T), seed=0):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


def test_layout_and_cache_leaves():
    assert bb.superblock_layout(get_config(ARCH)) == (13, 6, 3)
    jc, tc, _ = _smoke()
    assert bb.superblock_layout(tc) == jbb.superblock_layout(jc) == (2, 2, 1)
    cache = bb.init_cache(tc, B, S, device="cpu")
    want = jbb.init_cache(jc, B, S)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_forward_train_matches_jax(backend):
    jc, tc, params = _smoke()
    lm = port_lm(params, jc)
    toks = _tokens(tc.vocab, (B, 24))
    jspec, tspec = BACKENDS[backend]
    with jax_registry.override(jspec):
        jh, jaux = jax.jit(lambda p, t: jbb.forward_train(p, t, jc))(
            params, jnp.asarray(toks))
        want = (jh, jbb.lm_logits(params, jh, jc), jbb.value_out(params, jh))
    with registry.override(tspec), torch.no_grad():
        th, aux = bb.forward_train(lm, torch.from_numpy(toks), tc)
        got = (th, bb.lm_logits(lm, th, tc), bb.value_out(lm, th))
    assert float(aux) == float(jaux) == 0.0
    for name, a, b in zip(("hidden", "logits", "value"), got, want):
        assert_close_to_largest(t2n(a), b, 1e-4, name)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_prefill_and_decode_steps_match_jax(backend):
    jc, tc, params = _smoke(seed=1)
    lm = port_lm(params, jc)
    prompts = _tokens(tc.vocab, seed=1)
    jspec, tspec = BACKENDS[backend]
    jout = jax_prefill_steps(jc, params, prompts, {}, jspec, S, STEPS)
    tout = port_prefill_steps(tc, lm, prompts, {}, tspec, S, jout[2])
    assert set(tout[0][0]) == {"lengths", "conv", "ssm", "k", "v",
                               "tail_conv", "tail_ssm"}
    assert_serving_matches(jout, tout)


def test_decode_step_writes_each_site_at_the_new_position():
    _, tc, _ = _smoke()
    lm = bb.init_lm(tc, device="cpu", generator=torch.Generator().manual_seed(0))
    prompts = torch.from_numpy(_tokens(tc.vocab, seed=2))
    with torch.inference_mode():
        cache = bb.init_cache(tc, B, S, device="cpu")
        _, cache = bb.prefill(lm, prompts, tc, cache)
        before = {k: cache[k].clone() for k in ("k", "v")}
        k_site0 = cache["k"][0].clone()
        _, cache = bb.decode_step(lm, cache, prompts[:, -1], tc)
    pos = torch.arange(S)[None, :] == T  # (1, S): the new token's slot
    for name, old in before.items():
        changed = (cache[name] != old).any(-1).any(-1)  # (n_sb, B, S)
        assert changed.shape == (2, B, S)
        assert torch.equal(changed, pos.expand(2, B, S)), name
    # site 0's slot holds the shared block's K at site 0's input, which
    # differs from site 1's (other inputs, same weights)
    assert not torch.equal(cache["k"][0, :, T], cache["k"][1, :, T])
    assert torch.equal(cache["k"][0, :, :T], k_site0[:, :T])


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_lm_ppo_train_step_matches_jax(backend):
    """One update of the smoke hybrid (the SSD scan and the shared block's
    attention under remat on the kernel route), as the dense / moe tests."""
    jc, tc, params = _smoke(remat=backend == "kernel", seed=3)
    lm = port_lm(params, jc, requires_grad=True)
    batch = ppo_batch(tc.vocab)
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
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-3,
                                   atol=1e-6, err_msg=k)
    assert_update_matches(lm, jp, tc, lr)


def test_params_to_jax_round_trip_and_full_size_leaves():
    jc, tc, params = _smoke(seed=4)
    lm = port_lm(params, jc)
    got = flat_tree(params_to_jax(lm.named_parameters(), tc))
    want = flat_tree(to_numpy(params))
    assert set(got) == set(want)
    assert {"shared_attn/attn/wq", "blocks/mamba/ssd/wx",
            "tail_blocks/ssd/wx"} <= set(got)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    full = get_config(ARCH)
    meta = bb.LM(full, device="meta", dtype=torch.bfloat16)
    shapes = leaf_shapes(params_to_jax(meta.named_parameters(), full))
    jshapes = {"/".join(k.key for k in path): tuple(leaf.shape)
               for path, leaf in jax.tree_util.tree_flatten_with_path(
                   jax.eval_shape(lambda: jbb.init_lm(jax.random.PRNGKey(0),
                                                      jax_config(ARCH))))[0]}
    assert shapes == jshapes
    assert shapes["blocks/mamba/ssd/wx"][:2] == (13, 6)
    assert shapes["tail_blocks/norm/scale"] == (3, 3584)


def test_train_main_on_cpu_logs_finite_metrics(tmp_path):
    lm = train.main(["--device", "cpu", "--arch", ARCH, "--steps", "2",
                     "--batch", "4", "--horizon", "8", "--log-dir",
                     str(tmp_path)])
    rows = [json.loads(ln) for ln in
            (tmp_path / "progress.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in rows)
    assert all(torch.isfinite(p).all() for p in lm.parameters())


@pytest.mark.parametrize("layers,layout", [(3, (2, 1)), (1, (0, 1))])
def test_train_main_layers_cuts_the_depth(layers, layout, tmp_path):
    """``--layers 3`` trains the smoke hybrid's first 3 layers: one
    superblock of 2 Mamba-2 layers and the shared block, then 1 tail
    layer; ``--layers 1`` one tail layer and no superblock, where the
    shared block, which the loss no longer reaches, gets zero gradients
    (JAX's grad) and Adam leaves it as it was."""
    argv = ["--device", "cpu", "--arch", ARCH, "--layers", str(layers),
            "--steps", "1", "--batch", "2", "--horizon", "4"]
    lm = train.main(argv + ["--log-dir", str(tmp_path)])
    assert (len(lm.layers), len(lm.tail_blocks)) == layout
    rows = [json.loads(ln) for ln in
            (tmp_path / "progress.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1]
    assert np.isfinite(rows[0]["loss"])
    if not layout[0]:
        cfg = dataclasses.replace(get_smoke_config(ARCH), n_layers=layers)
        init = bb.init_lm(cfg, device="cpu", dtype=torch.float32,
                          generator=torch.Generator().manual_seed(0))
        for a, b in zip(lm.shared_attn.parameters(),
                        init.shared_attn.parameters()):
            assert torch.equal(a, b)
