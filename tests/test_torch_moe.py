"""Port parity for the moe family (qwen2-moe-a2.7b, mixtral-8x7b) on the CPU.

Against JAX, weights from the JAX initialisers carried over by
``models/convert.py``, inputs from numpy seeds, in f32:
- ``moe`` on smoke qwen2 (shared experts) and smoke mixtral: at the
  config's capacity, with drops forced by capacity factor 0.3 (the test
  asserts that some choices are dropped), under ``no_drop``, in two
  dispatch groups, and at a decode step's shape (T 1) with a capacity
  factor 0.5: the chosen experts and the kept mask exactly (the port's
  ``record_routing`` against the same routing computed in jnp), then y
  within 1e-5 and aux within 1e-6 (f32 sums in another order);
- ``top_k`` breaks ties toward the lower index, as ``jax.lax.top_k``: the
  indices equal JAX's on rows full of ties, and a router of zeros (every
  gate 1/E) sends every token to experts 0..K-1 in both packages;
- ``forward_train`` on smoke qwen2: the hidden states within 1e-5, aux (the
  sum of the layers' load-balance losses) within 1e-6, and the gradient of
  a loss over the logits, the value and aux within 1e-4 of ``jax.grad``'s,
  leaf by leaf;
- prefill + decode with ``decode_capacity_factor`` 0.5 (capacity-bounded
  decode) on smoke mixtral: logits within 1e-4 and identical greedy tokens
  (the slice tests in test_torch_serving.py cover the no-drop decode);
- ``convert.py`` both ways for every config this slice adds: the smoke
  params round-trip bit for bit, and the port's leaves at full size (built
  on the meta device) have the names and shapes of JAX's ``init_lm``
  (``jax.eval_shape``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (j2n, jax_moe_routing, port_lm, t2n,  # noqa: E402
                           to_numpy, torch_cfg)
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import backbones as jbb  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import backbones as bb  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.convert import (_flatten, params_from_jax,  # noqa: E402
                                        params_to_jax)

MOE_ARCHS = ("qwen2-moe-a2.7b", "mixtral-8x7b")
NEW_ARCHS = ("glm4-9b", "phi3-mini-3.8b", "granite-34b") + MOE_ARCHS


def _f32(arch):
    return dataclasses.replace(jax_smoke(arch), compute_dtype="float32")


def _moe_pair(jcfg, seed=0):
    """JAX ``init_moe`` params and the port's ``MoE`` holding them."""
    p = jl.init_moe(jax.random.PRNGKey(seed), jcfg)
    mod = tl.MoE(torch_cfg(jcfg), device="cpu", dtype=torch.float32)
    leaves = _flatten(to_numpy(p))
    with torch.no_grad():
        for name, t in mod.named_parameters():
            t.copy_(torch.from_numpy(np.array(leaves[name.replace(".", "/")])))
    assert {n.replace(".", "/") for n, _ in mod.named_parameters()} == \
        set(leaves)
    return p, mod


def _jax_routing(p, x, cfg, **kw):
    return tuple(np.asarray(a) for a in jax_moe_routing(p, x, cfg, **kw))


MOE_MODES = {
    "capacity": dict(B=2, T=12, kw={}),
    "drops": dict(B=2, T=12, kw={"capacity_factor": 0.3}),
    "no_drop": dict(B=2, T=12, kw={"no_drop": True}),
    "two_groups": dict(B=2, T=12, kw={"groups": 2}),
    "decode_capacity": dict(B=8, T=1, kw={"capacity_factor": 0.5}),
}


@pytest.mark.parametrize("mode", list(MOE_MODES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_matches_jax(arch, mode):
    jcfg = _f32(arch)
    cfg = torch_cfg(jcfg)
    p, mod = _moe_pair(jcfg)
    B, T, kw = MOE_MODES[mode]["B"], MOE_MODES[mode]["T"], MOE_MODES[mode]["kw"]
    x = np.random.RandomState(3).randn(B, T, cfg.d_model).astype(np.float32)
    jy, jaux = jl.moe(p, jnp.asarray(x), jcfg, **kw)
    with tl.record_routing() as calls:
        ty, taux = tl.moe(mod, torch.from_numpy(x), cfg, **kw)
    assert len(calls) == 1
    experts, kept = (t.numpy() for t in calls[0])
    want_e, want_keep = _jax_routing(p, jnp.asarray(x), jcfg, **kw)
    np.testing.assert_array_equal(experts, want_e)
    np.testing.assert_array_equal(kept, want_keep)
    if mode == "drops":
        assert not kept.all()
    if mode == "no_drop":
        assert kept.all()
    np.testing.assert_allclose(t2n(ty), j2n(jy), atol=1e-5, rtol=1e-5)
    assert abs(float(taux) - float(jaux)) <= 1e-6


def test_top_k_ties_go_to_lower_index():
    rows = np.random.RandomState(4).randint(0, 3, size=(64, 12)).astype(
        np.float32)
    vals, idx = tl.top_k(torch.from_numpy(rows), 4)
    jvals, jidx = jax.lax.top_k(jnp.asarray(rows), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    # a router of zeros: every gate is 1/E, so every token goes to 0..K-1
    jcfg = _f32("qwen2-moe-a2.7b")
    cfg = torch_cfg(jcfg)
    p, mod = _moe_pair(jcfg)
    p = {**p, "router": jnp.zeros_like(p["router"])}
    with torch.no_grad():
        mod.router.zero_()
    x = np.random.RandomState(5).randn(2, 6, cfg.d_model).astype(np.float32)
    with tl.record_routing() as calls:
        ty, _ = tl.moe(mod, torch.from_numpy(x), cfg, no_drop=True)
    want = np.broadcast_to(np.arange(cfg.top_k), (2, 6, cfg.top_k))
    np.testing.assert_array_equal(calls[0][0].numpy(), want)
    np.testing.assert_array_equal(
        _jax_routing(p, jnp.asarray(x), jcfg, no_drop=True)[0], want)
    jy, _ = jl.moe(p, jnp.asarray(x), jcfg, no_drop=True)
    np.testing.assert_allclose(t2n(ty), j2n(jy), atol=1e-5, rtol=1e-5)


def test_moe_forward_train_and_gradient_match_jax():
    jcfg = _f32("qwen2-moe-a2.7b")
    cfg = torch_cfg(jcfg)
    params = jbb.init_lm(jax.random.PRNGKey(6), jcfg)
    lm = port_lm(params, jcfg, requires_grad=True)
    rng = np.random.RandomState(6)
    toks = rng.randint(0, cfg.vocab, size=(2, 16)).astype(np.int32)
    w = rng.randn(2, 16, cfg.padded_vocab).astype(np.float32)

    def jloss(p):
        h, aux = jbb.forward_train(p, jnp.asarray(toks), jcfg)
        loss = jnp.mean(jbb.lm_logits(p, h, jcfg) * w) + \
            jnp.mean(jbb.value_out(p, h)) + aux
        return loss, (h, aux)

    (_, (jh, jaux)), jgrad = jax.value_and_grad(jloss, has_aux=True)(params)
    th, taux = bb.forward_train(lm, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(t2n(th), j2n(jh), atol=1e-5, rtol=1e-5)
    assert float(jaux) > 0 and abs(float(taux) - float(jaux)) <= 1e-6
    loss = torch.mean(bb.lm_logits(lm, th, cfg) * torch.from_numpy(w)) + \
        torch.mean(bb.value_out(lm, th)) + taux
    names = [n for n, _ in lm.named_parameters()]
    grads = torch.autograd.grad(loss, list(lm.parameters()))
    got = _flatten(params_to_jax(zip(names, grads), cfg))
    want = _flatten(to_numpy(jgrad))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_moe_capacity_bounded_decode_matches_jax():
    """Prefill, then 6 greedy decode steps with decode_capacity_factor 0.5:
    at B 4 and top-2 of 4 experts each expert takes at most one choice a
    step, so some are dropped."""
    jcfg = dataclasses.replace(_f32("mixtral-8x7b"),
                               decode_capacity_factor=0.5)
    cfg = torch_cfg(jcfg)
    params = jbb.init_lm(jax.random.PRNGKey(7), jcfg)
    lm = port_lm(params, jcfg)
    B, T, steps = 4, 20, 6
    S = T + steps + 1
    prompts = np.random.RandomState(7).randint(0, cfg.vocab, (B, T)).astype(
        np.int32)
    cache = jbb.init_cache(jcfg, B, S)
    jh, cache = jbb.prefill(params, jnp.asarray(prompts), jcfg, cache)
    jlogits = [j2n(jbb.lm_logits(params, jh, jcfg)[:, -1])]
    jtoks = []
    for _ in range(steps):
        tok = jnp.argmax(jlogits[-1], axis=-1).astype(jnp.int32)
        jh, cache = jbb.decode_step(params, cache, tok, jcfg)
        jtoks.append(np.asarray(tok))
        jlogits.append(j2n(jbb.lm_logits(params, jh, jcfg)[:, 0]))
    with torch.inference_mode():
        tcache = bb.init_cache(cfg, B, S, device="cpu")
        th, tcache = bb.prefill(lm, torch.from_numpy(prompts), cfg, tcache)
        tlogits = [t2n(bb.lm_logits(lm, th, cfg)[:, -1])]
        dropped = 0
        for tok in jtoks:
            with tl.record_routing() as calls:
                th, tcache = bb.decode_step(lm, tcache, torch.from_numpy(tok),
                                            cfg)
            dropped += sum(int((~kept).sum()) for _, kept in calls)
            tlogits.append(t2n(bb.lm_logits(lm, th, cfg)[:, 0]))
    assert dropped > 0
    for step, (got, want) in enumerate(zip(tlogits, jlogits)):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {step}")
    np.testing.assert_array_equal(
        np.stack([np.argmax(t, -1) for t in tlogits[:-1]]),
        np.stack([np.asarray(jnp.argmax(jnp.asarray(j), -1))
                  for j in jlogits[:-1]]))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_convert_round_trip_and_full_size_leaves(arch):
    jcfg = jax_smoke(arch)
    cfg = torch_cfg(jcfg)
    assert cfg == get_smoke_config(arch)
    params = to_numpy(jbb.init_lm(jax.random.PRNGKey(8), jcfg))
    lm = params_from_jax(params, cfg, device="cpu")
    back = _flatten(params_to_jax(lm.named_parameters(), cfg))
    want = _flatten(params)
    assert set(back) == set(want)
    for name in want:
        np.testing.assert_array_equal(back[name], want[name], err_msg=name)
    # the full config's leaves, without drawing them
    jfull = jax_config(arch)
    full = torch_cfg(jfull)
    assert full == get_config(arch)
    abstract = jax.eval_shape(lambda: jbb.init_lm(jax.random.PRNGKey(0), jfull))
    jshapes = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(abstract)[0]:
        jshapes["/".join(k.key for k in path)] = tuple(leaf.shape)
    meta = bb.LM(full, device="meta", dtype=torch.bfloat16)
    tree = params_to_jax(meta.named_parameters(), full)
    tshapes = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda t: isinstance(t, torch.Tensor))[0]:
        tshapes["/".join(k.key for k in path)] = tuple(leaf.shape)
    assert tshapes == jshapes
