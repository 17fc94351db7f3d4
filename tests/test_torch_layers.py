"""Port parity for models/layers.py (and models/convert.py) on the CPU.

Weights come from the JAX ``init_lm`` and reach the port through
``params_from_jax``; activations are made from a seed with numpy and fed to
both.  Everything runs in f32 with tolerance 1e-5 (the two frameworks sum
matrix products in different orders).  The kernel route is compared with
JAX's Pallas kernel in interpret mode (``registry.override("interpret")``)
and the plain route with JAX's ``ref``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import j2n, port_lm, t2n, to_numpy, torch_cfg  # noqa: E402
from repro.kernels import registry as jax_registry  # noqa: E402
from repro.models import backbones as jbb  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.config import ModelConfig as JaxConfig  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

TOL = 1e-5
# backend pairs: (JAX spec, port spec) — kernel route vs plain route
BACKENDS = {"kernel": ("interpret", "cuda"), "ref": ("ref", "ref")}

CFG = JaxConfig(name="layers-test", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_head=16, d_ff=96, vocab=64,
                window=16, alt_local_global=True, softcap_attn=50.0,
                softcap_logits=30.0, post_norm=True, attn_chunk_q=16,
                compute_dtype="float32")


@pytest.fixture(scope="module")
def model():
    params = jbb.init_lm(jax.random.PRNGKey(0), CFG)
    return params, port_lm(params, CFG)


def _sb0(tree, kind):
    """Superblock 0's ``kind`` (local/global) layer of the JAX params."""
    return jax.tree_util.tree_map(lambda a: a[0], tree["blocks"][kind])


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_rmsnorm_matches_jax(model):
    params, lm = model
    x = _x((2, 5, CFG.d_model), 0)
    scale = np.random.RandomState(1).rand(CFG.d_model).astype(np.float32) + 0.5
    lm.final_norm.scale.data.copy_(torch.from_numpy(scale))
    got = TL.rmsnorm(lm.final_norm, torch.from_numpy(x))
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    np.testing.assert_allclose(t2n(got), j2n(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope_matches_jax(theta):
    x = _x((2, 7, 3, 16), 2)
    pos = np.random.RandomState(3).randint(0, 4096, size=(2, 7))
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(t2n(got), j2n(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("window", [None, 8])
def test_attention_train_matches_jax(model, backend, window):
    """Prefill attention with softcap 50, with and without a window shorter
    than T (T=21: ragged for the kernel's tiles), and its cache K/V."""
    params, lm = model
    jspec, tspec = BACKENDS[backend]
    x = _x((2, 21, CFG.d_model), 4)
    with jax_registry.override(jspec):
        jy, (jk, jv) = JL.attention_train(_sb0(params, "local")["attn"],
                                          jnp.asarray(x), CFG, window=window)
    with registry.override(tspec):
        ty, (tk, tv) = TL.attention_train(lm.layers[0].attn,
                                          torch.from_numpy(x), torch_cfg(CFG),
                                          window=window)
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(t2n(got), j2n(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("window", [None, 16])
def test_attention_decode_matches_jax(model, backend, window):
    """One decode token against a dense cache (window None, S=24) and a ring
    buffer (window 16, S=16, lengths past the ring size), in place."""
    params, lm = model
    jspec, tspec = BACKENDS[backend]
    S = window or 24
    B = 3
    ck = _x((B, S, CFG.n_kv_heads, CFG.d_head), 5) * 0.1
    cv = _x((B, S, CFG.n_kv_heads, CFG.d_head), 6) * 0.1
    lengths = np.array([0, 7, S + 5 if window else S - 1], np.int32)
    x = _x((B, 1, CFG.d_model), 7)
    with jax_registry.override(jspec):
        jy, jk, jv = JL.attention_decode(
            _sb0(params, "global")["attn"], jnp.asarray(x), jnp.asarray(ck),
            jnp.asarray(cv), jnp.asarray(lengths), CFG, window=window)
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    with registry.override(tspec):
        ty, tk, tv = TL.attention_decode(
            lm.layers[1].attn, torch.from_numpy(x), tck, tcv,
            torch.from_numpy(lengths), torch_cfg(CFG), window=window)
    assert tk is tck and tv is tcv  # updated in place
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(t2n(got), j2n(want), atol=TOL, rtol=TOL)


def test_mlp_matches_jax(model):
    params, lm = model
    x = _x((2, 5, CFG.d_model), 8)
    got = TL.mlp(lm.layers[1].mlp, torch.from_numpy(x))
    want = JL.mlp(_sb0(params, "global")["mlp"], jnp.asarray(x))
    np.testing.assert_allclose(t2n(got), j2n(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("alt", [True, False])
def test_params_from_jax_covers_every_leaf(alt):
    """Every leaf of the dense family lands in the port, stacked superblock i
    in layer 2i (local) / 2i+1 (global), or layer i without alternation."""
    cfg = dataclasses.replace(CFG, alt_local_global=alt, n_layers=4)
    params = to_numpy(jbb.init_lm(jax.random.PRNGKey(1), cfg))
    lm = params_from_jax(params, torch_cfg(cfg), device="cpu",
                         dtype=torch.bfloat16)
    assert sum(p.numel() for p in lm.parameters()) == \
        sum(a.size for a in jax.tree_util.tree_leaves(params))
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        src = blocks[("local", "global")[i % 2]] if alt else blocks
        j = i // 2 if alt else i
        np.testing.assert_array_equal(
            t2n(lm.layers[i].attn.wq),
            src["attn"]["wq"][j].astype(jnp.bfloat16).astype(np.float32))
    assert lm.layers[0].attn.wq.dtype == torch.bfloat16
    assert lm.layers[0].attn_norm.scale.dtype == torch.float32
    np.testing.assert_array_equal(t2n(lm.value_head),
                                  params["value_head"].astype(jnp.bfloat16)
                                  .astype(np.float32))
    bad = dict(params)
    del bad["value_head"]
    with pytest.raises(ValueError, match="missing leaves"):
        params_from_jax(bad, torch_cfg(cfg), device="cpu")
