"""Port parity for the cross-attention families on the CPU: vlm
(llama-3.2-vision-90b) and encdec (whisper-medium).

Against JAX, on each smoke config (llama-vision: 2 superblocks of one self
layer and one cross layer over 8 image tokens, d_head 16, G 2; whisper: 2
encoder and 2 decoder layers over 12 frames, d_head 16, G 1), with the JAX
``init_lm`` weights carried over by ``params_from_jax`` and tokens, image
tokens and frames from a numpy seed, in an f32 compute dtype; every bound
is 1e-4 of the largest entry (f32 sums taken in other orders):

- the layers: ``attention_train`` with a cross source (K / V from it, no
  RoPE, no causal mask) and ``cross_attention_decode`` against a frozen
  source K/V;
- ``embed`` scales by sqrt(d_model) for encdec, as JAX's does (the port
  scaled only for a logit softcap before);
- ``forward_train``'s hidden states, logits and value on the kernel route
  (JAX's kernel in interpret mode against the port's ``cuda`` spec, whose
  CPU path is the plain version) and the ``ref`` route; vlm with image
  tokens and with ``img=None`` (JAX's cross layer is then non-causal
  self-attention over the text);
- ``prefill`` then three greedy ``decode_step``s: every cache leaf (self
  K/V, the cross layers' source K/V) and every step's logits; vlm also
  without image tokens (the cross K/V then come from the prompt, a leaf of
  another length, as JAX's);
- one LM-PPO update with the sources in the batch (``img_len`` /
  ``enc_len``, as JAX's ``make_lm_ppo_train_step``): metrics within 1e-4
  relative, parameters as the dense test bounds them;
- ``params_to_jax`` gives JAX's tree back exactly, and the full configs'
  leaves (on the meta device) have JAX's names and shapes;
- the launchers' quirk, kept: ``train --arch llama-3.2-vision-90b`` trains
  with no image tokens (two steps, finite), and ``train --arch
  whisper-medium`` is refused by both packages (JAX's fails in
  ``encoder_forward`` on ``enc_frames=None``; the port refuses before
  drawing a weight).
"""
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (assert_close_to_largest,  # noqa: E402
                           assert_serving_matches, assert_update_matches,
                           family_inputs, flat_tree, jax_prefill_steps,
                           leaf_shapes, port_lm, port_prefill_steps,
                           ppo_batch, t2n, to_numpy, torch_cfg)
from repro.algos.pg.ppo import make_lm_ppo_train_step as jax_ppo_step  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import registry as jax_registry  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import backbones as jbb  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch.algos.pg.ppo import make_lm_ppo_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import backbones as bb  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.convert import params_to_jax  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402

VLM, ENCDEC = "llama-3.2-vision-90b", "whisper-medium"
ARCHS = (VLM, ENCDEC)
BACKENDS = {"kernel": ("interpret", "cuda"), "ref": ("ref", "ref")}
B, T, STEPS = 2, 20, 3
S = T + STEPS + 1


def _smoke(arch, seed=0, remat=False):
    jc = dataclasses.replace(jax_smoke(arch), compute_dtype="float32",
                             remat=remat)
    return jc, torch_cfg(jc), jbb.init_lm(jax.random.PRNGKey(seed), jc)


def _tokens(vocab, shape=(B, T), seed=0):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


def test_layout_and_cache_leaves():
    assert bb.superblock_layout(get_config(VLM)) == (20, 5, 0)
    assert bb.superblock_layout(get_config(ENCDEC)) == (24, 1, 0)
    for arch in ARCHS:
        jc, tc, _ = _smoke(arch)
        assert bb.superblock_layout(tc) == jbb.superblock_layout(jc)
        for lens in ({}, {"img_len": tc.n_img_tokens, "enc_len": tc.enc_len}):
            cache = bb.init_cache(tc, B, S, device="cpu", **lens)
            want = jbb.init_cache(jc, B, S, **lens)
            assert {k: tuple(v.shape) for k, v in cache.items()} == \
                {k: tuple(v.shape) for k, v in want.items()}, (arch, lens)


def test_attention_train_with_a_cross_source_matches_jax():
    jc, tc, params = _smoke(VLM)
    p = params["blocks"]["cross"]["attn"]
    tp = port_lm(params, jc).layers[1].attn
    r = np.random.RandomState(0)
    x = r.randn(B, T, tc.d_model).astype(np.float32)
    src = r.randn(B, 8, tc.d_model).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0], p)
    for kw in ({"x_kv": src}, {"x_kv": src, "kv_positions": np.arange(8)},
               {"x_kv": None, "causal": False}):
        jy, (jk, jv) = JL.attention_train(
            jp, jnp.asarray(x), jc,
            **{k: None if v is None else jnp.asarray(v)
               if isinstance(v, np.ndarray) else v for k, v in kw.items()})
        ty, (tk, tv) = TL.attention_train(
            tp, torch.from_numpy(x), tc,
            **{k: None if v is None else torch.from_numpy(v)
               if isinstance(v, np.ndarray) else v for k, v in kw.items()})
        for name, a, b in (("y", ty, jy), ("k", tk, jk), ("v", tv, jv)):
            assert_close_to_largest(t2n(a), b, 1e-4, f"{name} {list(kw)}")


def test_cross_attention_decode_matches_jax():
    jc, tc, params = _smoke(VLM)
    jp = jax.tree_util.tree_map(lambda a: a[1], params["blocks"]["cross"][
        "attn"])
    tp = port_lm(params, jc).layers[3].attn
    r = np.random.RandomState(1)
    x = r.randn(B, 1, tc.d_model).astype(np.float32)
    ck, cv = (r.randn(B, 8, tc.n_kv_heads, tc.d_head).astype(np.float32)
              for _ in range(2))
    want = JL.cross_attention_decode(jp, jnp.asarray(x), jnp.asarray(ck),
                                     jnp.asarray(cv), jc)
    got = TL.cross_attention_decode(tp, torch.from_numpy(x),
                                    torch.from_numpy(ck),
                                    torch.from_numpy(cv), tc)
    assert_close_to_largest(t2n(got), want, 1e-4)


def test_encdec_embed_scales_by_sqrt_d_model():
    jc, tc, params = _smoke(ENCDEC)
    lm = port_lm(params, jc)
    toks = _tokens(tc.vocab)
    got = t2n(bb.embed(lm, torch.from_numpy(toks), tc))
    want = np.asarray(jbb.embed(params, jnp.asarray(toks), jc))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    raw = np.asarray(params["tok_embed"])[toks]
    np.testing.assert_allclose(got, raw * math.sqrt(tc.d_model), rtol=1e-6)


# (arch, with its image tokens / frames)
CASES = [(VLM, True), (VLM, False), (ENCDEC, True)]
CASE_IDS = ["vlm-img", "vlm-no-img", "encdec"]


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("arch,sources", CASES, ids=CASE_IDS)
def test_forward_train_matches_jax(arch, sources, backend):
    jc, tc, params = _smoke(arch, seed=1)
    lm = port_lm(params, jc)
    toks = _tokens(tc.vocab, (B, 24), seed=1)
    extras = family_inputs(tc, B, seed=2) if sources else {}
    jspec, tspec = BACKENDS[backend]
    with jax_registry.override(jspec):
        jh, _ = jax.jit(lambda p, t, ex: jbb.forward_train(p, t, jc, **ex))(
            params, jnp.asarray(toks),
            {k: jnp.asarray(v) for k, v in extras.items()})
        want = (jh, jbb.lm_logits(params, jh, jc), jbb.value_out(params, jh))
    with registry.override(tspec), torch.no_grad():
        th, aux = bb.forward_train(lm, torch.from_numpy(toks), tc,
                                   **{k: torch.from_numpy(v)
                                      for k, v in extras.items()})
        got = (th, bb.lm_logits(lm, th, tc), bb.value_out(lm, th))
    assert float(aux) == 0.0
    for name, a, b in zip(("hidden", "logits", "value"), got, want):
        assert_close_to_largest(t2n(a), b, 1e-4, name)


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("arch,sources", CASES, ids=CASE_IDS)
def test_prefill_and_decode_steps_match_jax(arch, sources, backend):
    jc, tc, params = _smoke(arch, seed=3)
    lm = port_lm(params, jc)
    prompts = _tokens(tc.vocab, seed=3)
    extras = family_inputs(tc, B, seed=4) if sources else {}
    jspec, tspec = BACKENDS[backend]
    jout = jax_prefill_steps(jc, params, prompts, extras, jspec, S, STEPS)
    tout = port_prefill_steps(tc, lm, prompts, extras, tspec, S, jout[2])
    assert {"k", "v", "cross_k", "cross_v", "lengths"} == set(tout[0][0])
    src_len = T if not sources else (tc.n_img_tokens if arch == VLM
                                     else tc.enc_len)
    assert tout[0][0]["cross_k"].shape[2] == src_len
    assert_serving_matches(jout, tout)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_ppo_train_step_with_sources_matches_jax(arch):
    """One update with the sources in the batch (JAX's img_len / enc_len
    keywords), remat on and the kernel route, as the dense test."""
    jc, tc, params = _smoke(arch, seed=5, remat=True)
    lm = port_lm(params, jc, requires_grad=True)
    batch = ppo_batch(tc.vocab)
    src = family_inputs(tc, 4, seed=6)
    kw = {}
    if arch == VLM:
        batch["img_embed"], kw["img_len"] = src["img"], tc.n_img_tokens
    else:
        batch["enc_frames"], kw["enc_len"] = src["enc_frames"], tc.enc_len
    lr = 1e-3
    jopt = joptim.adam(lr, grad_clip=1.0)
    with jax_registry.override("interpret"):
        jp, _, jm = jax.jit(jax_ppo_step(jc, jopt, entropy_coeff=0.003,
                                         **kw))(
            params, jopt.init(params),
            {k: jnp.asarray(v) for k, v in batch.items()})
    topt = toptim.adam(lr, grad_clip=1.0)
    with registry.override("cuda"):
        lm, _, tm = make_lm_ppo_train_step(tc, topt, entropy_coeff=0.003,
                                           **kw)(
            lm, topt.init(lm.parameters()),
            {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert_update_matches(lm, jp, tc, lr)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_to_jax_round_trip_and_full_size_leaves(arch):
    jc, tc, params = _smoke(arch, seed=7)
    lm = port_lm(params, jc)
    got = flat_tree(params_to_jax(lm.named_parameters(), tc))
    want = flat_tree(to_numpy(params))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    full = get_config(arch)
    meta = bb.LM(full, device="meta", dtype=torch.bfloat16)
    jshapes = {"/".join(k.key for k in path): tuple(leaf.shape)
               for path, leaf in jax.tree_util.tree_flatten_with_path(
                   jax.eval_shape(lambda: jbb.init_lm(jax.random.PRNGKey(0),
                                                      jax_config(arch))))[0]}
    assert leaf_shapes(params_to_jax(meta.named_parameters(), full)) == \
        jshapes


def test_train_main_vlm_trains_without_image_tokens(tmp_path):
    lm = train.main(["--device", "cpu", "--arch", VLM, "--steps", "2",
                     "--batch", "4", "--horizon", "8", "--log-dir",
                     str(tmp_path)])
    rows = [json.loads(ln) for ln in
            (tmp_path / "progress.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in rows)
    assert all(torch.isfinite(p).all() for p in lm.parameters())


def test_train_whisper_is_refused_by_both_packages():
    argv = ["--arch", ENCDEC, "--steps", "1", "--batch", "2", "--horizon",
            "4"]
    with pytest.raises(AttributeError, match="astype"):
        jax_train.main(argv)  # encoder_forward(params, None, cfg)
    with pytest.raises(ValueError, match="enc_frames=None"):
        train.main(argv + ["--device", "cpu"])
