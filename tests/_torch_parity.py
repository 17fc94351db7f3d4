"""Shared helpers for the JAX <-> PyTorch-port parity tests: numpy goes in,
both sides compute, numpy comes out.  Imported only by tests/test_torch_*.py
(after their ``pytest.importorskip("torch")``)."""
import dataclasses
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.config import ModelConfig as JaxConfig
from repro_torch.models.config import ModelConfig as TorchConfig
from repro_torch.models.convert import params_from_jax


def torch_cfg(jax_cfg: JaxConfig) -> TorchConfig:
    """The port's ModelConfig with every field of the JAX one."""
    return TorchConfig(**dataclasses.asdict(jax_cfg))


def to_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def port_lm(jax_params, jax_cfg: JaxConfig, dtype=torch.float32,
            requires_grad: bool = False):
    """The port's LM holding the JAX ``init_lm`` params, on the CPU."""
    return params_from_jax(to_numpy(jax_params), torch_cfg(jax_cfg),
                           device="cpu", dtype=dtype,
                           requires_grad=requires_grad)


def t2n(x) -> np.ndarray:
    return x.detach().float().cpu().numpy().copy()


def j2n(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def jax_moe_routing(p, x, cfg, groups=1, no_drop=False, capacity_factor=None):
    """The routing of JAX's ``repro.models.layers.moe`` (its first half,
    in jnp): the chosen experts and the kept mask, each (B, T, K)."""
    B, T, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    G = groups if (B * T) % groups == 0 else 1
    S_g = B * T // G
    cf = capacity_factor if capacity_factor is not None else \
        cfg.capacity_factor
    C = min(max(int(np.ceil(S_g * K / E * cf)), 1), S_g * K)
    if no_drop:
        C = S_g * K
    logits = jnp.einsum("gsd,de->gse", x.reshape(G, S_g, -1),
                        p["router"].astype(x.dtype)).astype(jnp.float32)
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    onehot = jax.nn.one_hot(top_e, E, dtype=jnp.int32)
    ordered = onehot.transpose(0, 2, 1, 3).reshape(G, K * S_g, E)
    pos = jnp.sum((jnp.cumsum(ordered, axis=1) - 1) * ordered, axis=-1)
    keep = pos.reshape(G, K, S_g).transpose(0, 2, 1) < C
    return top_e.reshape(B, T, K), keep.reshape(B, T, K)


@contextmanager
def jax_routing_probe():
    """Within the block, every call of the JAX backbones' ``moe`` (jitted or
    not) appends its (experts, kept) routing, as numpy, to the yielded list
    -- the counterpart of the port's ``layers.record_routing``."""
    from repro.models import backbones as jbb

    calls = []
    orig = jbb.moe

    def probed(params, x, cfg, groups=1, no_drop=False, capacity_factor=None):
        e, keep = jax_moe_routing(params, x, cfg, groups, no_drop,
                                  capacity_factor)
        jax.debug.callback(
            lambda a, b: calls.append((np.asarray(a), np.asarray(b))),
            e, keep)
        return orig(params, x, cfg, groups=groups, no_drop=no_drop,
                    capacity_factor=capacity_factor)

    jbb.moe = probed
    try:
        yield calls
    finally:
        jbb.moe = orig


def routing_agrees(got, want) -> np.ndarray:
    """(B,) bool: the rows whose experts and kept mask agree in every moe
    call of two routing records (``record_routing`` / ``jax_routing_probe``,
    the same calls in the same order)."""
    assert len(got) == len(want) > 0
    agree = None
    for (ge, gk), (we, wk) in zip(got, want):
        ge, gk = np.asarray(ge), np.asarray(gk)
        row = ((ge == we) & (gk == wk)).reshape(ge.shape[0], -1).all(-1)
        agree = row if agree is None else agree & row
    return agree


# ---------------------------------------------------------------------------
# the hybrid, vlm and encdec families: prefill + decode on both sides
# ---------------------------------------------------------------------------
def family_inputs(cfg, B: int, seed: int = 0):
    """The stub frontends' inputs drawn from a numpy seed, f32: image tokens
    (B, n_img_tokens, D) for vlm, encoder frames (B, enc_len, D) for
    encdec; {} for the other families."""
    r = np.random.RandomState(seed)
    kw = {}
    if cfg.family == "vlm":
        kw["img"] = (r.randn(B, cfg.n_img_tokens, cfg.d_model) * 0.5).astype(
            np.float32)
    if cfg.family == "encdec":
        kw["enc_frames"] = (r.randn(B, cfg.enc_len, cfg.d_model) * 0.5
                            ).astype(np.float32)
    return kw


def jax_prefill_steps(cfg, params, prompts, extras, spec, S, steps):
    """JAX prefill (its cache sized for the config's image tokens / encoder
    frames) then ``steps`` greedy decode steps.  Returns (caches after the
    prefill and after each step, as numpy dicts; logits of each; the greedy
    tokens fed)."""
    from repro.kernels import registry as jax_registry
    from repro.models import backbones as jbb

    B = prompts.shape[0]
    ex = {k: jnp.asarray(v) for k, v in extras.items()}
    with jax_registry.override(spec):
        @jax.jit
        def prefill(p, toks, ex):
            cache = jbb.init_cache(cfg, B, S, img_len=cfg.n_img_tokens,
                                   enc_len=cfg.enc_len)
            hidden, cache = jbb.prefill(p, toks, cfg, cache, **ex)
            return jbb.lm_logits(p, hidden, cfg)[:, -1].astype(
                jnp.float32), cache

        @jax.jit
        def step(p, cache, tok):
            hidden, cache = jbb.decode_step(p, cache, tok, cfg)
            return jbb.lm_logits(p, hidden, cfg)[:, 0].astype(
                jnp.float32), cache

        logits, cache = prefill(params, jnp.asarray(prompts), ex)
        caches = [jax.tree_util.tree_map(np.asarray, cache)]
        all_logits, toks = [np.asarray(logits)], []
        for _ in range(steps):
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            logits, cache = step(params, cache, tok)
            toks.append(np.asarray(tok))
            caches.append(jax.tree_util.tree_map(np.asarray, cache))
            all_logits.append(np.asarray(logits))
    return caches, all_logits, toks


def port_prefill_steps(cfg, lm, prompts, extras, spec, S, tokens):
    """The port's prefill then a teacher-forced decode of ``tokens``;
    returns (caches after the prefill and each step as numpy dicts, logits
    of each)."""
    from repro_torch.kernels import registry
    from repro_torch.models import backbones as bb

    B = prompts.shape[0]
    ex = {k: torch.from_numpy(v) for k, v in extras.items()}
    with registry.override(spec), torch.inference_mode():
        cache = bb.init_cache(cfg, B, S, device="cpu",
                              img_len=cfg.n_img_tokens, enc_len=cfg.enc_len)
        hidden, cache = bb.prefill(lm, torch.from_numpy(prompts), cfg, cache,
                                   **ex)
        logits = bb.lm_logits(lm, hidden, cfg)[:, -1].float()
        caches = [{k: t2n(v) for k, v in cache.items()}]
        all_logits = [t2n(logits)]
        for tok in tokens:
            hidden, cache = bb.decode_step(lm, cache,
                                           torch.from_numpy(np.array(tok)),
                                           cfg)
            logits = bb.lm_logits(lm, hidden, cfg)[:, 0].float()
            caches.append({k: t2n(v) for k, v in cache.items()})
            all_logits.append(t2n(logits))
    return caches, all_logits


def assert_close_to_largest(got, want, tol=1e-4, err_msg=""):
    """|got - want| <= tol * max|want| elementwise (f32 sums taken in other
    orders, carried through a stack of layers)."""
    want = j2n(want)
    scale = float(np.abs(want).max()) + 1e-12
    np.testing.assert_allclose(np.asarray(got, np.float32) / scale,
                               want / scale, atol=tol, err_msg=err_msg)


def assert_serving_matches(jax_out, port_out, tol=1e-4):
    """Every cache leaf after the prefill and each step, and every step's
    logits, within ``tol`` of the leaf's largest entry."""
    jcaches, jlogits, _ = jax_out
    tcaches, tlogits = port_out
    assert len(tcaches) == len(jcaches)
    for i, (tc, jc) in enumerate(zip(tcaches, jcaches)):
        assert set(tc) == set(jc), (sorted(tc), sorted(jc))
        for name in jc:
            assert tc[name].shape == jc[name].shape, name
            assert_close_to_largest(tc[name], jc[name], tol,
                                    f"{name} @ {i}")
    for i, (got, want) in enumerate(zip(tlogits, jlogits)):
        assert_close_to_largest(got, want, tol, f"logits @ {i}")


def flat_tree(tree, prefix=""):
    """A nested dict of arrays / tensors -> {"a/b/c": numpy f32}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = (t2n(v) if isinstance(v, torch.Tensor)
                                   else np.asarray(v, np.float32))
    return out


def leaf_shapes(tree, prefix=""):
    """A nested dict of arrays / tensors -> {"a/b/c": shape}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaf_shapes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tuple(v.shape)
    return out


def ppo_batch(vocab, B=4, T=16, seed=0):
    """An LM-PPO batch (batch-major) drawn from a numpy seed."""
    r = np.random.RandomState(seed)
    return {"tokens": r.randint(0, vocab, (B, T)).astype(np.int32),
            "actions": r.randint(0, vocab, (B, T)).astype(np.int32),
            "logp_old": (r.randn(B, T) * 0.1 - 5.5).astype(np.float32),
            "advantage": r.randn(B, T).astype(np.float32),
            "return_": r.randn(B, T).astype(np.float32)}


def assert_update_matches(lm, jax_params, cfg, lr):
    """The port's parameters after one Adam update against JAX's: within
    1e-5 + 2 lr everywhere (an Adam step moves a weight by about lr, and an
    element whose gradient sits near 0 may take the other sign), and
    within 1e-5 on all but 1e-3 of the elements."""
    from repro_torch.models.convert import params_of_jax

    names = [n for n, _ in lm.named_parameters()]
    want = dict(zip(names, params_of_jax(to_numpy(jax_params), names, cfg)))
    n_flip = n_all = 0
    for name, p in lm.named_parameters():
        err = np.abs(t2n(p) - want[name])
        assert err.max() <= 1e-5 + 2 * lr, name
        n_flip += int((err > 1e-5).sum())
        n_all += err.size
    assert n_flip <= 1e-3 * n_all, (n_flip, n_all)
