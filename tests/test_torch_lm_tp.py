"""The LM mesh's 'model' axis, layer by layer: tensor parallelism by
``param_pspecs``' rules on gloo ranks on the CPU (``models/sharding.py``'s
execution half, ``models/layers.py``, ``models/backbones.py``).

JAX's own 2-D mesh tests fail under JAX 0.9.0 (ROADMAP Queue 3), and GSPMD's
model axis computes the unsharded function, so the port's M ranks are held
against the JAX package's UNSHARDED functions, fed the same numpy-seeded
weights (the port's ``init_lm`` from a seed, in JAX's layout, handed to
each rank through ``params_from_jax``, which keeps its blocks) and inputs,
f32 compute throughout:

- each sharded layer at M = 2 and 4, output and every gradient (of its
  input and of each of its leaves, the split-use leaves summed over the
  axis and the sharded ones gathered): attention with KV heads that divide
  (smoke gemma2 at M 2) and with replicated KV heads (smoke granite's one
  KV head; smoke gemma2's two at M 4), the MLP, the moe with shared
  experts (smoke qwen2-moe), the SSD (smoke mamba2);
- the vocab-parallel lookup and logits (smoke gemma2, softcapped): the
  embedded tokens, the logits, ``logp`` and the entropy over the whole
  vocabulary, their gradients;
- ``forward_train`` of one smoke config a family at 1 x 2 (dense gemma2,
  moe qwen2, ssm mamba2, hybrid zamba2, vlm llama-vision), the hidden
  state, aux and the gradient of a loss over logits, values and aux;
- the split-use and replicated-use lists: derived from the rules and the
  modules, they name what the layers compute; a split-use leaf left
  partial, or a replicated-use leaf summed, misses JAX's gradient.

Tolerances (f32; the ranks sum a product's blocks in another order):
outputs within 2e-5 (absolute and relative), each gradient within 1e-4 of
its leaf's largest entry (1e-3 for the hybrid, whose five layers
amplify the SSD's reordered sums: measured 6.1e-4 at M 4); a sabotaged
gradient misses by more than 1e-2 of its largest entry.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_ranks as R  # noqa: E402
import _torch_tp as TP  # noqa: E402
from _torch_parity import to_numpy, torch_cfg  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import registry as jax_registry  # noqa: E402
from repro.models import backbones as jbb  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.models import backbones as tbb  # noqa: E402
from repro_torch.models.convert import params_to_jax  # noqa: E402

OUT_TOL = 2e-5
GRAD_TOL = 1e-4
SABOTAGE_MISS = 1e-2
B, T = 2, 8


def smoke(arch, **kw):
    return dataclasses.replace(jax_smoke(arch), compute_dtype="float32",
                               **kw)


def init(jc, seed=0):
    """JAX-layout weights from the port's seeded ``init_lm`` (JAX's own
    init runs op by op here)."""
    tc = torch_cfg(jc)
    lm = tbb.init_lm(tc, device="cpu", generator=torch.Generator()
                     .manual_seed(seed), dtype=torch.float32)
    return to_numpy(params_to_jax(lm.named_parameters(), tc))


def rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def grad_close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

LAYERS = {  # case: (arch, config overrides, which, JAX params of layer 0)
    "attention_kv_split": ("gemma2-2b", {}, "attention",
                           lambda p: p["blocks"]["local"]["attn"]),
    "attention_kv_replicated": ("granite-34b", {}, "attention",
                                lambda p: p["blocks"]["attn"]),
    "mlp": ("gemma2-2b", {}, "mlp", lambda p: p["blocks"]["local"]["mlp"]),
    "moe_shared": ("qwen2-moe-a2.7b", {}, "moe",
                   lambda p: p["blocks"]["moe"]),
    "ssd": ("mamba2-1.3b", {}, "ssd", lambda p: p["blocks"]["ssd"]),
}
PREFIX = {"attention": "layers.0.attn.", "mlp": "layers.0.mlp.",
          "moe": "layers.0.moe.", "ssd": "layers.0.ssd."}


def _layer_inputs(jc, seed):
    return (rand((B, T, jc.d_model), seed),
            rand((B, T, jc.d_model), seed + 1))


def _layer_cases():
    cases, inputs = {}, {}
    for name, (arch, over, which, _) in LAYERS.items():
        jc = smoke(arch, **over)
        params = init(jc)
        x, w = _layer_inputs(jc, 5)
        inputs[name] = (jc, params)
        cases[name] = dict(kind="layer", np_params=params, cfg=torch_cfg(jc),
                           which=which, x=x, w=w)
    return cases, inputs


FAMILIES = {"dense": "gemma2-2b", "moe": "qwen2-moe-a2.7b",
            "ssm": "mamba2-1.3b", "hybrid": "zamba2-7b",
            "vlm": "llama-3.2-vision-90b"}
# the leaves moved to the wrong list in the sabotage checks: split-use
# (left partial) and replicated-use (summed) ones
SABOTAGE = {"ssm": ("layers.0.ssd.wB", "layers.0.ssd.A_log",
                    "layers.0.norm.scale"),
            "moe": ("layers.0.moe.router", "value_head"),
            "dense": ("layers.0.attn_norm.scale",)}
GRANITE_SABOTAGE = ("layers.0.attn.wk", "layers.0.mlp_norm.scale")


def _family_cfg(family):
    over = {"hybrid": {"n_layers": 5}, "vlm": {"n_layers": 4}}.get(family,
                                                                    {})
    return smoke(FAMILIES[family], **over)


@pytest.fixture(scope="module")
def tp_runs():
    """One spawn at M = 2 (every layer, the vocab case, the forward of
    each family and granite's) and one at M = 4 (every layer)."""
    cases, inputs = _layer_cases()
    jc = smoke("gemma2-2b")
    r = np.random.RandomState(7)
    vocab = dict(kind="vocab", np_params=inputs["mlp"][1], cfg=torch_cfg(jc),
                 tokens=r.randint(0, jc.vocab, (B, T)).astype(np.int32),
                 actions=r.randint(0, jc.vocab, (B, T)).astype(np.int32),
                 h=rand((B, T, jc.d_model), 8),
                 w=rand((B, T, jc.d_model), 9))
    fwd = {}
    for fam in FAMILIES:
        fjc = _family_cfg(fam)
        fwd[fam] = dict(kind="forward", np_params=init(fjc, seed=1),
                        cfg=torch_cfg(fjc),
                        tokens=r.randint(0, fjc.vocab, (B, T)).astype(
                            np.int32),
                        sabotage=SABOTAGE.get(fam, ()))
    gjc = smoke("granite-34b")
    fwd["granite"] = dict(kind="forward", np_params=inputs[
        "attention_kv_replicated"][1], cfg=torch_cfg(gjc),
        tokens=r.randint(0, gjc.vocab, (B, T)).astype(np.int32),
        sabotage=GRANITE_SABOTAGE)
    two = dict(cases, vocab=vocab, **{f"fwd_{k}": v for k, v in fwd.items()})
    out2 = R.run_ranks(TP.tp_body, 2, 2, two)
    out4 = R.run_ranks(TP.tp_body, 4, 4, cases)
    return {"inputs": inputs, "vocab": vocab, "fwd": fwd,
            2: out2, 4: out4}


def _jax_layer(name, jc, params, x, w):
    """JAX's unsharded layer: output, input gradient, leaf gradients
    (flattened to the port's names under the module's prefix)."""
    _, _, which, pick = LAYERS[name]
    p = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), pick(params))

    def f(p, x):
        if which == "attention":
            y, _ = JL.attention_train(p, x, jc, window=jc.window)
            return y, jnp.sum(y * w)
        if which == "mlp":
            y = JL.mlp(p, x)
            return y, jnp.sum(y * w)
        if which == "moe":
            y, aux = JL.moe(p, x, jc)
            return y, jnp.sum(y * w) + 3.0 * aux
        y, _ = JL.ssd_block_train(p, x, jc)
        return y, jnp.sum(y * w)

    with jax_registry.override("ref"):
        y = f(p, jnp.asarray(x))[0]
        gp, gx = jax.grad(lambda p, x: f(p, x)[1], argnums=(0, 1))(
            p, jnp.asarray(x))
    flat = {}

    def walk(t, pre):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, pre + k + ".")
            else:
                flat[pre + k] = np.asarray(v)

    walk(gp, PREFIX[which])
    return np.asarray(y), np.asarray(gx), flat


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("name", list(LAYERS))
def test_sharded_layer_matches_jax_unsharded(tp_runs, name, n_model):
    jc, params = tp_runs["inputs"][name]
    x, w = _layer_inputs(jc, 5)
    y, gx, gp = _jax_layer(name, jc, params, x, w)
    outs = tp_runs[n_model]
    for r, out in enumerate(outs):
        got = out[name]
        np.testing.assert_allclose(got["y"], y, atol=OUT_TOL, rtol=OUT_TOL)
        grad_close(got["gx"], gx, GRAD_TOL, f"{name} d/dx rank {r}")
        assert set(got["grads"]) == set(gp), (set(got["grads"]), set(gp))
        for leaf, want in gp.items():
            grad_close(got["grads"][leaf], want, GRAD_TOL,
                       f"{name} {leaf} rank {r}")
    # the model ranks' replicated results are equal bit for bit
    for out in outs[1:]:
        np.testing.assert_array_equal(out[name]["y"], outs[0][name]["y"])


def test_vocab_parallel_embed_and_logits(tp_runs):
    c = tp_runs["vocab"]
    jc, params = tp_runs["inputs"]["mlp"]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    x = jbb.embed(jp, jnp.asarray(c["tokens"]), jc)

    def loss(jp, h):
        lg = jbb.lm_logits(jp, h, jc).astype(jnp.float32)
        lp = jax.nn.log_softmax(lg, axis=-1)
        logp = jnp.take_along_axis(lp, jnp.asarray(c["actions"])[..., None],
                                   -1)[..., 0]
        ent = -jnp.sum(jnp.exp(lp) * lp, axis=-1)
        xe = jbb.embed(jp, jnp.asarray(c["tokens"]), jc)
        return (jnp.sum(xe * c["w"]) - logp.mean() - ent.mean(),
                (lg, logp, ent))

    (_, (lg, logp, ent)), (gp, gh) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(c["h"]))
    for r, out in enumerate(tp_runs[2]):
        got = out["vocab"]
        assert got["local_vocab"] == jc.padded_vocab // 2
        np.testing.assert_array_equal(got["x"], np.asarray(x))  # exact
        for k, want in (("logits", lg), ("logp", logp), ("ent", ent)):
            np.testing.assert_allclose(got[k], np.asarray(want),
                                       atol=OUT_TOL, rtol=OUT_TOL)
        grad_close(got["gh"], np.asarray(gh), GRAD_TOL, f"d/dh rank {r}")
        for leaf in ("tok_embed", "lm_head"):
            grad_close(got["grads"][leaf], np.asarray(gp[leaf]), GRAD_TOL,
                       f"{leaf} rank {r}")


# ---------------------------------------------------------------------------
# forward_train per family, and the two gradient lists
# ---------------------------------------------------------------------------

def _jax_forward(case, jc):
    jp = jax.tree_util.tree_map(jnp.asarray, case["np_params"])
    tok = jnp.asarray(case["tokens"])

    def loss(jp):
        h, aux = jbb.forward_train(jp, tok, jc)
        lg = jbb.lm_logits(jp, h, jc)
        v = jbb.value_out(jp, h)
        return (jnp.mean(lg.astype(jnp.float32)) + jnp.sum(v) * 1e-2 + aux,
                (h, aux))

    with jax_registry.override("ref"):
        (_, (h, aux)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jp)
    return np.asarray(h), float(aux), to_numpy(g)


def _port_names(tree, tc):
    from repro_torch.models.convert import params_of_jax
    names = [n for n, _ in tbb.LM(tc, device="meta", dtype=torch.float32)
             .named_parameters()]
    return dict(zip(names, params_of_jax(tree, names, tc)))


@pytest.mark.parametrize("family", list(FAMILIES) + ["granite"])
def test_forward_train_and_gradient_lists(tp_runs, family):
    """forward_train at 1 x 2 against JAX's; every gradient (split-use
    summed, sharded gathered) against JAX's; each sabotaged leaf (moved
    to the other list) misses."""
    case = tp_runs["fwd"][family]
    jc = smoke("granite-34b") if family == "granite" else \
        _family_cfg(family)
    tc = torch_cfg(jc)
    h, aux, g = _jax_forward(case, jc)
    want = _port_names(g, tc)
    tol = 1e-3 if family == "hybrid" else GRAD_TOL
    for r, out in enumerate(tp_runs[2]):
        got = out[f"fwd_{family}"]
        np.testing.assert_allclose(got["hidden"], h, atol=OUT_TOL * 10,
                                   rtol=OUT_TOL * 10)
        assert abs(got["aux"] - aux) <= 1e-5 * max(abs(aux), 1.0)
        for leaf, w in want.items():
            grad_close(got["grads"][leaf], w, tol, f"{family} {leaf} r{r}")
        for leaf, bad in got["sabotaged"].items():
            scale = max(float(np.abs(want[leaf]).max()), 1e-12)
            assert float(np.abs(bad - want[leaf]).max()) > \
                SABOTAGE_MISS * scale, (family, leaf)


def test_split_use_list_follows_the_rules(tp_runs):
    """The lists the ranks derived (``sharding.model_split``) name what
    the layers compute: SSD's replicated leaves, replicated KV weights;
    never a norm, the router, the value head or a sharded leaf."""
    split = {f: tp_runs[2][0][f"fwd_{f}"]["split_use"]
             for f in tp_runs["fwd"]}
    sharded = {f: set(tp_runs[2][0][f"fwd_{f}"]["sharded"])
               for f in tp_runs["fwd"]}
    assert set(split["ssm"]) == {
        f"layers.{i}.ssd.{n}" for i in range(2)
        for n in ("wB", "wC", "A_log", "dt_bias", "conv_w", "norm_scale")}
    assert set(split["granite"]) == {f"layers.{i}.attn.{n}" for i in range(2)
                                     for n in ("wk", "wv")}
    assert split["moe"] == [] and split["dense"] == []  # KV heads divide
    for f, names in split.items():
        assert not set(names) & sharded[f]
        assert not any(n.endswith(("norm.scale", "router", "value_head"))
                       for n in names), (f, names)
    assert {"tok_embed", "lm_head", "layers.0.moe.experts_wi"} <= \
        sharded["moe"]


# ---------------------------------------------------------------------------
# the dry run's model-axis bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_dryrun_model_axis_bytes_by_hand(kind):
    """One rank's 'model' axis wire bytes in the dry run against a hand
    count, smoke phi3-mini (dense, 2 layers, every head, the hidden width
    and the vocab split) on a (2, 4) mesh: a rank holds B / 2 rows; its
    step all-reduces (B / 2, T, D) activations in the compute dtype once
    for the lookup, once a layer's attention and MLP (g) in each forward
    (twice under remat) and once a layer's attention and MLP input (f)
    backward plus once for the logits' input, and all-gathers the logits
    (a prefill's last position only); the update all-reduces the norm's
    f32 sum of squares.  Wire bytes: 2 (M - 1) / M of an all-reduce's
    result, (M - 1) / M of a gather's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.config import ShapeCell
    cfg = get_smoke_config("phi3-mini-3.8b")
    M, B, T = 4, 16, 32
    cell = ShapeCell("hand", T, B, kind)
    r = dryrun.run_cell("phi3-mini-3.8b", cell, cfg=cfg, n_micro=2,
                        verbose=False,
                        mesh=AbstractMesh((2, M), ("data", "model")))
    es = torch.tensor([], dtype=getattr(torch, cfg.compute_dtype)
                      ).element_size()
    act = (B // 2) * T * cfg.d_model * es
    L = cfg.n_layers
    if kind == "train":
        n_act = 1 + 2 * L * (2 if cfg.remat else 1) + 2 * L + 1
        reduce = n_act * act + 4
        gather = (B // 2) * T * cfg.padded_vocab * es
    else:
        reduce = (1 + 2 * L) * act
        gather = (B // 2) * cfg.padded_vocab * es
    want = 2 * (M - 1) / M * reduce + (M - 1) / M * gather
    assert r["collectives_by_axis"]["model"] == pytest.approx(want,
                                                              rel=1e-12)
    assert r["collectives_by_kind"]["all-gather"] == pytest.approx(
        (M - 1) / M * gather, rel=1e-12)
