"""Port parity for the serving slices on the CPU.

Against JAX (weights from the JAX ``init_lm`` through ``params_from_jax``,
prompts from a numpy seed), on the smoke config of gemma2-2b and of every
attention config ported since (glm4-9b, phi3-mini-3.8b, granite-34b,
qwen2-moe-a2.7b, mixtral-8x7b: the dense and moe families, G 1 to 4, a
16-key window on mixtral that the 20-token prompts wrap):
- f32: prefill's last-position logits and the whole cache within 1e-4, then
  8 greedy decode steps with identical tokens (logits within 1e-4), with the
  JAX kernel in interpret mode vs the port's kernel route, and ref vs ref;
- bf16: prefill logits and the first decode step's logits within 4 bf16
  ulps of the largest logit.  The two frameworks round at other places: XLA
  on the CPU keeps f32 between the fused elementwise ops of a bf16 chain
  (excess precision), PyTorch rounds after each op.  Over seeds 0-3 the gap
  measured 2 to 3.5 ulps on both routes (gemma2), so 2 ulps would fail on
  rounding alone.  A moe router near a tie may then send a token to another
  expert, so for the moe configs the bound holds on the sequences whose
  routing (experts and kept choices, every layer) agrees in both packages,
  and at least one of the two does.

Within the port (the spec is tests/test_serving.py): continuous-vs-static
token identity, slot-reuse bit identity, bucketed prefill + tail == batched
prefill, the active mask freezing lengths, EOS retirement, and
``poisson_trace`` equal to JAX's for the same seed.

The ssm family (smoke mamba2): the prefill's last hidden state, its conv and
SSM states and 8 greedy decode steps against JAX's in f32 within 1e-4 (the
scan sums in another order); slot reuse bit-identical and a bucketed
``write_prefill_at`` equal to a batch prefill (logits and states within
2e-4, f32), as for gemma2; ``serve.main`` on the CPU with its default arch
(mamba2-1.3b, as JAX's).  The ``serve_decode`` twin's default argv (smoke
mixtral-8x7b) on the CPU, and the continuous service of smoke qwen2-moe cut
to one layer by ``--layers``.

The hybrid, vlm and encdec families (smoke zamba2-7b, whisper-medium,
llama-3.2-vision-90b): serve's fixed-round phases against JAX's on the same
weights and prompts (f32: prefill logits within 1e-4 of the largest, greedy
tokens identical), and ``serve.main`` on the CPU, fixed and continuous.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (j2n, jax_routing_probe, port_lm,  # noqa: E402
                           routing_agrees, t2n, torch_cfg)
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import registry as jax_registry  # noqa: E402
from repro.models import backbones as jbb  # noqa: E402
from repro.serving import poisson_trace as jax_poisson_trace  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.examples import serve_decode  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import backbones as bb  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.serving import (ContinuousBatchEngine, SlotCache,  # noqa: E402
                                 make_decode_block, poisson_trace)
from repro_torch.telemetry import trace as ttrace  # noqa: E402

ARCH = "gemma2-2b"
SSM = "mamba2-1.3b"
BACKENDS = {"kernel": ("interpret", "cuda"), "ref": ("ref", "ref")}
# the attention configs' slice cases; gemma2-2b's keep their first ids
SLICE_ARCHS = (ARCH, "glm4-9b", "phi3-mini-3.8b", "granite-34b",
               "qwen2-moe-a2.7b", "mixtral-8x7b")
SLICE_CASES = [(a, b) for a in SLICE_ARCHS for b in BACKENDS]
SLICE_IDS = [b if a == ARCH else f"{a}-{b}" for a, b in SLICE_CASES]
B, T, GEN = 2, 20, 8          # T > window 16: the local ring buffer wraps
S = T + GEN + 1
MAX_CONTEXT = 40


def _prompts(vocab, seed=0, shape=(B, T)):
    return np.random.RandomState(seed).randint(0, vocab, size=shape).astype(
        np.int32)


def _jax_serve(cfg, params, prompts, spec, steps):
    """JAX prefill + ``steps`` greedy decode steps; returns (prefill logits,
    prefill cache, per-step logits, tokens)."""
    with jax_registry.override(spec):
        @jax.jit
        def prefill(p, toks):
            cache = jbb.init_cache(cfg, B, S)
            hidden, cache = jbb.prefill(p, toks, cfg, cache)
            return jbb.lm_logits(p, hidden, cfg)[:, -1].astype(jnp.float32), cache

        @jax.jit
        def step(p, cache, tok):
            hidden, cache = jbb.decode_step(p, cache, tok, cfg)
            return jbb.lm_logits(p, hidden, cfg)[:, 0].astype(jnp.float32), cache

        logits, cache = prefill(params, jnp.asarray(prompts))
        cache0 = jax.tree_util.tree_map(np.asarray, cache)
        all_logits, toks = [np.asarray(logits)], []
        for _ in range(steps):
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            logits, cache = step(params, cache, tok)
            toks.append(np.asarray(tok))
            all_logits.append(np.asarray(logits))
    return cache0, all_logits, toks


def _port_serve(cfg, lm, prompts, spec, tokens):
    """Port prefill + teacher-forced decode of ``tokens``; returns (prefill
    cache as numpy, per-step logits, its own greedy tokens)."""
    with registry.override(spec), torch.inference_mode():
        cache = bb.init_cache(cfg, B, S, device="cpu")
        hidden, cache = bb.prefill(lm, torch.from_numpy(prompts), cfg, cache)
        logits = bb.lm_logits(lm, hidden, cfg)[:, -1].float()
        cache0 = {k: t2n(v) for k, v in cache.items()}
        all_logits, toks = [t2n(logits)], []
        for tok in tokens:
            toks.append(t2n(torch.argmax(logits, -1)).astype(np.int32))
            hidden, cache = bb.decode_step(lm, cache, torch.from_numpy(np.array(tok)),
                                           cfg)
            logits = bb.lm_logits(lm, hidden, cfg)[:, 0].float()
            all_logits.append(t2n(logits))
    return cache0, all_logits, toks


@pytest.mark.parametrize("arch,backend", SLICE_CASES, ids=SLICE_IDS)
def test_gemma2_slice_f32_matches_jax(arch, backend):
    jcfg = dataclasses.replace(jax_smoke(arch), compute_dtype="float32")
    cfg = torch_cfg(jcfg)
    params = jbb.init_lm(jax.random.PRNGKey(0), jcfg)
    lm = port_lm(params, jcfg)
    prompts = _prompts(cfg.vocab)
    jspec, tspec = BACKENDS[backend]
    jcache, jlogits, jtoks = _jax_serve(jcfg, params, prompts, jspec, GEN)
    tcache, tlogits, ttoks = _port_serve(cfg, lm, prompts, tspec, jtoks)
    assert set(tcache) == set(jcache)
    for name in jcache:
        np.testing.assert_allclose(tcache[name], j2n(jcache[name]),
                                   atol=1e-4, rtol=1e-4, err_msg=name)
    for step, (got, want) in enumerate(zip(tlogits, jlogits)):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {step}")
    np.testing.assert_array_equal(np.stack(ttoks), np.stack(jtoks))


@pytest.mark.parametrize("arch,backend", SLICE_CASES, ids=SLICE_IDS)
def test_gemma2_slice_bf16_matches_jax(arch, backend):
    jcfg = jax_smoke(arch)
    assert jcfg.compute_dtype == "bfloat16"
    cfg = torch_cfg(jcfg)
    params = jbb.init_lm(jax.random.PRNGKey(1), jcfg)
    lm = port_lm(params, jcfg, dtype=torch.bfloat16)
    prompts = _prompts(cfg.vocab, seed=1)
    jspec, tspec = BACKENDS[backend]
    with jax_routing_probe() as jroutes:
        _, jlogits, jtoks = _jax_serve(jcfg, params, prompts, jspec, 1)
    with tl.record_routing() as troutes:
        _, tlogits, _ = _port_serve(cfg, lm, prompts, tspec, jtoks)
    rows = np.ones(B, bool)
    if cfg.family == "moe":  # prefill: one call a layer, then the step's
        rows = routing_agrees(troutes, jroutes)
        assert rows.any()
    for got, want in zip(tlogits, jlogits):
        top = float(np.max(np.abs(want)))
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7)  # bf16: 8 significant bits
        assert float(np.max(np.abs(got - want)[rows])) <= 4 * ulp


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_ssm_prefill_matches_jax(backend):
    """mamba2 prefill (the cache's states passed in: the plain chunked scan
    on both sides), then 8 greedy decode steps from its cache."""
    jcfg = dataclasses.replace(jax_smoke(SSM), compute_dtype="float32")
    cfg = torch_cfg(jcfg)
    params = jbb.init_lm(jax.random.PRNGKey(2), jcfg)
    lm = port_lm(params, jcfg)
    prompts = _prompts(cfg.vocab, seed=2)
    jspec, tspec = BACKENDS[backend]
    jcache, jlogits, jtoks = _jax_serve(jcfg, params, prompts, jspec, GEN)
    tcache, tlogits, ttoks = _port_serve(cfg, lm, prompts, tspec, jtoks)
    assert set(tcache) == set(jcache) == {"lengths", "conv", "ssm"}
    for name in jcache:
        np.testing.assert_allclose(tcache[name], j2n(jcache[name]),
                                   atol=1e-4, rtol=1e-4, err_msg=name)
    for step, (got, want) in enumerate(zip(tlogits, jlogits)):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {step}")
    np.testing.assert_array_equal(np.stack(ttoks), np.stack(jtoks))
    jh, _ = jbb.prefill(params, jnp.asarray(prompts), jcfg,
                        jbb.init_cache(jcfg, B, S))
    with torch.inference_mode():
        th, _ = bb.prefill(lm, torch.from_numpy(prompts), cfg,
                           bb.init_cache(cfg, B, S, device="cpu"))
    np.testing.assert_allclose(t2n(th), j2n(jh), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------
def _lm(cfg, seed=0):
    return bb.init_lm(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(seed))


def _greedy_blocks(cfg, params, slots, active, remaining, n_blocks, block=4):
    dec = make_decode_block(cfg, block, 0.0, None)
    logits, cache = slots.logits, slots.cache
    act = torch.as_tensor(np.asarray(active, bool))
    rem = torch.as_tensor(np.asarray(remaining, np.int32))
    out = []
    for _ in range(n_blocks):
        logits, cache, act, rem, toks, _ = dec(params, logits, cache, act, rem,
                                               None)
        out.append(toks.numpy())
    slots.logits, slots.cache = logits, cache
    return np.concatenate(out, axis=0)


def _check_slot_reuse(cfg):
    params = _lm(cfg)
    rng = np.random.RandomState(1)
    p_a, p_b, p_c = (rng.randint(0, cfg.vocab, n).astype(np.int32)
                     for n in (11, 9, 13))
    slots = SlotCache(cfg, 2, MAX_CONTEXT, device="cpu", buckets=(8,))
    slots.write_prefill_at(params, 0, p_a)
    slots.write_prefill_at(params, 1, p_b)
    _greedy_blocks(cfg, params, slots, [True, True], [8, 12], n_blocks=3)
    slots.reset_slot(0)
    slots.write_prefill_at(params, 0, p_c)
    reused = _greedy_blocks(cfg, params, slots, [True, False], [12, 0], 3)
    fresh_slots = SlotCache(cfg, 2, MAX_CONTEXT, device="cpu", buckets=(8,))
    fresh_slots.write_prefill_at(params, 0, p_c)
    fresh = _greedy_blocks(cfg, params, fresh_slots, [True, False], [12, 0], 3)
    np.testing.assert_array_equal(reused[:, 0], fresh[:, 0])
    def slot0(t):
        return t2n(t[0] if t.dim() == 1 else t[:, 0])

    for name in slots.cache:  # the reused slot's whole cache, bit for bit
        np.testing.assert_array_equal(slot0(slots.cache[name]),
                                      slot0(fresh_slots.cache[name]))


def test_slot_reuse_bit_identity():
    """Retire a slot, re-prefill it: decode must equal a fresh batch that
    only ever saw the new request (ring-window + global caches)."""
    _check_slot_reuse(get_smoke_config(ARCH))


def test_mamba2_slot_reuse_bit_identity():
    """The same for the ssm cache (conv and SSM states)."""
    _check_slot_reuse(get_smoke_config(SSM))


def _check_write_prefill(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    params = _lm(cfg)
    prompt = np.random.RandomState(2).randint(0, cfg.vocab, 21).astype(np.int32)
    slots = SlotCache(cfg, 2, MAX_CONTEXT, device="cpu", buckets=(8, 16))
    slots.write_prefill_at(params, 1, prompt)  # bucket 16 + 5 tail steps
    with torch.inference_mode():
        cache = bb.init_cache(cfg, 1, MAX_CONTEXT, device="cpu")
        hidden, cache = bb.prefill(params, torch.from_numpy(prompt[None]), cfg,
                                   cache)
        ref = t2n(bb.lm_logits(params, hidden, cfg)[:, -1])[0]
    np.testing.assert_allclose(t2n(slots.logits)[1], ref, rtol=2e-4, atol=2e-4)
    for name in cache:
        if name != "lengths":
            np.testing.assert_allclose(t2n(slots.cache[name][:, 1]),
                                       t2n(cache[name][:, 0]), rtol=2e-4,
                                       atol=2e-4, err_msg=name)
    assert list(slots.lengths()) == [0, 21]


def test_write_prefill_matches_batch_prefill():
    """Bucketed single-prompt prefill + exact tail advance lands the same
    next-token logits as a full-prompt batched prefill (f32: the two paths
    only sum in different orders)."""
    _check_write_prefill(ARCH)


def test_mamba2_write_prefill_matches_batch_prefill():
    """The same for the ssm cache: the bucket's prefill scan and the tail's
    decode recurrence land the batch prefill's states."""
    _check_write_prefill(SSM)


def test_decode_step_active_mask_freezes_lengths():
    cfg = get_smoke_config(ARCH)
    params = _lm(cfg)
    with torch.inference_mode():
        cache = bb.init_cache(cfg, 2, 20, device="cpu")
        _, cache = bb.prefill(params, torch.zeros((2, 5), dtype=torch.int32),
                              cfg, cache)
        l0 = cache["lengths"].clone()
        _, cache = bb.decode_step(params, cache,
                                  torch.zeros((2,), dtype=torch.int32), cfg,
                                  active=torch.tensor([True, False]))
    np.testing.assert_array_equal(cache["lengths"].numpy(),
                                  l0.numpy() + np.array([1, 0]))


def _run_engine(engine, mode, seed=3, n=10):
    reqs = poisson_trace(seed, n, 100.0, prompt_len_range=(8, 20),
                         max_tokens_range=(4, 14), vocab=engine.cfg.vocab)
    return reqs, engine.run(reqs, mode=mode, realtime=False)


def test_engine_continuous_vs_static_token_identity():
    """Greedy tokens per request are identical under both scheduling modes,
    and every request finishes with exactly its max_tokens budget."""
    cfg = get_smoke_config(ARCH)
    engine = ContinuousBatchEngine(cfg, _lm(cfg), n_slots=3, max_context=36,
                                   device="cpu", buckets=(8, 16),
                                   decode_block=4)
    engine.warmup()
    cont, s_cont = _run_engine(engine, "continuous")
    stat, s_stat = _run_engine(engine, "static")
    assert s_cont["n_finished"] == s_stat["n_finished"] == len(cont)
    for rc, rs in zip(cont, stat):
        assert rc.n_generated == rc.max_tokens
        np.testing.assert_array_equal(rc.tokens, rs.tokens)
    assert s_cont["n_rejected"] == 0
    assert s_cont["generated_tokens"] == sum(r.max_tokens for r in cont)
    assert "recompile_events" not in s_cont
    assert s_cont["p99_latency_s"] >= s_cont["p50_latency_s"] > 0


def test_engine_eos_retires_early():
    cfg = get_smoke_config(ARCH)
    params = _lm(cfg)
    kw = dict(n_slots=2, max_context=36, device="cpu", buckets=(8,),
              decode_block=2)
    trace = dict(prompt_len_range=(8, 12), max_tokens_range=(6, 6),
                 vocab=cfg.vocab)
    engine = ContinuousBatchEngine(cfg, params, **kw)
    reqs = poisson_trace(5, 4, 100.0, **trace)
    engine.run(reqs, mode="continuous", realtime=False)
    eos = int(reqs[0].tokens[0])
    engine2 = ContinuousBatchEngine(cfg, params, eos_id=eos, **kw)
    reqs2 = poisson_trace(5, 4, 100.0, **trace)
    engine2.run(reqs2, mode="continuous", realtime=False)
    assert reqs2[0].n_generated == 1
    assert all(r.t_finished is not None and r.n_generated <= 6 for r in reqs2)


def test_engine_spans_follow_admissions_and_blocks():
    """With a tracer configured the engine records one ``engine.admit`` a
    request, whose ``slots.prefill`` and ``slots.tail`` children's tokens
    add up to its prompt, and one ``engine.block`` a block, numbered in
    order and holding its active slots (the blocks counted by a wrapper of
    ``_run_block``, as the benchmark wraps it); the tokens are those of a
    run that records nothing, which leaves no event."""
    cfg = get_smoke_config(ARCH)
    params = _lm(cfg)
    kw = dict(n_slots=3, max_context=36, device="cpu", buckets=(8, 16),
              decode_block=4)
    tracer = ttrace.reset()
    off, _ = _run_engine(ContinuousBatchEngine(cfg, params, **kw),
                         "continuous")
    assert list(tracer.events) == []
    engine = ContinuousBatchEngine(cfg, params, **kw)
    blocks = []
    run_block = engine._run_block

    def counted(*args):
        blocks.append(args)
        return run_block(*args)

    engine._run_block = counted
    tracer = ttrace.configure(None)
    try:
        on, _ = _run_engine(engine, "continuous")
    finally:
        ttrace.reset()
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    spans = [e for e in tracer.events if e["kind"] == "span"]
    admits = [e for e in spans if e["name"] == "engine.admit"]
    assert sorted(e["rid"] for e in admits) == sorted(r.rid for r in on)
    prompt = {r.rid: len(r.prompt) for r in on}
    for a in admits:
        assert a["prompt_len"] == prompt[a["rid"]]
        kids = [e for e in spans if e["parent"] == a["id"]]
        assert [e["name"] for e in kids] == ["slots.prefill", "slots.tail"]
        assert kids[0]["tokens"] in (8, 16)
        assert sum(e["tokens"] for e in kids) == a["prompt_len"]
    block = [e for e in spans if e["name"] == "engine.block"]
    assert len(block) == len(blocks) > 0
    assert [e["block"] for e in block] == list(range(1, len(blocks) + 1))
    assert [e["active"] for e in block] == [int(a.sum()) for a, _ in blocks]


def test_poisson_trace_equals_jax():
    kw = dict(prompt_len_range=(8, 64), max_tokens_range=(4, 32), vocab=256000)
    for a, b in zip(poisson_trace(7, 16, 16.0, **kw),
                    jax_poisson_trace(7, 16, 16.0, **kw)):
        assert (a.rid, a.arrival_s, a.max_tokens) == \
            (b.rid, b.arrival_s, b.max_tokens)
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_serve_main_cpu_end_to_end(tmp_path):
    """serve.main on the CPU: fixed rounds and the continuous service,
    with the serving schema landing in serve.jsonl."""
    toks = serve.main(["--device", "cpu", "--arch", ARCH, "--rounds", "1",
                       "--batch", "2", "--prompt-len", "16", "--gen", "4",
                       "--log-dir", str(tmp_path)])
    assert tuple(toks.shape) == (2, 4)
    summary = serve.main(["--device", "cpu", "--arch", ARCH, "--continuous",
                          "--requests", "4", "--rate", "1000", "--slots", "2",
                          "--prompt-len", "16", "--gen", "6", "--log-dir",
                          str(tmp_path)])
    assert summary["n_finished"] == 4 and summary["decode_tok_per_sec"] > 0
    rows = (tmp_path / "serve.jsonl").read_text().splitlines()
    assert len(rows) == 2 and "p99_latency_s" in rows[1]


def test_serve_main_cpu_default_arch_is_mamba2(tmp_path):
    """serve.main's default arch is JAX's (mamba2-1.3b): fixed rounds and
    the continuous service on the CPU, every request served."""
    assert serve.build_parser().get_default("arch") == SSM
    toks = serve.main(["--device", "cpu", "--rounds", "1", "--batch", "2",
                       "--prompt-len", "16", "--gen", "4",
                       "--log-dir", str(tmp_path)])
    assert tuple(toks.shape) == (2, 4)
    summary = serve.main(["--device", "cpu", "--continuous", "--requests", "4",
                          "--rate", "1000", "--slots", "2", "--prompt-len",
                          "16", "--gen", "6", "--log-dir", str(tmp_path)])
    assert summary["n_finished"] == 4 and summary["decode_tok_per_sec"] > 0
    rows = [json.loads(r) for r in
            (tmp_path / "serve.jsonl").read_text().splitlines()]
    assert [r["arch"] for r in rows] == [SSM, SSM]


def test_serve_decode_twin_default_argv_on_cpu(tmp_path):
    """The serve_decode twin's default argv (smoke mixtral-8x7b, batch 8,
    prompt 64, gen 32) on the CPU: one fixed round and the continuous
    service of the moe family, and ``--layers`` cuts the depth."""
    argv = serve_decode.DEFAULTS + ["--device", "cpu", "--rounds", "1",
                                    "--log-dir", str(tmp_path)]
    toks = serve_decode.main(argv)
    assert tuple(toks.shape) == (8, 32)
    summary = serve.main(["--device", "cpu", "--arch", "qwen2-moe-a2.7b",
                          "--layers", "1", "--continuous", "--requests", "4",
                          "--rate", "1000", "--slots", "2", "--prompt-len",
                          "16", "--gen", "6", "--log-dir", str(tmp_path)])
    assert summary["n_finished"] == 4 and summary["decode_tok_per_sec"] > 0
    rows = [json.loads(r) for r in
            (tmp_path / "serve.jsonl").read_text().splitlines()]
    assert [r["arch"] for r in rows] == ["mixtral-8x7b", "qwen2-moe-a2.7b"]


# ---------------------------------------------------------------------------
# the hybrid, vlm and encdec families through serve
# ---------------------------------------------------------------------------
NEW_ARCHS = ("zamba2-7b", "whisper-medium", "llama-3.2-vision-90b")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_phases_match_jax(arch):
    """serve's fixed-round phases (``make_phases``: the stub frontends'
    zero image tokens / frames, the cache sized for them) against JAX's
    ``launch/serve.py`` phases on the same weights and prompts, f32: the
    prefill's last logits within 1e-4 of the largest, the greedy tokens of
    every decode step identical."""
    from repro.launch import serve as jax_serve
    jcfg = dataclasses.replace(jax_smoke(arch), compute_dtype="float32")
    cfg = torch_cfg(jcfg)
    params = jbb.init_lm(jax.random.PRNGKey(5), jcfg)
    lm = port_lm(params, jcfg)
    prompts = _prompts(cfg.vocab, seed=5)
    jpre, jdec = jax_serve.make_phases(jcfg, B, T, GEN)
    jlogits, jcache = jpre(params, jnp.asarray(prompts))
    jtoks = np.asarray(jdec(params, jlogits, jcache, jax.random.PRNGKey(0)))
    tpre, tdec = serve.make_phases(cfg, B, T, GEN, device="cpu")
    tlogits, tcache = tpre(lm, torch.from_numpy(prompts))
    scale = float(np.abs(np.asarray(jlogits)).max())
    np.testing.assert_allclose(t2n(tlogits) / scale,
                               np.asarray(jlogits) / scale, atol=1e-4)
    np.testing.assert_array_equal(t2n(tdec(lm, tlogits, tcache, None)),
                                  jtoks)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_main_new_families_on_cpu(arch, tmp_path):
    """serve.main on the CPU for each new family's smoke config: a fixed
    round and the continuous service, every request served."""
    toks = serve.main(["--device", "cpu", "--arch", arch, "--rounds", "1",
                       "--batch", "2", "--prompt-len", "16", "--gen", "4",
                       "--log-dir", str(tmp_path)])
    assert tuple(toks.shape) == (2, 4)
    summary = serve.main(["--device", "cpu", "--arch", arch, "--continuous",
                          "--requests", "4", "--rate", "1000", "--slots", "2",
                          "--prompt-len", "16", "--gen", "6", "--log-dir",
                          str(tmp_path)])
    assert summary["n_finished"] == 4 and summary["decode_tok_per_sec"] > 0


def test_make_generate_matches_jax_greedy():
    """``launch/serve.py::make_generate`` (prefill and decode composed, the
    generator to decode only) gives JAX's greedy tokens on the same smoke
    gemma2 weights and prompts at an f32 compute dtype, and its own
    phases' tokens."""
    from repro.launch import serve as jserve
    jc = dataclasses.replace(jax_smoke("gemma2-2b"), compute_dtype="float32")
    params = jbb.init_lm(jax.random.PRNGKey(0), jc)
    lm = port_lm(params, jc)
    prompts = np.random.RandomState(6).randint(0, jc.vocab, (2, 8)).astype(
        np.int32)
    with jax_registry.override("ref"):
        want = jserve.make_generate(jc, 2, 8, 5)(
            params, jnp.asarray(prompts), jax.random.PRNGKey(1))
    tc = torch_cfg(jc)
    gen = serve.make_generate(tc, 2, 8, 5, device="cpu")
    got = gen(lm, torch.from_numpy(prompts), torch.Generator())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    prefill, decode = serve.make_phases(tc, 2, 8, 5, device="cpu")
    logits, cache = prefill(lm, torch.from_numpy(prompts))
    np.testing.assert_array_equal(
        decode(lm, logits, cache, torch.Generator()).numpy(), got.numpy())
