"""Port parity for the flash attention kernel module on the CPU.

The same numpy inputs (from a seed) go through the JAX package's
``attention_reference`` / Pallas kernel in interpret mode and through the
port's ``attention_reference`` / ``flash_attention`` /
``flash_attention_decode`` (which on CPU tensors compute the plain
version).  Tolerance 2e-5 in f32 (the JAX kernel tests' own bound; the two
frameworks sum in different orders) and 2e-2 in bf16 (outputs rounded to
bf16 on both sides).  The CUDA kernel itself is held against the plain
version on the card by tests/test_torch_kernels_cuda.py.

The backward: ``flash_attention``'s ``autograd.Function`` gives (dq, dk,
dv) within the same bounds (atol = rtol, per dtype) of ``jax.vjp`` of
JAX's ``flash_attention`` (its ``custom_vjp``, the kernel in interpret
mode forward), on causal, windowed, softcapped, GQA and offset cases in
f32 and bf16 (measured: 5e-7 relative in f32, at most one bf16 ulp in
bf16); on the CPU it saves (q, k, v) only and equals autograd through
``attention_reference`` bit for bit, as the card's check holds it.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import (  # noqa: E402
    attention_reference as jax_ref, flash_attention as jax_fa)
from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention_decode as jax_fa_decode)
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    decode_split_plan)
from repro_torch.kernels.flash_attention.ref import attention_reference  # noqa: E402
from repro_torch.telemetry import trace  # noqa: E402

# the JAX kernel tests' cases (tests/test_kernels.py ATTN_CASES)
ATTN_CASES = [
    # B, T, S, H, Hkv, dh, causal, window, softcap, q_offset
    (2, 128, 128, 4, 2, 64, True, None, None, 0),
    (1, 256, 256, 8, 8, 128, True, None, None, 0),
    (2, 100, 100, 4, 1, 32, True, None, None, 0),
    (1, 128, 128, 4, 2, 64, True, 64, None, 0),
    (1, 128, 128, 4, 2, 64, True, None, 50.0, 0),
    (2, 64, 256, 4, 4, 64, True, None, None, 192),
    (1, 128, 96, 4, 2, 64, False, None, None, 0),
    (1, 64, 64, 2, 2, 16, True, 32, 30.0, 0),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(B, T, S, H, Hkv, dh, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, T, H, dh).astype(np.float32),
            rs.randn(B, S, Hkv, dh).astype(np.float32),
            rs.randn(B, S, Hkv, dh).astype(np.float32))


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_reference_matches_jax(case, dtype):
    B, T, S, H, Hkv, dh, causal, window, softcap, qoff = case
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, T, S, H, Hkv, dh), dtype)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff)
    _close(attention_reference(tq, tk, tv, **kw), jax_ref(jq, jk, jv, **kw),
           DTYPES[dtype][2])


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_cpu_route_matches_jax_kernel(case, dtype):
    """Port op (CPU route: the plain version) == the JAX Pallas kernel run in
    interpret mode, including ragged T/S the JAX wrapper pads."""
    B, T, S, H, Hkv, dh, causal, window, softcap, qoff = case
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, T, S, H, Hkv, dh, 1), dtype)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff)
    n0 = ops.flash_attention.launches
    got = ops.flash_attention(tq, tk, tv, **kw)
    assert ops.flash_attention.launches == n0  # no kernel on the CPU
    _close(got, jax_fa(jq, jk, jv, block_q=64, block_k=64, **kw),
           DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("softcap", [None, 50.0])
def test_decode_op_ragged_kv_len_matches_jax_kernel(dtype, softcap):
    """The JAX test_decode_op_kv_len_vs_ref case: ragged (non-block-multiple)
    cache, kv_len 1 / 37 / 80."""
    B, S, H, Hkv, dh = 3, 80, 4, 2, 32
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, 1, S, H, Hkv, dh, 2), dtype)
    kvl = np.array([1, 37, 80], np.int32)
    n0 = ops.flash_attention_decode.launches
    got = ops.flash_attention_decode(tq, tk, tv, torch.from_numpy(kvl),
                                     softcap=softcap)
    assert ops.flash_attention_decode.launches == n0
    want = jax_fa_decode(jq, jk, jv, jnp.asarray(kvl), softcap=softcap,
                         block_k=32)
    _close(got, want, DTYPES[dtype][2])
    _close(attention_reference(tq, tk, tv, causal=False, softcap=softcap,
                               kv_len=torch.from_numpy(kvl)),
           jax_ref(jq, jk, jv, causal=False, softcap=softcap,
                   kv_len=jnp.asarray(kvl)), DTYPES[dtype][2])


# the instances built for zamba2-7b (dh 112, G 1), whisper-medium (dh 64,
# G 1) and llama-3.2-vision-90b (dh 128, G 8): B, T, S, H, Hkv, dh, causal,
# window, softcap, q_offset; ragged T under a 64-row block
INSTANCE_CASES = [(1, 100, 100, 4, 4, 112, True, None, None, 0),
                  (2, 96, 96, 4, 4, 64, True, None, None, 0),
                  (1, 128, 128, 16, 2, 128, True, None, None, 0)]
INSTANCE_IDS = ["dh112", "dh64", "dh128-G8"]


@pytest.mark.parametrize("case", INSTANCE_CASES, ids=INSTANCE_IDS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_new_instances_plain_version_matches_jax(case, dtype):
    """The plain version at each new instance's head dim and group size:
    prefill against JAX's reference and its Pallas kernel in interpret mode,
    then decode (ragged kv_len, a cache of T slots) against JAX's decode
    kernel in interpret mode."""
    B, T, S, H, Hkv, dh, causal, window, softcap, qoff = case
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, T, S, H, Hkv, dh, 5), dtype)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff)
    got = ops.flash_attention(tq, tk, tv, **kw)
    _close(got, jax_ref(jq, jk, jv, **kw), DTYPES[dtype][2])
    _close(got, jax_fa(jq, jk, jv, block_q=64, block_k=64, **kw),
           DTYPES[dtype][2])
    kvl = np.array([1, S - 3][:B] if B > 1 else [S - 37], np.int32)
    got = ops.flash_attention_decode(tq[:, :1], tk, tv, torch.from_numpy(kvl))
    want = jax_fa_decode(jq[:, :1], jk, jv, jnp.asarray(kvl), block_k=32)
    _close(got, want, DTYPES[dtype][2])


def _split_ranges(B, Hkv, S):
    """The cache ranges the decode kernel's splits take: split i of each
    (batch, KV head) reads [i * chunk, min((i + 1) * chunk, S)), clipped to
    kv_len on the card."""
    n_split, chunk = decode_split_plan(B, Hkv, S)
    return [(min(i * chunk, S), min((i + 1) * chunk, S))
            for i in range(n_split)]


SPLIT_SHAPES = [
    # B, Hkv, S: the main path's decode shapes, then small and large ones
    (8, 4, 1089), (8, 4, 97), (1, 4, 97), (8, 4, 2048), (8, 4, 8192),
    (3, 2, 80), (1, 4, 8), (1, 4, 17), (1, 1, 1), (64, 16, 4096),
]


@pytest.mark.parametrize("B,Hkv,S", SPLIT_SHAPES)
def test_decode_split_plan_covers_cache_once(B, Hkv, S):
    """flash_attn_decode's host-side plan: 1-8 splits (one cluster) whose
    ranges cover [0, S) exactly once, and at least two blocks an SM where
    the shape allows it."""
    n_split, chunk = decode_split_plan(B, Hkv, S)
    assert 1 <= n_split <= 8 and chunk >= 1
    covered = np.zeros(S, np.int64)
    for lo, hi in _split_ranges(B, Hkv, S):
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert B * Hkv * n_split >= min(2 * 132, B * Hkv * 8, B * Hkv * -(-S // 16))


def _split_merge_decode(q, k, v, kv_len, softcap):
    """Decode as the CUDA kernel cuts it: the plain math on each split of
    the plan (an empty split keeps m = -1e30, l = acc = 0), then the
    kernel's merge out = sum_i acc_i e^(m_i - M) / max(sum_i l_i e^(m_i - M),
    1e-30), M = max_i m_i.  f32 on torch tensors."""
    B, _, H, dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    out = torch.zeros(B, 1, H, dh)
    for b in range(B):
        n = min(S, int(kv_len[b]))
        for hk in range(Hkv):
            qh = q[b, 0, hk * G:(hk + 1) * G].float()
            ms, ls, accs = [], [], []
            for lo, hi in _split_ranges(B, Hkv, S):
                hi = min(hi, n)
                if hi <= lo:
                    ms.append(torch.full((G,), -1e30))
                    ls.append(torch.zeros(G))
                    accs.append(torch.zeros(G, dh))
                    continue
                s = qh @ k[b, lo:hi, hk].float().T / dh ** 0.5
                if softcap is not None:
                    s = torch.tanh(s / softcap) * softcap
                m = s.max(-1).values
                p = torch.exp(s - m[:, None])
                ms.append(m)
                ls.append(p.sum(-1))
                accs.append(p @ v[b, lo:hi, hk].float())
            m_all = torch.stack(ms)
            f = torch.exp(m_all - m_all.max(0).values)
            den = (torch.stack(ls) * f).sum(0)
            num = (torch.stack(accs) * f[:, :, None]).sum(0)
            out[b, 0, hk * G:(hk + 1) * G] = num / torch.clamp(den, min=1e-30)[:, None]
    return out.to(q.dtype)


SPLIT_MERGE_CASES = [
    # B, S, H, Hkv, dh, kv_len: splits of 16 (S 80, 5 splits) and 25 (S 200,
    # 8 splits) slots; kv_len 1 leaves every split but the first empty
    (3, 80, 4, 2, 32, [1, 37, 80]),
    (3, 80, 4, 2, 32, [15, 16, 17]),
    (2, 200, 2, 1, 32, [24, 25]),
    (2, 200, 2, 1, 32, [26, 200]),
    (1, 200, 4, 2, 16, [175]),
]


@pytest.mark.parametrize("case", SPLIT_MERGE_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("softcap", [None, 50.0])
def test_decode_split_merge_matches_jax_kernel(case, dtype, softcap):
    """The split-then-merge of flash_attn_decode (its plan, the plain math
    per split, its merge formula) == JAX's flash_attention_decode (the
    Pallas kernel in interpret mode), empty splits included."""
    B, S, H, Hkv, dh, kvl = case
    assert decode_split_plan(B, Hkv, S)[0] > 1
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, 1, S, H, Hkv, dh, 3), dtype)
    kvl = np.array(kvl, np.int32)
    want = jax_fa_decode(jq, jk, jv, jnp.asarray(kvl), softcap=softcap,
                         block_k=32)
    _close(_split_merge_decode(tq, tk, tv, kvl, softcap), want,
           DTYPES[dtype][2])


def test_ops_reject_mixed_devices():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="must all be on the CPU or all on CUDA"):
        ops.flash_attention(q, q.to("meta"), q)


def test_registry_spec_parsing_and_auto():
    with registry.override("cuda"):
        assert registry.backend_for("attention") == "cuda"
        assert registry.backend_for("ssd") == "cuda"
        assert registry.backend_for("sum_tree") == "cuda"
        with registry.override("attention=ref"):
            assert registry.backend_for("attention") == "ref"
            assert registry.backend_for("ssd") == "cuda"
            assert registry.backend_for("sum_tree") == "cuda"
    with registry.override("ref,attention=cuda,sum_tree=ref"):
        assert registry.backend_for("sum_tree") == "ref"
        assert registry.backend_for("attention") == "cuda"
    with registry.override("ref,sum_tree=cuda"):
        assert registry.backend_for("sum_tree") == "cuda"
        assert registry.backend_for("ssd") == "ref"
    with registry.override("auto"):
        assert registry.backend_for("attention", device="cpu") == "ref"
        assert registry.backend_for("attention", device="cuda") == "cuda"
        assert registry.backend_for("attention") == "ref"
        assert registry.describe("cuda") == {
            "attention": "cuda", "ssd": "cuda", "sum_tree": "cuda"}
    with pytest.raises(ValueError):
        registry.backend_for("conv")
    for bad in ("attention=pallas", "flashattn=ref", "interpret",
                "sum_tree=interpret", "ref,sum_tree=pallas"):
        with pytest.raises(ValueError):
            with registry.override(bad):
                pass


def test_registry_env_and_dispatch_event(monkeypatch):
    monkeypatch.setenv(registry.ENV, "ref,attention=cuda")
    tracer = trace.configure(None)
    try:
        for _ in range(3):
            assert registry.backend_for("attention", site="attention_train",
                                        device="cpu") == "cuda"
        assert registry.backend_for("ssd", device="cuda") == "ref"
        assert registry.backend_for("sum_tree", device="cuda") == "ref"
        events = [e for e in tracer.events if e["kind"] == "kernel_dispatch"]
        assert len(events) == 1  # once per (op, site, backend)
        assert events[0]["name"] == "attention@attention_train"
        assert events[0]["backend"] == "cuda"
    finally:
        trace.reset()
    with pytest.raises(ValueError):
        registry.set_env("attention=mosaic")


# B, T, S, H, Hkv, dh, causal, window, softcap, q_offset: causal, window,
# a softcap small enough to bind, GQA with four query heads a KV head and
# a window, and queries offset into a longer key range
GRAD_CASES = [
    (2, 32, 32, 4, 2, 16, True, None, None, 0),
    (1, 48, 48, 4, 2, 16, True, 16, None, 0),
    (1, 32, 32, 4, 2, 16, True, None, 2.0, 0),
    (2, 40, 40, 8, 2, 32, True, 24, 50.0, 0),
    (1, 16, 48, 4, 4, 16, True, None, None, 32),
]


def _grad_inputs(B, T, S, H, Hkv, dh, seed=4):
    rs = np.random.RandomState(seed)
    return (*_inputs(B, T, S, H, Hkv, dh, seed),
            rs.randn(B, T, H, dh).astype(np.float32))


@pytest.mark.parametrize("case", GRAD_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_grads_match_jax_vjp(case, dtype):
    """The autograd.Function's (dq, dk, dv) against jax.vjp of JAX's
    custom_vjp op; dk / dv sum over each KV head's query heads."""
    B, T, S, H, Hkv, dh, causal, window, softcap, qoff = case
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v, g = _grad_inputs(B, T, S, H, Hkv, dh)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff)
    _, vjp = jax.vjp(lambda a, b, c: jax_fa(a, b, c, block_q=16, block_k=16,
                                             interpret=True, **kw),
                     *(jnp.asarray(x, jdt) for x in (q, k, v)))
    want = vjp(jnp.asarray(g, jdt))
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, **kw)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g).to(tdt))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tdt, name
        _close(a, b, tol)


def test_flash_attention_backward_is_the_reference_vjp():
    """The Function saves (q, k, v) only, and its gradients equal autograd
    through attention_reference bit for bit (the same math on the same
    inputs); the forward counts no launch on the CPU."""
    B, T, S, H, Hkv, dh = 2, 32, 32, 4, 2, 16
    kw = dict(causal=True, window=16, softcap=5.0)
    q, k, v, g = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in _grad_inputs(B, T, S, H, Hkv, dh, seed=5))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n0 = ops.flash_attention.launches
    out = ops.flash_attention(*leaves, **kw)
    assert ops.flash_attention.launches == n0
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 3 and all(torch.equal(a, b)
                                   for a, b in zip(saved, (q, k, v)))
    got = torch.autograd.grad(out, leaves, g)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = attention_reference(*ref_leaves, **kw)
    assert torch.equal(out, ref)
    want = torch.autograd.grad(ref, ref_leaves, g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
