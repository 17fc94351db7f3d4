"""The hand-written CUDA kernels (flash attention, SSD scan) against their
plain PyTorch versions, on the card.  Needs an NVIDIA GPU with the CUDA toolkit (sm_90a);
every test here skips on a machine without CUDA.  Imports no JAX, so the
file runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Tolerance, |kernel - plain| <= atol + rtol |plain| (those of chip_smoke.py):
decode keeps P in f32 like the plain version, so the outputs differ by at
most one bf16 rounding (atol 1e-3, rtol 8e-3); prefill also rounds P to bf16
for the P.V product (atol 8e-3, rtol 1.6e-2).  The library is built for the
ported configs' shapes only: prefill at d_head 16, 64, 96, 112, 128 and
256, decode at the (d_head, query heads a KV head) pairs of ``DECODE_INSTANCES``; each
instance beside gemma2-2b's (256, 2) is held at ragged T, a window of 16
keys (smoke mixtral's, under one 64-key tile), the softcap, a query offset
and no causal mask, and for decode at kv_len on every boundary of the split
plan +-1, kv_len 1, B 1 and B 8.  Cases with q scaled by 20 push the scores
into the softcap.
Prefill covers ragged and whole 128-row query tiles and window edges inside
a tile; decode covers kv_len on every boundary of the wrapper's split plan
+-1, kv_len 1 (every split but the first empty), B 1 and B 8, and S 8192.

Training: at the gemma2-2b training shape (B 8, T 256, H 8, Hkv 4, causal,
window 4096 and none, softcap 50) the ``autograd.Function``'s backward on
the kernel route equals autograd through ``attention_reference`` bit for
bit (the same math on the same saved inputs).  A 2-layer cut of gemma2-2b
at full width (d_model 2304, vocab 256 000, f32 master weights, bf16
compute, remat) runs ``forward_train`` and its backward on the kernel route
against ``attention=ref``: 4 kernel launches (2 forward, 2 recomputed) and
none on ref, and the hidden states within 2e-2, the loss within 1e-2 and
every parameter's gradient within 5e-2 of the ref route's, each relative
in L2 norm (the routes round attention to bf16 at other places: a few bf16
spacings, 2^-8 each, per element before two layers amplify them).

The SSD scan (``csrc/ssd_scan.cu``) is held against ``ssd_reference`` at
the mamba2-1.3b training shape (B 8, T 512, H 64, P 64, G 1, N 128, chunk
256), one chunk (T 256), ragged T 500 and T < 256, and at the edges of its
tiles (T 1, 63, 64, 65, 255, 257 and 1024 = four chunks; B 1; G 2 at H
64), with the error model of chip_smoke.py: |y - ref| <= 2^-7 |ref| + eps
y_abs and |S - ref| <= eps S_abs, eps = 2^-14 + 2^-19 max|cum| (y_abs,
S_abs: the scan of |x|, |B|, |C|).  It is built for (P, N, chunk) (64, 128,
256), (64, 64, 256) -- zamba2-7b's, held at its training shape (B 8, T 256,
H 112) and the same edges -- and (16, 16, 8), the smoke configs' (B 16,
T 32, H 8; ragged T, one short chunk), with any number of groups that
divides the heads.

The sum-tree sampler (``csrc/sum_tree.cu``) is held against its plain
version and the f64 flat oracle on sum trees at the rainbow example's shape
(8192 leaves, batch 64), the replay bench's (2^14, 2^17 and 2^20 leaves,
256 samples) and at the edges of its layout: one block (512 leaves), 2048
and 8192 blocks, batches 1, 5 and 33 (not a multiple of the four samples a
block), and through ``sample_blocked`` directly block sizes 1, 16, 100 and
256 and a leaves view 4 bytes off 16-byte alignment (the scalar-load path):
exactly on integer priorities (u on boundaries, below 0, at and beyond the
total, over runs of zero leaves and a zero block), kernel == plain bit for
bit there, and by the rounding rule of ``kernels/sum_tree/ref.agreement``
on real ones.
"""
import dataclasses

import pytest

pytestmark = pytest.mark.cuda

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    DECODE_INSTANCES, decode_split_plan)
from repro_torch.kernels.flash_attention.ref import attention_reference  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_reference  # noqa: E402
from repro_torch.kernels.sum_tree import ops as st_ops  # noqa: E402
from repro_torch.kernels.sum_tree import ref as st_ref  # noqa: E402
from repro_torch.kernels.sum_tree.sum_tree import (sample_blocked,  # noqa: E402
                                                   sample_plain)
from repro_torch.models import backbones as bb  # noqa: E402

FWD_TOL = dict(atol=8e-3, rtol=1.6e-2)
DECODE_TOL = dict(atol=1e-3, rtol=8e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _qkv(B, T, S, H, Hkv, dh, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g).to(device, torch.bfloat16)  # noqa: E731
    return mk(B, T, H, dh), mk(B, S, Hkv, dh), mk(B, S, Hkv, dh)


FWD_CASES = [
    # B, T, S, H, Hkv, causal, window, softcap, q_offset, q scale
    (2, 128, 128, 4, 2, True, None, None, 0, 1.0),
    (1, 256, 256, 8, 8, True, None, None, 0, 1.0),
    (2, 100, 100, 4, 1, True, None, None, 0, 1.0),
    (1, 128, 128, 4, 2, True, 64, None, 0, 1.0),
    (1, 128, 128, 4, 2, True, None, 50.0, 0, 20.0),
    (2, 64, 256, 4, 4, True, None, None, 192, 1.0),
    (1, 128, 96, 4, 2, False, None, None, 0, 1.0),
    (2, 1000, 1000, 8, 4, True, 256, 50.0, 0, 1.0),
    (1, 77, 77, 8, 4, True, 16, 50.0, 0, 20.0),
    (1, 8, 8, 8, 4, True, 4096, 50.0, 0, 1.0),
    # ragged and whole 128-row query tiles
    (1, 127, 127, 8, 4, True, None, 50.0, 0, 1.0),
    (1, 128, 128, 8, 4, True, 4096, 50.0, 0, 1.0),
    (2, 129, 129, 8, 4, True, 64, 50.0, 0, 1.0),
    (1, 200, 200, 8, 4, False, None, 50.0, 0, 1.0),
    # the fixed rounds' prefill: local (window 4096) and global layers
    (8, 1024, 1024, 8, 4, True, 4096, 50.0, 0, 1.0),
    (8, 1024, 1024, 8, 4, True, None, 50.0, 0, 1.0),
    # the gemma2 training forward (batch 8, horizon 256)
    (8, 256, 256, 8, 4, True, 4096, 50.0, 0, 1.0),
    (8, 256, 256, 8, 4, True, None, 50.0, 0, 1.0),
    # a window edge that crosses a 64-key tile inside a 128-row query tile
    (1, 256, 256, 8, 4, True, 100, 50.0, 0, 1.0),
    (1, 200, 328, 8, 4, True, 96, 50.0, 128, 20.0),
]


@pytest.mark.parametrize("case", FWD_CASES)
def test_flash_attn_fwd_vs_reference(case, cuda):
    B, T, S, H, Hkv, causal, window, softcap, qoff, scale = case
    q, k, v = _qkv(B, T, S, H, Hkv, 256, cuda)
    q = q * scale
    n0 = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap, q_offset=qoff)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == n0 + 1
    ref = attention_reference(q, k, v, causal=causal, window=window,
                              softcap=softcap, q_offset=qoff)
    torch.testing.assert_close(out.float(), ref.float(), **FWD_TOL)


# every prefill head dim beside gemma2-2b's: B, T, S, H, Hkv, causal,
# window, softcap, q_offset, q scale
INSTANCE_FWD_CASES = [
    (2, 100, 100, 4, 1, True, None, None, 0, 1.0),
    (1, 77, 77, 4, 2, True, 16, None, 0, 1.0),
    (2, 129, 129, 8, 2, True, 16, 50.0, 0, 20.0),
    (1, 200, 328, 4, 4, True, 96, None, 128, 1.0),
    (1, 128, 96, 4, 2, False, None, None, 0, 1.0),
    (2, 256, 256, 48, 1, True, None, None, 0, 1.0),
]


@pytest.mark.parametrize("dh", [16, 64, 96, 112, 128])
@pytest.mark.parametrize("case", INSTANCE_FWD_CASES)
def test_flash_attn_fwd_instances_vs_reference(dh, case, cuda):
    B, T, S, H, Hkv, causal, window, softcap, qoff, scale = case
    q, k, v = _qkv(B, T, S, H, Hkv, dh, cuda, seed=3)
    q = q * scale
    n0 = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap, q_offset=qoff)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == n0 + 1
    ref = attention_reference(q, k, v, causal=causal, window=window,
                              softcap=softcap, q_offset=qoff)
    torch.testing.assert_close(out.float(), ref.float(), **FWD_TOL)


def _instance_decode_cases():
    out = []
    for dh, G in sorted(DECODE_INSTANCES - {(256, 2)}):
        Hkv = 1 if G == 48 else 2
        out += [(dh, G, Hkv, 97, [1, 9, 64, 96, 97, 40], 1.0, None),
                (dh, G, Hkv, 97, [33], 20.0, 50.0),
                (dh, G, Hkv, 1089, [1] * 8, 1.0, None)]
        n_split, chunk = decode_split_plan(8, Hkv, 1089)
        vals = sorted({1, 1089} | {i * chunk + d for i in range(1, n_split)
                                   for d in (-1, 0, 1)})
        out += [(dh, G, Hkv, 1089, (vals[i:i + 8] + [1] * 8)[:8], 1.0, None)
                for i in range(0, len(vals), 8)]
    return out


@pytest.mark.parametrize("dh,G,Hkv,S,kvl,scale,softcap",
                         _instance_decode_cases())
def test_flash_attn_decode_instances_vs_reference(dh, G, Hkv, S, kvl, scale,
                                                  softcap, cuda):
    B = len(kvl)
    q, k, v = _qkv(B, 1, S, G * Hkv, Hkv, dh, cuda, seed=4)
    q = q * scale
    kv_len = torch.tensor(kvl, dtype=torch.int32, device=cuda)
    n0 = ops.flash_attention_decode.launches
    out = ops.flash_attention_decode(q, k, v, kv_len, softcap=softcap)
    torch.cuda.synchronize()
    assert ops.flash_attention_decode.launches == n0 + 1
    ref = attention_reference(q, k, v, causal=False, softcap=softcap,
                              kv_len=kv_len)
    torch.testing.assert_close(out.float(), ref.float(), **DECODE_TOL)


@pytest.mark.parametrize("window", [4096, None])
def test_flash_attention_backward_bit_exact_at_training_shape(window, cuda):
    q, k, v = _qkv(8, 256, 256, 8, 4, 256, cuda, seed=5)
    g = _qkv(8, 256, 256, 8, 4, 256, cuda, seed=6)[0]
    kw = dict(causal=True, window=window, softcap=50.0)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n0 = ops.flash_attention.launches
    got = torch.autograd.grad(ops.flash_attention(*leaves, **kw), leaves, g)
    assert ops.flash_attention.launches == n0 + 1
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_reference(*ref_leaves, **kw),
                               ref_leaves, g)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def test_dense_forward_train_kernel_vs_ref_two_layers_full_width(cuda):
    cfg = dataclasses.replace(get_config("gemma2-2b"), n_layers=2)
    assert cfg.remat
    lm = bb.init_lm(cfg, device=cuda, dtype=torch.float32, requires_grad=True,
                    generator=torch.Generator(device=cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 257), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    params = list(lm.parameters())
    out = {}
    for spec in ("attention=cuda", "attention=ref"):
        n0 = ops.flash_attention.launches
        with registry.override(spec):
            hidden, _ = bb.forward_train(lm, toks[:, :-1], cfg)
            logp = torch.log_softmax(bb.lm_logits(lm, hidden, cfg).float(), -1)
            loss = (-torch.gather(logp, -1, toks[:, 1:, None].long()).mean()
                    + bb.value_out(lm, hidden).square().mean())
            grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        out[spec] = (hidden.detach(), loss.detach(), grads,
                     ops.flash_attention.launches - n0)
        del logp
    (hk, lk, gk, nk), (hr, lr, gr, nr) = out.values()
    assert (nk, nr) == (2 * cfg.n_layers, 0)
    assert torch.isfinite(hk).all() and torch.isfinite(lk)
    assert _rel(hk, hr) <= 2e-2
    assert abs(float(lk - lr)) <= 1e-2 * abs(float(lr))
    for (name, _), a, b in zip(lm.named_parameters(), gk, gr):
        assert torch.isfinite(a).all(), name
        assert _rel(a, b) <= 5e-2, name


def _split_boundary_cases(B, S, Hkv=4):
    """kv_len at every boundary of the wrapper's split plan, +-1, and at 1
    and S, B at a time (a short last batch is padded with kv_len 1)."""
    n_split, chunk = decode_split_plan(B, Hkv, S)
    vals = sorted({1, S} | {i * chunk + d for i in range(1, n_split)
                            for d in (-1, 0, 1)})
    return [(S, (vals[i:i + B] + [1] * B)[:B], 1.0)
            for i in range(0, len(vals), B)]


@pytest.mark.parametrize("S,kvl,scale", [
    (2048, [1, 37, 1089, 2048, 5, 2000], 1.0),
    (2048, [1, 37, 1089, 2048, 5, 2000], 20.0),
    (97, [1, 9, 64, 96, 97, 40], 1.0),
    (97, [33], 20.0),
    # kv_len 1: every split but the first is empty
    (1089, [1] * 8, 1.0),
    (97, [1], 1.0),
    (8192, [1, 4095, 8192, 1024, 1025, 7168, 7169, 3000], 1.0),
    (8192, [8192], 20.0),
    *_split_boundary_cases(8, 1089),
    *_split_boundary_cases(8, 97),
    *_split_boundary_cases(1, 97),
    *_split_boundary_cases(8, 8192),
])
def test_flash_attn_decode_vs_reference(S, kvl, scale, cuda):
    B, Hkv = len(kvl), 4
    q, k, v = _qkv(B, 1, S, 2 * Hkv, Hkv, 256, cuda, seed=1)
    q = q * scale
    kv_len = torch.tensor(kvl, dtype=torch.int32, device=cuda)
    n0 = ops.flash_attention_decode.launches
    out = ops.flash_attention_decode(q, k, v, kv_len, softcap=50.0)
    torch.cuda.synchronize()
    assert ops.flash_attention_decode.launches == n0 + 1
    ref = attention_reference(q, k, v, causal=False, softcap=50.0,
                              kv_len=kv_len)
    torch.testing.assert_close(out.float(), ref.float(), **DECODE_TOL)


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv(1, 8, 8, 4, 2, 256, cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        ops.flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                            v[..., :32].contiguous())
    with pytest.raises(ValueError, match="query heads per KV head"):
        ops.flash_attention_decode(q[:, :1, :, :96].contiguous(),
                                   k[:, :, :1, :96].contiguous(),
                                   v[:, :, :1, :96].contiguous(),
                                   torch.full((1,), 8, device=cuda))
    with pytest.raises(ValueError, match="one query token"):
        ops.flash_attention_decode(q, k, v, torch.full((1,), 8, device=cuda))
    with pytest.raises(ValueError, match="query heads per KV head"):
        ops.flash_attention_decode(q[:, :1], k[:, :, :1].contiguous(),
                                   v[:, :, :1].contiguous(),
                                   torch.full((1,), 8, device=cuda))


def _ssd_inputs(B, T, device, dt_scale=1.0, H=64, G=1, seed=2, P=64, N=128):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(B, T, H, P, generator=g).to(device, torch.bfloat16)
    dt = torch.nn.functional.softplus(torch.randn(B, T, H, generator=g))
    A = -torch.linspace(1.0, 16.0, H)
    Bm = (torch.randn(B, T, G, N, generator=g) * 0.5).to(device, torch.bfloat16)
    Cm = (torch.randn(B, T, G, N, generator=g) * 0.5).to(device, torch.bfloat16)
    return x, (dt * dt_scale).to(device), A.to(device), Bm, Cm


def _check_ssd_scan(B, T, dt_scale, G, device, H=64, P=64, N=128, Q=256):
    x, dt, A, Bm, Cm = _ssd_inputs(B, T, device, dt_scale, H=H, G=G, P=P,
                                   N=N)
    chunk = min(Q, T)
    n0 = ssd_ops.ssd_scan.launches
    y, s = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_scan.launches == n0 + 1
    yr, sr = ssd_reference(x, dt, A, Bm, Cm, chunk=chunk)
    ya, sa = ssd_reference(x.abs(), dt, A, Bm.abs(), Cm.abs(), chunk=chunk)
    nc = -(-T // chunk)
    dA = torch.nn.functional.pad(dt * A, (0, 0, 0, nc * chunk - T))
    cmax = float(torch.cumsum(dA.reshape(B, nc, chunk, -1), 2).abs().max())
    eps = 2.0 ** -14 + 2.0 ** -19 * cmax
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    assert ((y.float() - yr.float()).abs()
            <= 2.0 ** -7 * yr.float().abs() + eps * ya.float()).all()
    assert ((s - sr).abs() <= eps * sa).all()


@pytest.mark.parametrize("B,T,dt_scale", [(8, 512, 1.0), (8, 256, 1.0),
                                          (8, 500, 1.0), (2, 100, 1.0),
                                          (4, 512, 0.01)])
def test_ssd_scan_vs_reference(B, T, dt_scale, cuda):
    _check_ssd_scan(B, T, dt_scale, 1, cuda)


# the edges of the kernel's 16-row steps, 64-row ring tiles and 256-row
# chunks; one batch row; two groups of 32 heads
@pytest.mark.parametrize("B,T,G", [(2, 1, 1), (2, 63, 1), (2, 64, 1),
                                   (2, 65, 1), (2, 255, 1), (2, 257, 1),
                                   (2, 1024, 1), (1, 512, 1), (2, 512, 2),
                                   (2, 300, 2)])
def test_ssd_scan_tile_edges_vs_reference(B, T, G, cuda):
    _check_ssd_scan(B, T, 1.0, G, cuda)


# zamba2-7b's instance (P 64, N 64, chunk 256) at its training shape (B 8,
# T 256, H 112) and at the tile edges; the smoke mamba2 / zamba2 instance
# (P 16, N 16, chunk 8, on the CUDA cores) at their training shapes (B 16,
# T 32, H 8), ragged T and one short chunk
@pytest.mark.parametrize("P,N,Q,B,T,H,G,dt_scale", [
    (64, 64, 256, 8, 256, 112, 1, 1.0), (64, 64, 256, 2, 512, 112, 1, 1.0),
    (64, 64, 256, 2, 1, 16, 1, 1.0), (64, 64, 256, 2, 65, 16, 1, 1.0),
    (64, 64, 256, 2, 300, 16, 2, 1.0), (64, 64, 256, 2, 1024, 16, 1, 0.01),
    (64, 64, 256, 1, 255, 16, 1, 10.0),
    (16, 16, 8, 16, 32, 8, 1, 1.0), (16, 16, 8, 16, 33, 8, 1, 1.0),
    (16, 16, 8, 2, 5, 8, 1, 1.0), (16, 16, 8, 2, 64, 8, 2, 0.01),
    (16, 16, 8, 2, 100, 4, 1, 10.0), (16, 16, 8, 1, 1, 8, 1, 1.0)])
def test_ssd_scan_instances_vs_reference(P, N, Q, B, T, H, G, dt_scale,
                                         cuda):
    _check_ssd_scan(B, T, dt_scale, G, cuda, H=H, P=P, N=N, Q=Q)


def test_ssd_scan_rejects_shapes_it_was_not_built_for(cuda):
    x, dt, A, Bm, Cm = _ssd_inputs(1, 256, cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        ssd_ops.ssd_scan(x.float(), dt, A, Bm, Cm, chunk=256)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_ops.ssd_scan(x.transpose(1, 2), dt, A, Bm, Cm, chunk=256)
    with pytest.raises(ValueError, match="built for head dim"):
        ssd_ops.ssd_scan(x[..., :32].contiguous(), dt, A, Bm, Cm, chunk=256)
    with pytest.raises(ValueError, match="built for head dim"):
        ssd_ops.ssd_scan(x, dt, A, Bm[..., :32].contiguous(),
                         Cm[..., :32].contiguous(), chunk=256)
    with pytest.raises(ValueError, match="built for head dim"):
        ssd_ops.ssd_scan(x[..., :16].contiguous(), dt, A,
                         Bm[..., :16].contiguous(), Cm[..., :16].contiguous(),
                         chunk=256)
    with pytest.raises(ValueError, match="built for head dim"):
        ssd_ops.ssd_scan(x, dt, A, Bm.expand(1, 256, 3, 128).contiguous(),
                         Cm.expand(1, 256, 3, 128).contiguous(), chunk=256)
    with pytest.raises(ValueError, match="chunk"):
        ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=64)
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        ssd_ops.ssd_scan(x, dt.cpu(), A, Bm, Cm, chunk=256)


def _tree(size, device, integer, seed=3):
    """A (2*size,) sum tree built by pairwise sums from its leaves, with a
    run of zero leaves and a zero block of 512 leaves."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    leaves = (torch.randint(0, 5, (size,), generator=g).float() if integer
              else torch.rand(size, generator=g) * 2 + 0.01)
    leaves[size // 3: size // 3 + 300] = 0.0
    leaves[512:1024] = 0.0
    levels = [leaves]
    while levels[-1].numel() > 1:
        levels.append(levels[-1][0::2] + levels[-1][1::2])
    tree = torch.cat([torch.zeros(1)] + levels[::-1])
    return tree.to(device)


def _positions(flat, total, batch, integer, seed=4):
    """Stratified positions over ``total``; for integer priorities a quarter
    of them on boundaries of the flat leaves, then -1, 0, the total and the
    total + 3 (as many of the four as the batch holds)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    u = (torch.arange(batch) + torch.rand(batch, generator=g)) / batch * total
    if integer:
        c = torch.cumsum(flat.double().cpu(), 0)
        u = u.floor()
        k = batch // 4
        u[:k] = c[torch.randint(0, flat.numel(), (k,), generator=g)].float()
        m = min(4, batch - k)
        u[k:k + m] = torch.tensor([-1.0, 0.0, total, total + 3.0])[:m]
    return u.float().to(flat.device)


def _hold(idx, prob, leaves, bsums, flat, u, integer):
    """The kernel's (idx, prob) and the plain version's against the f64
    oracle over the flat leaves; on integer priorities kernel == plain."""
    torch.cuda.synchronize()
    pidx, pprob = sample_plain(leaves, bsums, u)
    n_terms = st_ref.rounding_terms(*leaves.shape)
    for i, p in ((idx, prob), (pidx, pprob)):
        stats = st_ref.agreement(i, p, flat, u, n_terms=n_terms,
                                 exact=integer)
        assert st_ref.agreement_ok(stats), stats
    if integer:
        assert torch.equal(idx, pidx) and torch.equal(prob, pprob)


@pytest.mark.parametrize("size,batch", [
    (8192, 64), (2 ** 14, 256), (2 ** 17, 256), (2 ** 20, 256),
    # one block, 2048 and 8192 blocks; batches that leave a block part-empty
    (512, 5), (2 ** 20, 64), (2 ** 22, 33), (8192, 1), (8192, 33)])
@pytest.mark.parametrize("integer", [True, False])
def test_sum_tree_kernel_vs_plain_and_oracle(size, batch, integer, cuda):
    tree = _tree(size, cuda, integer)
    u = _positions(tree[size:], float(tree[1]), batch, integer)
    n0 = st_ops.tree_sample_blocked.launches
    idx, prob = st_ops.tree_sample_blocked(tree, u)
    assert st_ops.tree_sample_blocked.launches == n0 + 1
    bs = min(512, size)
    leaves = tree[size:].view(-1, bs)
    _hold(idx, prob, leaves, tree[leaves.shape[0]:2 * leaves.shape[0]],
          tree[size:], u, integer)


@pytest.mark.parametrize("n_blocks,bs,batch,offset", [
    (2048, 1, 33, 0), (16, 16, 5, 0), (16, 100, 64, 0), (3, 100, 256, 1),
    (4, 256, 1, 0), (1, 256, 33, 0), (4, 256, 64, 1), (16, 512, 64, 1),
    (8192, 16, 256, 0), (5, 132, 40, 0)])
@pytest.mark.parametrize("integer", [True, False])
def test_sum_tree_kernel_block_sizes_vs_plain_and_oracle(
        n_blocks, bs, batch, offset, integer, cuda):
    """``sample_blocked`` directly at block sizes the tree layout never
    gives (1, 16, 100, 132, 256) and on a leaves view ``offset`` floats
    into its buffer: at 4 bytes off 16-byte alignment the kernel takes its
    scalar-load path even where bs % 4 == 0."""
    g = torch.Generator(device="cpu").manual_seed(n_blocks + bs + batch)
    size = n_blocks * bs
    flat = (torch.randint(0, 5, (size,), generator=g).float() if integer
            else torch.rand(size, generator=g) * 2 + 0.01)
    flat[size // 3: size // 3 + 300] = 0.0
    if n_blocks > 2:
        flat[bs:2 * bs] = 0.0
    buf = torch.zeros(size + offset, device=cuda)
    buf[offset:] = flat.to(cuda)
    leaves = buf[offset:].view(n_blocks, bs)
    assert leaves.data_ptr() % 16 == 4 * offset
    bsums = leaves.sum(1)
    u = _positions(leaves.reshape(-1), float(bsums.double().sum()), batch,
                   integer)
    idx, prob = sample_blocked(leaves, bsums, u)
    _hold(idx, prob, leaves, bsums, leaves.reshape(-1), u, integer)


def test_sum_tree_kernel_rejects_what_it_does_not_take(cuda):
    leaves = torch.rand(4, 512, device=cuda)
    bsums, u = leaves.sum(1), torch.rand(8, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        sample_blocked(leaves.double(), bsums, u)
    with pytest.raises(ValueError, match="contiguous"):
        sample_blocked(leaves.t(), bsums, u)
    with pytest.raises(ValueError, match="block size"):
        sample_blocked(torch.rand(2, 1024, device=cuda), bsums[:2], u)
    with pytest.raises(ValueError, match="blocks outside"):
        sample_blocked(torch.rand(8193, 4, device=cuda),
                       torch.rand(8193, device=cuda), u)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sample_blocked(leaves, bsums, u.cpu())
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        st_ops.tree_sample_blocked(torch.rand(2048, device=cuda), u.cpu())
