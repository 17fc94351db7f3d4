"""The hand-written CUDA flash attention kernel against its plain PyTorch
version, on the card.  Needs an NVIDIA GPU with the CUDA toolkit (sm_90a);
every test here skips on a machine without CUDA.  Imports no JAX, so the
file runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Tolerance, |kernel - plain| <= atol + rtol |plain| (those of chip_smoke.py):
decode keeps P in f32 like the plain version, so the outputs differ by at
most one bf16 rounding (atol 1e-3, rtol 8e-3); prefill also rounds P to bf16
for the P.V product (atol 8e-3, rtol 1.6e-2).  The library is built for the
ported config's shapes only: d_head 256, and two query heads per KV head
for decode.  Cases with q scaled by 20 push the scores into the softcap.
"""
import pytest

pytestmark = pytest.mark.cuda

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_reference  # noqa: E402

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


@pytest.mark.parametrize("S,kvl,scale", [
    (2048, [1, 37, 1089, 2048, 5, 2000], 1.0),
    (2048, [1, 37, 1089, 2048, 5, 2000], 20.0),
    (97, [1, 9, 64, 96, 97, 40], 1.0),
    (97, [33], 20.0),
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
        ops.flash_attention(q[..., :64].contiguous(), k[..., :64].contiguous(),
                            v[..., :64].contiguous())
    with pytest.raises(ValueError, match="one query token"):
        ops.flash_attention_decode(q, k, v, torch.full((1,), 8, device=cuda))
    with pytest.raises(ValueError, match="query heads per KV head"):
        ops.flash_attention_decode(q[:, :1], k[:, :, :1].contiguous(),
                                   v[:, :, :1].contiguous(),
                                   torch.full((1,), 8, device=cuda))
