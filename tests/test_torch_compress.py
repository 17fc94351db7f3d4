"""int8 error-feedback gradient compression of the PyTorch port
(``repro_torch/train/compress.py``) against the JAX package, on the CPU.

The same seeded numpy inputs go through ``ef_quantize``,
``ef_dequantize``, ``init_ef`` and ``wire_bytes`` of both packages; the
collective ``cross_pod_allreduce`` (and ``cross_replica`` over it) is held
against JAX under ``vmap(axis_name=...)`` on gloo ranks in
tests/test_torch_mesh.py.

Tolerances: bit for bit.  Both sides compute in f32 with the same
operations (add, |.|, max, divide, round half to even, clip, multiply),
each correctly rounded in IEEE arithmetic on the CPU, so q, scale and the
residual agree exactly; a non-finite input poisons the scale (nan) and the
residual on both, and the int8 q of a non-finite element (an undefined
cast) is not compared.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.train import compress as jc  # noqa: E402
from repro_torch.train import compress as tc  # noqa: E402

CASES = {  # name: (shape, magnitude of x, magnitude of the residual)
    "tiny": ((64, 33), 1e-6, 1e-7),
    "unit": ((64, 33), 1.0, 0.1),
    "large": ((7, 5, 3), 1e4, 1e3),
    "no_residual": ((129,), 3.0, 0.0),
    "scalar": ((), 2.5, 0.25),
}


def _inputs(name, seed=0):
    shape, mag, rmag = CASES[name]
    rng = np.random.default_rng(seed)
    x = np.asarray(rng.standard_normal(shape) * mag, np.float32)
    r = np.asarray(rng.standard_normal(shape) * rmag, np.float32)
    return x, r


@pytest.mark.parametrize("name", sorted(CASES))
def test_ef_quantize_matches_jax(name):
    """q, scale and the new residual bit for bit; the roundtrip bound
    |(x + r) - q scale| <= scale holds."""
    x, r = _inputs(name)
    jq, js, jr = jc.ef_quantize(jnp.asarray(x), jnp.asarray(r))
    tq, ts, tr = tc.ef_quantize(torch.from_numpy(x), torch.from_numpy(r))
    assert tq.dtype == torch.int8 and tq.shape == tuple(x.shape)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    deq = tc.ef_dequantize(tq, ts)
    np.testing.assert_array_equal(deq.numpy(),
                                  np.asarray(jc.ef_dequantize(jq, js)))
    assert np.abs((x + r) - deq.numpy()).max() <= float(ts) * (1 + 1e-6)


def test_residual_telescoping_identity():
    """Over 8 steps the dequantized stream sums to the true stream minus
    the final residual (the EF guarantee), and every step's residual equals
    JAX's bit for bit."""
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((17, 5)).astype(np.float32) for _ in range(8)]
    tr, jr = torch.zeros(17, 5), jnp.zeros((17, 5), jnp.float32)
    deq_sum = torch.zeros(17, 5)
    for x in xs:
        q, s, tr = tc.ef_quantize(torch.from_numpy(x), tr)
        _, _, jr = jc.ef_quantize(jnp.asarray(x), jr)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        deq_sum = deq_sum + tc.ef_dequantize(q, s)
    np.testing.assert_allclose((deq_sum + tr).numpy(), sum(xs), rtol=1e-4,
                               atol=1e-5)


def test_zero_input_stays_zero():
    q, scale, r = tc.ef_quantize(torch.zeros(8, 8), torch.zeros(8, 8))
    assert torch.all(q == 0) and torch.isfinite(scale)
    assert float(scale) == float(jc.ef_quantize(jnp.zeros((8, 8)),
                                                jnp.zeros((8, 8)))[1])
    assert torch.all(r == 0)


@pytest.mark.parametrize("bad", [np.inf, -np.inf, np.nan])
def test_nonfinite_input_poisons_scale(bad):
    """A non-finite element poisons the scale (nan), so the dequantized
    grads and the carried residual go nan, as JAX's."""
    x, r = _inputs("unit")
    x[3, 4] = bad
    _, js, jr = jc.ef_quantize(jnp.asarray(x), jnp.asarray(r))
    tq, ts, tr = tc.ef_quantize(torch.from_numpy(x), torch.from_numpy(r))
    assert np.isnan(float(ts)) and np.isnan(float(js))
    assert torch.isnan(tc.ef_dequantize(tq, ts)).all()
    np.testing.assert_array_equal(np.isnan(tr.numpy()),
                                  np.isnan(np.asarray(jr)))
    assert np.isnan(tr.numpy()).all()


def test_init_ef_and_wire_bytes_match_jax():
    """init_ef: f32 zeros shaped like each grad leaf; wire_bytes: the f32
    vs int8 payload accounting, key for key."""
    rng = np.random.default_rng(2)
    grads = {"b": rng.standard_normal(4).astype(np.float16),
             "w": rng.standard_normal((3, 4)).astype(np.float32),
             "z": [np.zeros((2, 2, 2), np.float32)]}
    jt = {k: (jnp.asarray(v) if k != "z" else [jnp.asarray(v[0])])
          for k, v in grads.items()}
    tt = {k: (torch.from_numpy(v) if k != "z" else
              [torch.from_numpy(v[0])]) for k, v in grads.items()}
    jef, tef = jc.init_ef(jt), tc.init_ef(tt)
    for k in ("b", "w"):
        assert tef.residual[k].dtype == torch.float32
        np.testing.assert_array_equal(tef.residual[k].numpy(),
                                      np.asarray(jef.residual[k]))
    assert tef.residual["z"][0].shape == (2, 2, 2)
    assert tc.wire_bytes(tt) == jc.wire_bytes(jt)
    assert tc.wire_bytes(tt)["int8_bytes"] == 4 + 12 + 8 + 3 * 4
