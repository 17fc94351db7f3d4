"""Prioritized replay of the PyTorch port against the JAX package, on the
CPU: the sum-tree kernel's plain version (``kernels/sum_tree``) against the
Pallas kernel ``sample_pallas`` run in interpret mode, the flat oracle, the
sum tree's pointer walk and descent, the blocked update, ``DeviceReplay``
(insert with ring wrap and max-priority init, prioritized and uniform
sample, priority update) and the registry's ``sum_tree`` dispatch.

Tolerances:
- indices, storage, cursor and filled: exact;
- the kernel's function on integer priorities: exact (every f32 partial
  sum is exact below 2^24, whatever the order of the sums);
- on real priorities, the rounding rule of ``ref.agreement``: an index may
  differ from the f64 oracle's only where u lies within delta = n_terms *
  2^-24 * total of every boundary between the two leaves, and prob within a
  relative (n_terms + 1) * 2^-24 of p[idx] / total;
- the pointer walk given the same priorities: bit-exact; the blocked update
  against the pointer walk: within one f32 spacing per level below the node;
- IS weights and priorities after ``update_priorities``: 2e-6 relative
  (one ``pow`` in each framework, which may round differently).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.sum_tree.ref import sample_reference as jsample_reference  # noqa: E402
from repro.kernels.sum_tree.sum_tree import sample_pallas  # noqa: E402
from repro.replay import device as jreplay  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.sum_tree import ops as tops  # noqa: E402
from repro_torch.kernels.sum_tree import ref as tref  # noqa: E402
from repro_torch.kernels.sum_tree.sum_tree import sample_plain  # noqa: E402
from repro_torch.replay import device as treplay  # noqa: E402
from repro_torch.replay.interface import DeviceReplay  # noqa: E402
from repro_torch.telemetry import trace  # noqa: E402

# (capacity, block size, batch): then the CUDA kernel's layout edges --
# block sizes 1, 16, 100, 256 and 512, 1, 16, 2048 and 8192 blocks, and
# batches 1, 5 and 33 (not a multiple of its four samples a block)
SUMTREE_CASES = [(1024, 64, 256), (4096, 512, 128), (1000, 128, 64),
                 (64, 8, 32),
                 (2048, 1, 33), (256, 16, 5), (1600, 100, 64), (512, 256, 1),
                 (512, 512, 256), (2048 * 8, 8, 64), (8192 * 16, 16, 64)]
# rlpyt's Atari replay: 2^20 leaves in 2048 blocks of 512
RLPYT_CASE = (2 ** 20, 512, 256)


def _t(x):
    return torch.tensor(np.asarray(x))


def _integer_case(cap, bs, batch, seed):
    """Integer priorities in 0..4 with a run of zero leaves and a zero block,
    and positions on boundaries, below 0, at the total and beyond it."""
    rs = np.random.RandomState(seed)
    n_blocks = -(-cap // bs)
    pr = np.zeros(n_blocks * bs, np.float32)
    pr[:cap] = rs.randint(0, 5, size=cap)
    pr[cap // 3: cap // 3 + bs // 2 + 3] = 0.0          # a run of zeros
    if n_blocks > 2:
        pr[bs:2 * bs] = 0.0                              # a zero block
    cum = np.cumsum(pr.astype(np.float64))
    total = cum[-1]
    u = rs.randint(0, int(total), size=batch).astype(np.float32)
    k = batch // 4
    u[:k] = cum[rs.randint(0, n_blocks * bs, size=k)]
    m = min(4, batch - k)   # as many of the four as the batch holds
    u[k:k + m] = np.array([-1.0, total, total + 3.0, 0.0])[:m]
    return pr, u


def _real_case(cap, bs, batch, seed):
    rs = np.random.RandomState(seed)
    n_blocks = -(-cap // bs)
    pr = np.zeros(n_blocks * bs, np.float32)
    pr[:cap] = np.abs(rs.randn(cap)) + 0.01
    tot = float(np.sum(pr, dtype=np.float64))
    u = ((np.arange(batch) + rs.rand(batch)) / batch * tot).astype(np.float32)
    return pr, u


def _pallas(pr, bs, u):
    leaves = jnp.asarray(pr.reshape(-1, bs))
    idx, prob = sample_pallas(leaves, jnp.sum(leaves, axis=1), jnp.asarray(u),
                              block_b=min(64, u.shape[0]), interpret=True)
    return np.asarray(idx), np.asarray(prob)


def _plain(pr, bs, u):
    leaves = torch.from_numpy(pr.reshape(-1, bs))
    return sample_plain(leaves, leaves.sum(1), torch.from_numpy(u))


@pytest.mark.parametrize("cap,bs,batch", SUMTREE_CASES + [RLPYT_CASE])
def test_plain_two_level_matches_pallas_on_integer_priorities(cap, bs, batch):
    pr, u = _integer_case(cap, bs, batch, seed=cap)
    jidx, jprob = _pallas(pr, bs, u)
    tidx, tprob = _plain(pr, bs, u)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    np.testing.assert_array_equal(tprob.numpy(), jprob)
    stats = tref.agreement(tidx, tprob, torch.from_numpy(pr), torch.from_numpy(u),
                           n_terms=tref.rounding_terms(pr.size // bs, bs),
                           exact=True)
    assert tref.agreement_ok(stats), stats


@pytest.mark.parametrize("cap,bs,batch", SUMTREE_CASES)
def test_plain_two_level_matches_pallas_on_real_priorities(cap, bs, batch):
    """Both sides within the rounding rule of the f64 oracle, and each
    other's prob within 2 f32 ulps where the indices agree."""
    pr, u = _real_case(cap, bs, batch, seed=cap + 1)
    n_terms = tref.rounding_terms(pr.size // bs, bs)
    jidx, jprob = _pallas(pr, bs, u)
    tidx, tprob = _plain(pr, bs, u)
    for idx, prob in ((tidx, tprob), (_t(jidx), _t(jprob))):
        stats = tref.agreement(idx, prob, torch.from_numpy(pr),
                               torch.from_numpy(u), n_terms=n_terms, exact=False)
        assert tref.agreement_ok(stats), stats
    same = tidx.numpy() == jidx
    assert same.mean() > 0.99
    np.testing.assert_allclose(tprob.numpy()[same], jprob[same], rtol=2.5e-7)


def test_plain_two_level_matches_pallas_at_rlpyt_scale_on_real_priorities():
    """At 2048 blocks of 512 the two sides sum each row in different orders
    over many more terms, so indices near a boundary differ more often than
    the 1 % the test above allows (seed cap + 1: 5 of 256, 2.0 %): both
    sides within the rounding rule of the f64 oracle, and each other's prob
    within 2 f32 ulps where the indices agree."""
    cap, bs, batch = RLPYT_CASE
    pr, u = _real_case(cap, bs, batch, seed=cap + 1)
    n_terms = tref.rounding_terms(pr.size // bs, bs)
    jidx, jprob = _pallas(pr, bs, u)
    tidx, tprob = _plain(pr, bs, u)
    for idx, prob in ((tidx, tprob), (_t(jidx), _t(jprob))):
        stats = tref.agreement(idx, prob, torch.from_numpy(pr),
                               torch.from_numpy(u), n_terms=n_terms, exact=False)
        assert tref.agreement_ok(stats), stats
    same = tidx.numpy() == jidx
    np.testing.assert_allclose(tprob.numpy()[same], jprob[same], rtol=2.5e-7)


def test_flat_oracle_matches_jax():
    pr, u = _real_case(1000, 128, 64, seed=3)
    jidx, jprob = jsample_reference(jnp.asarray(pr), jnp.asarray(u))
    tidx, tprob = tref.sample_reference(torch.from_numpy(pr), torch.from_numpy(u))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tprob.numpy(), np.asarray(jprob), rtol=1e-6)


def _faulty(leaves, bsums, u, fault, root=None):
    """sample_plain with one fault: '<' for '<=', no clamp, a residual that
    keeps the block base, or the total taken from ``root``."""
    n_blocks, bs = leaves.shape
    cum = torch.cumsum(bsums, 0)
    cmp = (lambda a, b: a < b) if fault == "lt" else (lambda a, b: a <= b)
    blk = cmp(cum[None, :], u[:, None]).sum(1)
    if fault != "clamp":
        blk = blk.clamp(max=n_blocks - 1)
    base = torch.where(blk > 0, cum[(blk - 1).clamp(0, n_blocks - 1)],
                       torch.zeros(()))
    off = u if fault == "base" else u - base
    rows = leaves[blk.clamp(max=n_blocks - 1)]
    inner = cmp(torch.cumsum(rows, 1), off[:, None]).sum(1)
    if fault != "clamp":
        inner = inner.clamp(max=bs - 1)
    total = root if fault == "root" else cum[-1]
    pr = torch.gather(rows, 1, inner.clamp(max=bs - 1)[:, None])[:, 0]
    return (blk * bs + inner).to(torch.int32), pr / total


@pytest.mark.parametrize("fault", ["lt", "clamp", "base", "root"])
def test_agreement_rule_catches_each_fault(fault):
    """The checks chip_smoke.py holds the kernel to reject four faults of
    the two-level search on the integer case (the root one on a tree whose
    stale root is 1.5 x the sum of its block sums)."""
    cap, bs, batch = 4096, 512, 128
    pr, u = _integer_case(cap, bs, batch, seed=9)
    leaves = torch.from_numpy(pr.reshape(-1, bs))
    bsums = leaves.sum(1)
    kw = dict(n_terms=tref.rounding_terms(leaves.shape[0], bs), exact=True)
    args = (torch.from_numpy(pr), torch.from_numpy(u))
    assert tref.agreement_ok(tref.agreement(*_faulty(leaves, bsums,
                                                     torch.from_numpy(u), None),
                                            *args, **kw))
    root = bsums.sum() * 1.5
    bad = tref.agreement(*_faulty(leaves, bsums, torch.from_numpy(u), fault,
                                  root), *args, **kw)
    assert not tref.agreement_ok(bad), (fault, bad)


def test_rounding_rule_allows_only_near_boundary_mismatches():
    pr = np.full(64, 1.0, np.float32)
    u = np.asarray([4.0 - 1e-6, 20.5], np.float32)
    kw = dict(n_terms=tref.rounding_terms(8, 8), exact=False)
    prob = torch.full((2,), 1.0 / 64)
    near = tref.agreement(torch.tensor([4, 20], dtype=torch.int32), prob,
                          torch.from_numpy(pr), torch.from_numpy(u), **kw)
    assert near["mismatches"] == 1 and tref.agreement_ok(near)
    far = tref.agreement(torch.tensor([3, 21], dtype=torch.int32), prob,
                         torch.from_numpy(pr), torch.from_numpy(u), **kw)
    assert far["violations"] == 1 and not tref.agreement_ok(far)


# ---------------------------------------------------------------------------
# the sum tree of replay/device.py
# ---------------------------------------------------------------------------

def _random_tree(size, seed, n_set=None):
    rs = np.random.RandomState(seed)
    tree = jnp.zeros(2 * size, jnp.float32)
    idx = np.arange(size) if n_set is None else rs.choice(size, n_set, replace=False)
    tree = jreplay.tree_set(tree, jnp.asarray(idx),
                            jnp.asarray(np.abs(rs.randn(idx.size)) + 0.01,
                                        jnp.float32))
    return np.array(tree)


@pytest.mark.parametrize("size,n", [(64, 17), (1024, 300)])
def test_pointer_walk_tree_set_is_bit_exact_vs_jax(size, n):
    rs = np.random.RandomState(size)
    base = _random_tree(size, seed=1)
    idx = rs.choice(size, n, replace=False)
    pr = (np.abs(rs.randn(n)) * 3).astype(np.float32)
    with registry.override("sum_tree=ref"):
        got = treplay.tree_set(torch.from_numpy(base.copy()), torch.from_numpy(idx),
                               torch.from_numpy(pr))
    want = jreplay.tree_set(jnp.asarray(base), jnp.asarray(idx), jnp.asarray(pr))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size,n", [(64, 17), (8192, 64)])
def test_blocked_update_within_one_ulp_per_level_of_pointer_walk(size, n):
    rs = np.random.RandomState(size + 1)
    base = torch.from_numpy(_random_tree(size, seed=2))
    idx = torch.from_numpy(rs.choice(size, n, replace=False))
    pr = torch.from_numpy((np.abs(rs.randn(n)) * 3).astype(np.float32))
    with registry.override("sum_tree=ref"):
        walk = treplay.tree_set(base.clone(), idx, pr).numpy()
    blocked = tops.tree_update_blocked(base.clone(), idx, pr).numpy()
    node = np.arange(1, 2 * size)
    levels_below = np.log2(size).astype(int) - np.floor(np.log2(node)).astype(int)
    bound = levels_below * np.spacing(np.abs(walk[1:]).astype(np.float32))
    assert np.all(np.abs(blocked[1:] - walk[1:]) <= bound)


@pytest.mark.parametrize("spec", ["sum_tree=ref", "sum_tree=cuda"])
def test_tree_sample_matches_jax_descent(spec):
    """Given JAX's uniforms, the port's descent (ref) and the blocked
    kernel's plain version (the cuda route on the CPU) pick JAX's leaves."""
    size, batch = 2048, 64
    tree = _random_tree(size, seed=5, n_set=1500)
    key = jax.random.PRNGKey(3)
    jidx, jprob = jreplay.tree_sample(jnp.asarray(tree), key, batch)
    u01 = np.asarray(jax.random.uniform(key, (batch,)))
    with registry.override(spec):
        tidx, tprob = treplay.tree_sample(torch.from_numpy(tree), None, batch,
                                          u01=_t(u01))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tprob.numpy(), np.asarray(jprob), rtol=2e-6)


def test_cpu_sampling_launches_no_kernel():
    n0 = tops.tree_sample_blocked.launches
    tree = torch.from_numpy(_random_tree(1024, seed=6))
    tops.tree_sample_blocked(tree, torch.rand(8) * tree[1])
    st = tops.set_priorities(tops.init_priorities(1000, 128),
                             torch.arange(1000), torch.rand(1000))
    idx, prob = tops.sample_proportional(st, torch.Generator().manual_seed(0), 32)
    assert idx.dtype == torch.int32 and int(idx.max()) < 1024
    assert tops.tree_sample_blocked.launches == n0
    assert tops.sample_proportional.launches == 0
    with pytest.raises(ValueError, match="all be on the CPU or all on CUDA"):
        tops.tree_sample_blocked(tree, torch.rand(8, device="meta"))


# ---------------------------------------------------------------------------
# DeviceReplay against repro.replay.device
# ---------------------------------------------------------------------------

def _batches(n, B, seed):
    rs = np.random.RandomState(seed)
    return [{"obs": rs.randn(B, 4).astype(np.float32),
             "act": rs.randint(0, 3, B).astype(np.int32)} for _ in range(n)]


@pytest.mark.parametrize("spec", ["sum_tree=ref", "sum_tree=cuda"])
def test_device_replay_round_matches_jax(spec):
    """insert (ring wrap, given and max-priority-init priorities), a
    prioritized and a uniform sample on JAX's draws, and a priority update:
    the same storage, cursor, filled, tree, indices and IS weights."""
    cap, batch = 40, 32
    jex = {"obs": jnp.zeros((4,)), "act": jnp.zeros((), jnp.int32)}
    tex = {"obs": torch.zeros(4), "act": torch.zeros((), dtype=torch.int32)}
    js = jreplay.init_replay(jex, cap)
    with registry.override(spec):
        ts = treplay.init_replay(tex, cap)
        for i, b in enumerate(_batches(3, 16, seed=1)):
            pr = None if i == 1 else np.arange(1.0, 17.0, dtype=np.float32) + i
            js = jreplay.insert(js, {k: jnp.asarray(v) for k, v in b.items()},
                                None if pr is None else jnp.asarray(pr))
            ts = treplay.insert(ts, {k: torch.from_numpy(v) for k, v in b.items()},
                                None if pr is None else torch.from_numpy(pr))
            assert (ts.cursor, ts.filled) == (int(js.cursor), int(js.filled))
            for k in ("obs", "act"):
                np.testing.assert_array_equal(ts.storage[k].numpy(),
                                              np.asarray(js.storage[k]))
            np.testing.assert_array_equal(ts.tree.numpy(), np.asarray(js.tree))

        key = jax.random.PRNGKey(7)
        jout, jidx, jw = jreplay.sample(js, key, batch, beta=0.4)
        u01 = torch.tensor(np.asarray(jax.random.uniform(key, (batch,))))
        tout, tidx, tw = treplay.sample(ts, None, batch, beta=0.4, draws=u01)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=2e-6)
        for k in ("obs", "act"):
            np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))

        ages = jax.random.randint(key, (batch,), 0, max(int(js.filled), 1))
        jout_u, jidx_u, jw_u = jreplay.sample(js, key, batch, uniform=True)
        tout_u, tidx_u, tw_u = treplay.sample(ts, None, batch, uniform=True,
                                              draws=_t(ages))
        np.testing.assert_array_equal(tidx_u.numpy(), np.asarray(jidx_u))
        np.testing.assert_array_equal(tw_u.numpy(), np.asarray(jw_u))

        # a repeated index carries the same td (the same transition)
        td = 0.1 + 0.05 * np.asarray(jidx, np.float32)
        js = jreplay.update_priorities(js, jidx, jnp.asarray(td))
        ts = treplay.update_priorities(ts, tidx, torch.from_numpy(td))
    np.testing.assert_allclose(ts.tree.numpy(), np.asarray(js.tree), rtol=2e-6)


def test_device_replay_interface_and_dispatch():
    """DeviceReplay's uniform flavour leaves the tree alone; the tree ops
    report their resolved backend once per (op, site, backend)."""
    tracer = trace.configure(None)
    try:
        r = DeviceReplay(64, prioritized=False)
        st = r.init({"obs": torch.zeros(2)})
        assert st.tree.shape == (128,)
        assert r.update_priorities(st, torch.arange(3), torch.ones(3)) is st
        with registry.override("auto"):
            treplay.tree_sample(torch.from_numpy(_random_tree(64, seed=0)),
                                torch.Generator().manual_seed(0), 4)
        ev = [e for e in tracer.events if e["kind"] == "kernel_dispatch"]
        assert [(e["name"], e["backend"]) for e in ev] == [
            ("sum_tree@replay.tree_sample", "ref")]
    finally:
        trace.reset()


def test_registry_resolves_sum_tree():
    assert registry.PORTED == ("attention", "ssd", "sum_tree")
    with registry.override("auto"):
        assert registry.backend_for("sum_tree", device="cpu") == "ref"
        assert registry.backend_for("sum_tree", device="cuda") == "cuda"
        assert registry.backend_for("sum_tree") == "ref"
    with registry.override("sum_tree=cuda"):
        assert registry.backend_for("sum_tree", device="cpu") == "cuda"
    with registry.override("cuda,sum_tree=ref"):
        assert registry.backend_for("sum_tree", device="cuda") == "ref"
        assert registry.backend_for("attention", device="cuda") == "cuda"
