"""The host replay of the PyTorch port against the JAX package, on the CPU:
the numpy ``SumTree`` and every host buffer (uniform and prioritized
n-step, sequence, frame) fed the same blocks, including appends that wrap
the ring, and sampled from the same ``np.random.default_rng`` seed: the
indices, IS weights and every field of the batches are bit-identical, after
priority updates too; sequence validity across the cursor; ``state_dict``
crossing both packages (a ``replay_*.npz`` written by either loads into the
other); the replay interface's host backends fed a RolloutBatch; and a
time-bounded stress test of ``LockedReplay`` with an inserting thread.

Every comparison is exact: both packages run the same numpy arithmetic on
the same arrays.
"""
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.replay import host as jhost  # noqa: E402
from repro.replay import interface as jinterface  # noqa: E402
from repro.replay.sum_tree import SumTree as JSumTree  # noqa: E402
from repro.samplers.serial import RolloutBatch as JRolloutBatch  # noqa: E402
from repro_torch.replay import host as thost  # noqa: E402
from repro_torch.replay import interface as tinterface  # noqa: E402
from repro_torch.replay.sum_tree import SumTree  # noqa: E402
from repro_torch.samplers.serial import RolloutBatch  # noqa: E402


def _equal(a, b):
    """Exact equality of two batches (dicts, namedtuples, tuples, arrays)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif a is None:
        assert b is None
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# sum tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity,stratified", [(1, True), (37, True),
                                                 (512, False), (1000, True)])
def test_sum_tree_matches_jax_bit_for_bit(capacity, stratified):
    """Random sets with repeated indices and zeros, then samples from the
    same generator seed: identical tree arrays, indices and probabilities."""
    rs = np.random.RandomState(capacity)
    t, j = SumTree(capacity), JSumTree(capacity)
    for _ in range(5):
        idx = rs.randint(0, capacity, 3 * capacity + 1)
        pr = rs.uniform(0, 2, idx.shape) * (rs.rand(idx.size) > 0.2)
        t.set(idx, pr)
        j.set(idx, pr)
        np.testing.assert_array_equal(t.tree, j.tree)
        if j.total <= 0:
            continue
        ti, tp = t.sample(64, np.random.default_rng(3), stratified=stratified)
        ji, jp = j.sample(64, np.random.default_rng(3), stratified=stratified)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tp, jp)
    assert t.total == j.total and t.capacity == capacity
    np.testing.assert_array_equal(t.get(np.arange(capacity)),
                                  j.get(np.arange(capacity)))


def test_sum_tree_empty_raises():
    with pytest.raises(ValueError, match="empty"):
        SumTree(8).sample(4, np.random.default_rng(0))


# ---------------------------------------------------------------------------
# transition buffers
# ---------------------------------------------------------------------------

def _transition_blocks(n_blocks, T, B, obs_shape, seed, frames=False):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n_blocks):
        obs = (rs.rand(T, B, *obs_shape) < 0.3).astype(np.float32)
        out.append(dict(
            observation=obs, action=rs.randint(0, 3, (T, B)).astype(np.int32),
            reward=rs.randn(T, B).astype(np.float32),
            done=rs.rand(T, B) < (0.25 if frames else 0.15),
            timeout=rs.rand(T, B) < 0.5,
            next_obs=(rs.rand(T, B, *obs_shape) < 0.3).astype(np.float32)))
    return out


def _example(mod, obs_shape):
    return mod.TransitionSamples(
        observation=np.zeros(obs_shape, np.float32), action=np.int32(0),
        reward=np.float32(0), done=False, timeout=False)


BUFFERS = {
    "uniform_1step": ("UniformReplayBuffer", dict(n_step=1)),
    "uniform_3step_next_obs": ("UniformReplayBuffer",
                               dict(n_step=3, store_next_obs=True,
                                    discount=0.9)),
    "prioritized_3step": ("PrioritizedReplayBuffer",
                          dict(n_step=3, alpha=0.7, beta=0.5)),
    "prioritized_next_obs": ("PrioritizedReplayBuffer",
                             dict(n_step=2, store_next_obs=True)),
    "frame_4": ("FrameReplayBuffer", dict(frames=4, n_step=2)),
}


@pytest.mark.parametrize("name", sorted(BUFFERS))
def test_transition_buffers_match_jax(name):
    """Seven appends of 12 steps into a 40-step ring (it wraps twice), a
    sample after each from the same generator seed, and — prioritized —
    priority updates from the sampled indices: bit-identical batches,
    indices and weights; then ``state_dict`` equal key for key."""
    cls, kw = BUFFERS[name]
    frames = cls == "FrameReplayBuffer"
    obs_shape = (4, 3, 1) if frames else (5,)
    T_size, B, T = 40, 3, 12
    tb = getattr(thost, cls)(_example(thost, obs_shape), T_size, B, **kw)
    jb = getattr(jhost, cls)(_example(jhost, obs_shape), T_size, B, **kw)
    for i, blk in enumerate(_transition_blocks(7, T, B, obs_shape, seed=11,
                                               frames=frames)):
        for buf, mod in ((tb, thost), (jb, jhost)):
            s = mod.TransitionSamples(**{k: blk[k] for k in (
                "observation", "action", "reward", "done", "timeout")})
            buf.append_samples(s, next_obs=blk["next_obs"])
        assert (tb.t, tb.filled) == (jb.t, jb.filled)
        tbatch = tb.sample_batch(16, np.random.default_rng(i))
        jbatch = jb.sample_batch(16, np.random.default_rng(i))
        _equal(tbatch, jbatch)
        if cls == "PrioritizedReplayBuffer":
            td = np.random.RandomState(i).randn(16).astype(np.float32)
            tb.update_priorities(tbatch["indices"], td)
            jb.update_priorities(jbatch["indices"], td)
            np.testing.assert_array_equal(tb.tree.tree, jb.tree.tree)
    _equal(tb.state_dict(), jb.state_dict())


def test_nstep_return_on_the_port_brute_force():
    """The mirror of tests/test_replay.py::test_nstep_return_brute_force on
    the port's buffer: the n-step return summed by hand."""
    T_size, B, n, g = 20, 1, 3, 0.9
    ex = _example(thost, (1,))
    buf = thost.UniformReplayBuffer(ex, T_size, B, n_step=n, discount=g)
    rew = np.arange(10, dtype=np.float32).reshape(10, 1)
    done = np.zeros((10, 1), bool)
    done[5] = True
    s = thost.TransitionSamples(
        observation=np.arange(10, dtype=np.float32).reshape(10, 1, 1),
        action=np.zeros((10, 1), np.int32), reward=rew, done=done,
        timeout=np.zeros((10, 1), bool))
    buf.append_samples(s)
    out = buf.extract_batch(np.array([3, 4, 6]), np.zeros(3, np.int64))
    np.testing.assert_allclose(out["return_"],
                               [3 + g * 4 + g * g * 5, 4 + g * 5,
                                6 + g * 7 + g * g * 8], rtol=1e-6)
    np.testing.assert_array_equal(out["n_used"], [3, 2, 3])
    np.testing.assert_array_equal(out["done_n"], [True, True, False])


# ---------------------------------------------------------------------------
# sequence buffer
# ---------------------------------------------------------------------------

def _seq_example(mod, H=4):
    return mod.SequenceSamples(
        observation=np.zeros((2, 3), np.float32), prev_action=np.int32(0),
        prev_reward=np.float32(0), action=np.int32(0), reward=np.float32(0),
        done=False, init_state=(np.zeros(H, np.float32),
                                np.zeros(H, np.float32)))


def _seq_block(mod, rs, interval, B, block, H=4):
    return mod.SequenceSamples(
        observation=rs.randn(interval, B, 2, 3).astype(np.float32),
        prev_action=rs.randint(0, 3, (interval, B)).astype(np.int32),
        prev_reward=rs.randn(interval, B).astype(np.float32),
        action=rs.randint(0, 3, (interval, B)).astype(np.int32),
        reward=np.full((interval, B), float(block), np.float32),
        done=rs.rand(interval, B) < 0.1,
        init_state=(np.full((B, H), float(block), np.float32),
                    rs.randn(B, H).astype(np.float32)))


def test_sequence_buffer_matches_jax_across_the_cursor():
    """Fourteen blocks into a 64-step ring of 8-step blocks (it wraps):
    after each, the sampleable slots (whole window written, not crossing
    the cursor), the sum tree, a sample from the same generator seed (the
    sequences, stored states, weights and indices) and priority updates
    with the R2D2 mixture are bit-identical to JAX's."""
    T_size, B, interval, L = 64, 3, 8, 12
    kw = dict(seq_len=L, burn_in=4, state_interval=interval, alpha=0.6,
              beta=0.4, eta=0.9)
    tb = thost.SequenceReplayBuffer(_seq_example(thost), T_size, B, **kw)
    jb = jhost.SequenceReplayBuffer(_seq_example(jhost), T_size, B, **kw)
    for block in range(14):
        rs_t = np.random.RandomState(block)
        rs_j = np.random.RandomState(block)
        tb.append_samples(_seq_block(thost, rs_t, interval, B, block))
        jb.append_samples(_seq_block(jhost, rs_j, interval, B, block))
        valid = tb._valid_slots()
        np.testing.assert_array_equal(valid, jb._valid_slots())
        np.testing.assert_array_equal(tb.tree.tree, jb.tree.tree)
        if not valid.any():
            continue
        # no sampleable window crosses the cursor: its L + 1 steps are the
        # newest written ones or older
        t_s = np.arange(tb.n_slots)[valid] * interval
        age = (tb.t - t_s) % T_size
        age = np.where(age == 0, T_size, age)
        assert (age >= L + 1).all() and (age <= tb.filled).all()
        tout = tb.sample_batch(6, np.random.default_rng(block))
        jout = jb.sample_batch(6, np.random.default_rng(block))
        _equal(tout, jout)
        # stored state is the one of the block the sequence starts in
        np.testing.assert_array_equal(tout["init_state"][0][:, 0],
                                      tout["sequence"].reward[:, 0])
        mx = np.random.RandomState(100 + block).rand(6).astype(np.float32)
        mean = mx * 0.5
        tb.update_priorities(tout["indices"], mx, mean)
        jb.update_priorities(jout["indices"], mx, mean)
        np.testing.assert_array_equal(tb.slot_pr, jb.slot_pr)
        np.testing.assert_array_equal(tb.tree.tree, jb.tree.tree)
    _equal(tb.state_dict(), jb.state_dict())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sidecar_crosses_both_packages(writer, tmp_path):
    """A sequence buffer and a prioritized buffer saved by one package with
    ``np.savez`` (the async runner's ``replay_*.npz``) load into a fresh
    buffer of the other: the same state, the same next sample."""
    T_size, B, interval = 32, 2, 8
    kw = dict(seq_len=12, burn_in=2, state_interval=interval)
    src_mod, dst_mod = (jhost, thost) if writer == "jax" else (thost, jhost)
    src = src_mod.SequenceReplayBuffer(_seq_example(src_mod), T_size, B, **kw)
    rs = np.random.RandomState(5)
    for block in range(6):
        src.append_samples(_seq_block(src_mod, rs, interval, B, block))
    src.update_priorities(np.array([1, 3]), np.array([2.0, 0.5]),
                          np.array([1.0, 0.1]))
    psrc = src_mod.PrioritizedReplayBuffer(_example(src_mod, (5,)), 24, B,
                                           n_step=2)
    for blk in _transition_blocks(3, 10, B, (5,), seed=2):
        psrc.append_samples(src_mod.TransitionSamples(**{k: blk[k] for k in (
            "observation", "action", "reward", "done", "timeout")}))
    for buf, dst, name in (
            (src, dst_mod.SequenceReplayBuffer(_seq_example(dst_mod), T_size,
                                               B, **kw), "seq"),
            (psrc, dst_mod.PrioritizedReplayBuffer(
                _example(dst_mod, (5,)), 24, B, n_step=2), "prio")):
        path = tmp_path / f"replay_{name}.npz"
        with open(path, "wb") as f:
            np.savez(f, **buf.state_dict())
        with np.load(path) as d:
            dst.load_state_dict(d)
        _equal(dst.state_dict(), buf.state_dict())
        _equal(dst.sample_batch(4, np.random.default_rng(9)),
               buf.sample_batch(4, np.random.default_rng(9)))


def test_sequence_alignment_on_the_port():
    """The mirror of tests/test_replay.py::test_sequence_replay_alignment:
    sequences start at stored-state boundaries, with the state captured at
    that block's start, and block ids never decrease along a sequence."""
    T_size, B, interval, L = 64, 2, 8, 12
    buf = thost.SequenceReplayBuffer(_seq_example(thost), T_size, B,
                                     seq_len=L, burn_in=4,
                                     state_interval=interval)
    rs = np.random.RandomState(0)
    for block in range(6):
        buf.append_samples(_seq_block(thost, rs, interval, B, block))
    out = buf.sample_batch(8, np.random.default_rng(1))
    seq_rew = out["sequence"].reward
    np.testing.assert_allclose(out["init_state"][0][:, 0], seq_rew[:, 0])
    assert (np.diff(seq_rew, axis=1) >= 0).all()
    assert out["sequence"].observation.shape == (8, L + 1, 2, 3)
    assert out["sequence"].init_state is None


# ---------------------------------------------------------------------------
# the replay interface's host backends
# ---------------------------------------------------------------------------

def _rollout(T, B, seed, tensors):
    rs = np.random.RandomState(seed)
    fields = dict(
        observation=rs.randn(T, B, 5).astype(np.float32),
        prev_action=rs.randint(0, 3, (T, B)).astype(np.int32),
        prev_reward=rs.randn(T, B).astype(np.float32),
        action=rs.randint(0, 3, (T, B)).astype(np.int32),
        reward=rs.randn(T, B).astype(np.float32),
        done=rs.rand(T, B) < 0.2, timeout=rs.rand(T, B) < 0.5,
        next_observation=rs.randn(T, B, 5).astype(np.float32),
        agent_info={"q": rs.randn(T, B, 3).astype(np.float32)})
    if tensors:
        return RolloutBatch(**{k: (
            {kk: torch.from_numpy(vv) for kk, vv in v.items()}
            if isinstance(v, dict) else torch.from_numpy(v))
            for k, v in fields.items()})
    return JRolloutBatch(**{k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
                                if isinstance(v, dict) else jnp.asarray(v))
                            for k, v in fields.items()})


def test_host_transition_replay_matches_jax():
    """RolloutBatches inserted through ``HostTransitionReplay`` (prioritized,
    storing the next obs) behind ``LockedReplay``: the same samples,
    indices and weights as JAX's, and priority updates taken from tensors
    land as JAX's from its arrays."""
    B = 4
    t = tinterface.LockedReplay(tinterface.HostTransitionReplay(
        thost.PrioritizedReplayBuffer(_example(thost, (5,)), 32, B, n_step=2,
                                      store_next_obs=True)))
    j = jinterface.LockedReplay(jinterface.HostTransitionReplay(
        jhost.PrioritizedReplayBuffer(_example(jhost, (5,)), 32, B, n_step=2,
                                      store_next_obs=True)))
    ts, js = t.init(), j.init()
    for i in range(4):
        t.insert(ts, _rollout(8, B, i, tensors=True))
        j.insert(js, _rollout(8, B, i, tensors=False))
        tb, ti, tw = t.sample(ts, np.random.default_rng(i), 16)
        jb, ji, jw = j.sample(js, np.random.default_rng(i), 16)
        _equal((tb, ti, tw), (jb, ji, jw))
        td = np.random.RandomState(i).rand(16).astype(np.float32)
        t.update_priorities(ts, ti, torch.from_numpy(td))
        j.update_priorities(js, ji, jnp.asarray(td))
        np.testing.assert_array_equal(ts.tree.tree, js.tree.tree)


def test_host_sequence_replay_matches_jax():
    """Blocks of 8 inserted through ``HostSequenceReplay`` with their
    block-start recurrent state as tensors (the runner's ``init_state``):
    identical storage, samples and R2D2 priority updates."""
    B, interval, H = 4, 8, 3
    kw = dict(seq_len=12, burn_in=2, state_interval=interval)
    ex = {m: m.SequenceSamples(
        observation=np.zeros(5, np.float32), prev_action=np.int32(0),
        prev_reward=np.float32(0), action=np.int32(0), reward=np.float32(0),
        done=False, init_state=(np.zeros(H, np.float32),
                                np.zeros(H, np.float32)))
        for m in (thost, jhost)}
    t = tinterface.HostSequenceReplay(
        thost.SequenceReplayBuffer(ex[thost], 48, B, **kw))
    j = jinterface.HostSequenceReplay(
        jhost.SequenceReplayBuffer(ex[jhost], 48, B, **kw))
    ts, js = t.init(), j.init()
    for i in range(8):
        st = np.random.RandomState(50 + i).randn(2, B, H).astype(np.float32)
        t.insert(ts, _rollout(interval, B, i, tensors=True),
                 init_state=(torch.from_numpy(st[0]), torch.from_numpy(st[1])))
        j.insert(js, _rollout(interval, B, i, tensors=False),
                 init_state=(jnp.asarray(st[0]), jnp.asarray(st[1])))
        _equal(ts.state_dict(), js.state_dict())
        if ts.tree.total <= 0:
            continue
        tb, ti, tw = t.sample(ts, np.random.default_rng(i), 5)
        jb, ji, jw = j.sample(js, np.random.default_rng(i), 5)
        _equal((tb, ti, tw), (jb, ji, jw))
        mx = np.random.RandomState(i).rand(5).astype(np.float32)
        t.update_priorities(ts, ti, torch.from_numpy(mx),
                            torch.from_numpy(mx / 3))
        j.update_priorities(js, ji, jnp.asarray(mx), jnp.asarray(mx / 3))
        np.testing.assert_array_equal(ts.tree.tree, js.tree.tree)


def test_host_tree_copies_tensors_and_keeps_the_rest():
    tree = {"a": torch.arange(3), "b": (np.ones(2), None),
            "c": torch.zeros(2, dtype=torch.bool)}
    out = tinterface.host_tree(tree)
    assert isinstance(out["a"], np.ndarray) and out["a"].tolist() == [0, 1, 2]
    assert out["b"][1] is None and out["b"][0] is tree["b"][0]
    assert out["c"].dtype == np.bool_


def test_locked_replay_refuses_a_device_backend():
    with pytest.raises(TypeError, match="host backends"):
        tinterface.LockedReplay(tinterface.DeviceReplay(8))


def test_locked_replay_under_a_concurrent_inserter():
    """A copier thread inserts 40 blocks while this thread samples and
    updates priorities, with a short switch interval: no sample ever sees a
    torn tree (every tree node equals the sum of its children at each
    sample, read under the lock) and every insert lands; bounded by a
    join timeout."""
    B = 8
    replay = tinterface.LockedReplay(tinterface.HostTransitionReplay(
        thost.PrioritizedReplayBuffer(_example(thost, (5,)), 64, B,
                                      n_step=2)))
    state = replay.init()
    replay.insert(state, _rollout(8, B, 0, tensors=True))
    errors, n_blocks = [], 40

    def copier():
        try:
            for i in range(n_blocks):
                replay.insert(state, _rollout(8, B, i + 1, tensors=True))
        except BaseException as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        th = threading.Thread(target=copier, daemon=True)
        th.start()
        rng = np.random.default_rng(0)
        samples = 0
        while th.is_alive() or samples < 20:
            _, idx, w = replay.sample(state, rng, 16)
            replay.update_priorities(state, idx, torch.rand(16))
            with replay.lock:
                tree, size = state.tree.tree, state.tree.size
                inner = np.arange(1, size)
                np.testing.assert_allclose(
                    tree[inner], tree[2 * inner] + tree[2 * inner + 1],
                    rtol=1e-12)
            assert np.isfinite(w).all()
            samples += 1
        th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not th.is_alive() and not errors
    assert state.filled == 64 and state.t == (8 * (n_blocks + 1)) % 64
