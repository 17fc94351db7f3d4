"""The port's meta-device input specs (``repro_torch/launch/specs.py``)
against the JAX package's ``eval_shape`` specs (``repro/launch/specs.py``),
on the CPU.  Exact: shapes and dtypes equal, for all ten full configs and
every cell of ``cells(arch)``; every spec lies on the meta device, so
nothing is allocated.

Params are compared through ``models/convert.py``'s layout (a port leaf is
its JAX leaf at one index of the stacked superblock dims).  Dtypes: the
training specs are f32, as JAX's leaves; the serving specs (prefill,
decode) hold the matrices in the compute dtype (bf16), as the port's serve
path does, and the norm scales and the SSM's ``A_log`` / ``dt_bias`` in
f32.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import cells as jax_cells  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch.configs import cells, get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import backbones as tbb  # noqa: E402
from repro_torch.models.convert import _jax_leaf  # noqa: E402

F32_LEAVES = ("scale", "A_log", "dt_bias", "norm_scale")
CELLS = [(a, c) for a in ARCH_IDS for c in cells(a)]


def _dt(x) -> str:
    if isinstance(x, torch.dtype):
        return str(x).removeprefix("torch.")
    return np.dtype(x).name


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    return jspecs.param_specs(jax_get_config(arch))


def assert_params_match(arch, kind):
    cfg = get_config(arch)
    lm = tspecs.param_specs(cfg, kind)
    jtree = jax_params(arch)
    for name, p in lm.named_parameters():
        assert p.is_meta, name
        jname, idx = _jax_leaf(name, cfg)
        leaf = _get(jtree, jname)
        lead = tuple(leaf.shape[:len(idx or ())])
        assert all(i < n for i, n in zip(idx or (), lead))
        assert tuple(leaf.shape[len(lead):]) == tuple(p.shape), name
        if kind == "train":
            assert _dt(p.dtype) == _dt(leaf.dtype) == "float32", name
            assert p.requires_grad
        else:
            want = "float32" if name.rsplit(".", 1)[-1] in F32_LEAVES \
                else cfg.compute_dtype
            assert _dt(p.dtype) == want, name
    n = sum(p.numel() for p in lm.parameters())
    assert n == sum(x.size for x in jax.tree_util.tree_leaves(jtree))


def assert_tree_matches(got: dict, want: dict, what):
    assert sorted(got) == sorted(want), what
    for k, t in got.items():
        assert t.is_meta, (what, k)
        assert tuple(t.shape) == tuple(want[k].shape), (what, k)
        assert _dt(t.dtype) == _dt(want[k].dtype), (what, k)


def test_cells_match_jax():
    for a in ARCH_IDS:
        assert [c.name for c in cells(a)] == [c.name for c in jax_cells(a)]
        assert [(c.seq_len, c.global_batch, c.kind) for c in cells(a)] == \
            [(c.seq_len, c.global_batch, c.kind) for c in jax_cells(a)]


@pytest.mark.parametrize("arch,cell", CELLS,
                         ids=[f"{a}-{c.name}" for a, c in CELLS])
def test_specs_match_jax_eval_shape(arch, cell):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    jcell = next(c for c in jax_cells(arch) if c.name == cell.name)
    assert_params_match(arch, cell.kind)
    if cell.kind == "train":
        assert_tree_matches(tspecs.train_batch_specs(cfg, cell),
                            jspecs.train_batch_specs(jcfg, jcell), "batch")
        return
    if cell.kind == "prefill":
        got = tspecs.prefill_specs(cfg, cell)
        want = jspecs.prefill_specs(jcfg, jcell)
    else:
        got = tspecs.decode_specs(cfg, cell)
        want = jspecs.decode_specs(jcfg, jcell)
    assert_tree_matches(got.pop("cache"), dict(want.pop("cache")), "cache")
    assert_tree_matches(got, want, cell.kind)


def test_param_specs_draw_nothing_and_init_lm_is_unchanged():
    """The specs take no generator state, and init_lm still draws what it
    drew: the same seed gives the same weights with or without a spec
    built in between."""
    cfg = get_smoke_config("gemma2-2b")

    def draw():
        gen = torch.Generator().manual_seed(0)
        lm = tbb.init_lm(cfg, device="cpu", generator=gen)
        return [p.detach().clone() for p in lm.parameters()], gen.get_state()

    before, state = draw()
    tspecs.param_specs(get_config("gemma2-2b"), "train")
    tspecs.param_specs(get_config("gemma2-2b"), "decode")
    after, state2 = draw()
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert torch.equal(state, state2)
    with pytest.raises(ValueError):
        tspecs.param_specs(cfg, "serve")
