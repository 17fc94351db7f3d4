"""The port's sharding rules (``repro_torch/models/sharding.py``, the
rules half) against the JAX package's ``repro/models/sharding.py``, on the
CPU.  Exact: every partition spec equal, leaf by leaf.

The port's params are per-layer tensors; JAX's are stacked along leading
superblock dims (``models/convert.py``'s layout).  Each port leaf is
matched to its JAX leaf through ``convert._jax_leaf`` and its spec must
equal JAX's spec with the stacked dims dropped (which JAX's rule leaves
``None``).  Smoke configs at tp 1, 2 and 4 with no mesh; every full config
at tp 16 on the (2, 16, 16) production mesh, with FSDP over no axis,
``("data",)`` and ``("pod", "data")`` (JAX's rules read a
``jax.sharding.AbstractMesh``, which needs no devices).  The cache rules
and ``batch_spec`` likewise.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import backbones as jbb  # noqa: E402
from repro.models import sharding as jshd  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import backbones as tbb  # noqa: E402
from repro_torch.models import sharding as tshd  # noqa: E402
from repro_torch.models.convert import _jax_leaf  # noqa: E402

MULTI = ((2, 16, 16), ("pod", "data", "model"))


@pytest.fixture(autouse=True)
def no_global_mesh():
    jshd.set_global_mesh(None)
    tshd.set_global_mesh(None)
    yield
    jshd.set_global_mesh(None)
    tshd.set_global_mesh(None)


@functools.lru_cache(maxsize=None)
def jax_params(arch, smoke):
    cfg = jax_get_smoke(arch) if smoke else jax_get_config(arch)
    return jspecs.param_specs(cfg)


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _spec(p):
    return tuple(p)


def assert_port_matches_jax(arch, smoke, **kw):
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    jcfg = jax_get_smoke(arch) if smoke else jax_get_config(arch)
    jtree = jshd.param_pspecs(jax_params(arch, smoke), jcfg, **kw)
    lm = tspecs.param_specs(cfg)
    got = tshd.param_pspecs(lm, cfg, **kw)
    assert list(got) == [n for n, _ in lm.named_parameters()]
    sharded = 0
    for name, p in lm.named_parameters():
        jname, idx = _jax_leaf(name, cfg)
        want = _spec(_get(jtree, jname))
        n_pad = len(idx) if idx else 0
        assert want[:n_pad] == (None,) * n_pad, (name, want)
        assert _spec(got[name]) == want[n_pad:], (name, got[name], want)
        assert len(got[name]) == p.dim()
        sharded += any(a is not None for a in got[name])
    return sharded


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_config_pspecs_match_jax(arch, tp):
    sharded = assert_port_matches_jax(arch, True, tp=tp)
    if tp == 1:
        assert sharded == 0


@pytest.mark.parametrize("fsdp", [None, ("data",), ("pod", "data")],
                         ids=["tp", "fsdp_data", "fsdp_pod_data"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_pspecs_match_jax_on_production_mesh(arch, fsdp):
    jshd.set_global_mesh(jax.sharding.AbstractMesh(*MULTI),
                         dp_axes=("pod", "data"))
    tshd.set_global_mesh(tmesh.make_production_mesh(multi_pod=True),
                         dp_axes=("pod", "data"))
    assert tshd.tp_size() == 16 and tshd.n_batch_shards() == 32
    assert assert_port_matches_jax(arch, False, tp=16, fsdp_axes=fsdp) > 0


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_pspecs_match_jax(arch, multi_pod):
    shape = MULTI if multi_pod else ((16, 16), ("data", "model"))
    dp = shape[1][:-1]
    jshd.set_global_mesh(jax.sharding.AbstractMesh(*shape), dp_axes=dp)
    tshd.set_global_mesh(tmesh.make_production_mesh(multi_pod=multi_pod),
                         dp_axes=dp)
    for B, S in ((128, 32768), (1, 524288), (8, 1089)):
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        want = jbb.cache_pspecs(jcfg, jspecs.cache_specs(jcfg, B, S))
        got = tbb.cache_pspecs(cfg, tspecs.cache_specs(cfg, B, S))
        assert sorted(got) == sorted(want)
        for k in got:
            assert _spec(got[k]) == _spec(want[k]), (k, B, S)
    assert _spec(tshd.batch_spec(None)) == _spec(jshd.batch_spec(None))


def test_production_mesh_shapes_match_jax():
    for multi_pod, (sizes, names) in ((False, ((16, 16), ("data", "model"))),
                                      (True, MULTI)):
        m = tmesh.make_production_mesh(multi_pod=multi_pod)
        assert (m.axis_sizes, m.axis_names) == (sizes, names)
        assert m.shape == dict(zip(names, sizes)) and m.size == 256 * (
            1 + multi_pod)
