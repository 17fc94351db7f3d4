"""The PyTorch port stands alone: no file under src/repro_torch/, and not
chip_smoke.py, imports ``jax`` or the JAX package ``repro`` (checked on the
AST, so an import inside a function counts too); importing the package
builds no kernel; and the serving and training entry points default to the
card."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10 and all(f.exists() for f in files)
    return files


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__"):
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
                    and not arg.value.startswith("."):
                yield arg.value.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_no_jax_and_no_repro(path):
    bad = [(mod, line) for mod, line in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def test_import_walk_catches_forbidden_imports(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("def g():\n    from repro.models import layers\n"
                 "    import jax.numpy as jnp\n"
                 "    importlib.import_module('jax')\n")
    assert [m for m, _ in _imported_roots(f)] == ["repro", "jax", "jax"]


def test_importing_the_port_builds_nothing():
    """In a fresh interpreter: importing every module loads no kernel
    library and starts no build."""
    code = ("import importlib, pathlib, sys\n"
            "root = pathlib.Path('src')\n"
            "for f in sorted((root / 'repro_torch').rglob('*.py')):\n"
            "    mod = '.'.join(f.relative_to(root).with_suffix('').parts)\n"
            "    importlib.import_module(mod.removesuffix('.__init__'))\n"
            "fa = sys.modules['repro_torch.kernels.flash_attention"
            ".flash_attention']\n"
            "ssd = sys.modules['repro_torch.kernels.ssd_scan.ssd_scan']\n"
            "st = sys.modules['repro_torch.kernels.sum_tree.sum_tree']\n"
            "assert fa._lib is None and ssd._lib is None and st._lib is None\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env={**os.environ, "PYTHONPATH": str(REPO / "src")},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_serve_defaults_to_cuda():
    from repro_torch.launch import serve
    ap = serve.build_parser()
    assert ap.get_default("device") == "cuda"
    assert ap.get_default("arch") == "mamba2-1.3b"  # JAX's serve default


def test_serve_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--rounds", "0"])


def test_train_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch import train
    assert train.build_parser().get_default("device") == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "0"])


def _arch_configs():
    from repro_torch.configs import ALIASES
    return [(a, smoke) for a in sorted(ALIASES) for smoke in (True, False)]


@pytest.mark.parametrize("arch,smoke", _arch_configs(),
                         ids=lambda v: v if isinstance(v, str) else
                         ("smoke" if v else "full"))
def test_every_config_has_its_kernel_instances(arch, smoke):
    """Every config of the ten, smoke and full, finds each kernel instance
    its path on the card runs in the built lists, so no entry point needs
    to refuse a config: attention (every family but ssm) at its head dim
    for prefill and its (head dim, query heads a KV head) for decode, and
    the SSD scan (ssm, hybrid; training) at its (P, N, chunk); and so does
    each rank of a 'model' axis of 2 and 4 (``train --mesh 1xM``): its
    local (head dim, group) (``layers.kv_layout``) and its SSD heads'
    instance."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels.flash_attention.flash_attention import (
        DECODE_INSTANCES, HEAD_DIMS)
    from repro_torch.kernels.ssd_scan.ssd_scan import INSTANCES
    from repro_torch.models.layers import kv_layout
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    runs_attention = cfg.family != "ssm"
    runs_ssd = cfg.family in ("ssm", "hybrid")
    assert runs_attention or runs_ssd
    if runs_attention:
        assert cfg.d_head in HEAD_DIMS
        assert (cfg.d_head, cfg.n_heads // cfg.n_kv_heads) in DECODE_INSTANCES
        for tp in (2, 4):
            for rank in range(tp):
                heads, _, kv = kv_layout(cfg, tp, rank)
                assert (cfg.d_head, heads // kv) in DECODE_INSTANCES, (tp,
                                                                      rank)
    if runs_ssd:
        assert (cfg.ssm_headdim, cfg.d_state, cfg.ssd_chunk) in INSTANCES


def test_every_kernel_source_is_built_and_ported():
    """Each csrc/*.cu is in build.SOURCES, and the registry's PORTED ops are
    exactly those with a kernel package."""
    from repro_torch.kernels import build, registry
    assert sorted(build.SOURCES) == sorted(
        p.stem for p in (PORT / "csrc").glob("*.cu"))
    assert registry.PORTED == registry.OPS == ("attention", "ssd", "sum_tree")
    assert "unported" not in registry.describe("cuda").values()


def test_walk_covers_the_qpg_slice_and_its_runners_default_to_the_card():
    """The QPG slice's modules are among the files the import walk checks,
    and the runners it trains through default to the card."""
    import inspect
    from repro_torch.runners import OffPolicyRunner, OnPolicyRunner
    walked = {f.relative_to(PORT).as_posix() for f in _port_files()[:-1]}
    assert {"algos/qpg/__init__.py", "algos/qpg/ddpg.py", "algos/qpg/td3.py",
            "algos/qpg/sac.py", "envs/pendulum.py", "train/checkpoint.py",
            "examples/pendulum_qpg.py"} <= walked
    for runner in (OffPolicyRunner, OnPolicyRunner):
        device = inspect.signature(runner.run).parameters["device"]
        assert device.default == "cuda"


def test_walk_covers_the_r2d1_and_async_slice_and_it_defaults_to_the_card():
    """The R2D1 / async slice's modules are among the files the import walk
    checks (no ``jax``, no ``repro``), and its runners and example twins
    default to the card."""
    import inspect
    from repro_torch.examples import mujoco_style_sac, r2d1_recurrent
    from repro_torch.runners import AsyncR2D1Runner, AsyncRunner
    walked = {f.relative_to(PORT).as_posix() for f in _port_files()[:-1]}
    assert {"algos/dqn/r2d1.py", "samplers/alternating.py",
            "replay/sum_tree.py", "replay/host.py", "replay/interface.py",
            "train/vtrace.py", "launch/mesh.py", "runners/async_rl.py",
            "models/rl_models.py", "agents.py", "examples/r2d1_recurrent.py",
            "examples/mujoco_style_sac.py"} <= walked
    for runner in (AsyncRunner, AsyncR2D1Runner):
        device = inspect.signature(runner.run).parameters["device"]
        assert device.default == "cuda"
    for example in (r2d1_recurrent, mujoco_style_sac):
        assert example.build_parser().get_default("device") == "cuda"


def test_walk_covers_the_moe_slice_and_its_entry_points():
    """The moe slice's modules are among the files the import walk checks,
    each new arch resolves in both entry points, and the serve_decode twin
    keeps the JAX example's default argv (on serve's default device, the
    card)."""
    from repro_torch.configs import ALIASES, ARCH_IDS, resolve
    from repro_torch.examples import serve_decode
    from repro_torch.launch import serve
    walked = {f.relative_to(PORT).as_posix() for f in _port_files()[:-1]}
    assert {"configs/glm4_9b.py", "configs/phi3_mini_3p8b.py",
            "configs/granite_34b.py", "configs/qwen2_moe_a2p7b.py",
            "configs/mixtral_8x7b.py", "models/layers.py",
            "models/backbones.py", "models/convert.py",
            "examples/serve_decode.py",
            "kernels/registry.py"} <= walked
    assert sorted(ARCH_IDS) == sorted(ALIASES.values())
    for arch in ("glm4-9b", "phi3-mini-3.8b", "granite-34b",
                 "qwen2-moe-a2.7b", "mixtral-8x7b"):
        assert resolve(arch) in ARCH_IDS
    assert serve_decode.DEFAULTS == ["--arch", "mixtral-8x7b", "--batch", "8",
                                     "--prompt-len", "64", "--gen", "32"]
    assert serve.build_parser().parse_args(serve_decode.DEFAULTS).device == \
        "cuda"


def test_walk_covers_the_last_families_and_their_entry_points(monkeypatch):
    """The hybrid, vlm and encdec configs are among the files the import
    walk checks, every arch of the JAX package resolves in the port, and
    ``train --arch whisper-medium`` is refused before any weight is drawn
    (the launcher passes no encoder frames, as JAX's)."""
    from repro_torch.configs import ARCH_IDS, resolve
    from repro_torch.launch import train
    walked = {f.relative_to(PORT).as_posix() for f in _port_files()[:-1]}
    assert {"configs/zamba2_7b.py", "configs/whisper_medium.py",
            "configs/llama32_vision_90b.py"} <= walked
    assert len(ARCH_IDS) == 10
    for arch in ("zamba2-7b", "whisper-medium", "llama-3.2-vision-90b"):
        assert resolve(arch) in ARCH_IDS
    def drawn(*a, **k):
        raise AssertionError("a weight was drawn")

    monkeypatch.setattr(train.bb, "init_lm", drawn)
    with pytest.raises(ValueError, match="encoder frames"):
        train.main(["--arch", "whisper-medium", "--device", "cpu",
                    "--steps", "1"])


def test_chip_smoke_catches_no_failure_and_fails_without_a_card(tmp_path):
    """No phase of chip_smoke.py swallows a failure: its only ``try`` blocks
    with handlers expect a named exception (an entry point's refusal) and
    call ``fail`` when none comes.  Without a CUDA device, and copied alone into an empty
    directory, it exits non-zero and prints no result line."""
    src = (REPO / "chip_smoke.py").read_text()
    tries = [n for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Try) and n.handlers]  # not try / finally
    assert tries
    for node in tries:
        for h in node.handlers:
            assert isinstance(h.type, ast.Name) and h.type.id not in (
                "Exception", "BaseException"), ast.dump(h)
        assert any(isinstance(c, ast.Call) and getattr(c.func, "id", "")
                   == "fail" for n in node.orelse for c in ast.walk(n))
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(src)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script, extra in ((tmp_path, alone, {}),
                               (REPO, REPO / "chip_smoke.py",
                                {"CUDA_VISIBLE_DEVICES": ""})):
        r = subprocess.run([sys.executable, str(script)], cwd=cwd,
                           env={**env, **extra}, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode != 0 and '"ok": true' not in r.stdout, r.stdout


RANDOM_CALLS = ("rand", "randn", "randint", "randperm", "rand_like",
                "randn_like", "randint_like", "normal", "multinomial",
                "bernoulli", "poisson", "exponential_", "uniform_",
                "normal_", "random_", "bernoulli_")


def test_port_draws_only_from_explicit_generators():
    """Every torch random draw in the port names its ``torch.Generator``
    (``generator=``), and nothing seeds or reads torch's global stream:
    JAX's explicit keys become explicit generators (numpy draws come from
    a ``RandomState`` of their own, as in JAX)."""
    bad = []
    for path in _port_files()[:-1]:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = getattr(node.func, "attr", getattr(node.func, "id", ""))
            if name in ("manual_seed", "seed") and getattr(
                    node.func, "value", None) is not None and getattr(
                    node.func.value, "id", "") == "torch":
                bad.append((path.name, node.lineno, name))
            # torch.randn(...) and a tensor's in-place x.normal_(...);
            # numpy RandomStates (rs.randint) are explicit streams already
            owner = getattr(getattr(node.func, "value", None), "id", None)
            is_torch = owner == "torch" or name.endswith("_")
            if name in RANDOM_CALLS and is_torch and not any(
                    k.arg == "generator" for k in node.keywords):
                bad.append((path.name, node.lineno, name))
    assert not bad, bad


def _jax_exports(package: str) -> set:
    """The names a package of the JAX package re-exports from its
    ``__init__.py`` (read from its AST: this file imports no JAX)."""
    tree = ast.parse((REPO / "src" / "repro" / package / "__init__.py")
                     .read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return names


@pytest.mark.parametrize("package", ["algos", "core", "models", "telemetry",
                                     "train", "utils"])
def test_packages_reexport_jax_names(package):
    """Each of these port packages re-exports every name its JAX twin's
    ``__init__.py`` does."""
    import importlib
    mod = importlib.import_module(f"repro_torch.{package}")
    want = _jax_exports(package)
    assert want, package
    missing = sorted(n for n in want if not hasattr(mod, n))
    assert not missing, f"repro_torch.{package} lacks {missing}"
