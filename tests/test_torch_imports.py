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


@pytest.mark.parametrize("entry", ["serve", "train"])
def test_smoke_on_cuda_is_rejected_before_any_weight(entry):
    """A smoke config whose path needs a kernel instance the card lacks is
    refused by the entry point's own check, naming the instance, --full and
    --device cpu: gemma2's (attention d_head 16) in both entry points,
    mamba2's (SSD P 16, N 16, chunk 8) in training.  --full on CUDA and the
    smoke config on the CPU pass it."""
    import importlib
    mod = importlib.import_module(f"repro_torch.launch.{entry}")
    parse = mod.build_parser().parse_args
    refused = [["--arch", "gemma2-2b"]]
    if entry == "train":
        refused += [[], ["--arch", "mamba2-1.3b"]]
    for argv in refused:
        with pytest.raises(ValueError) as err:
            mod.reject_smoke_on_cuda(parse(argv))
        msg = str(err.value)
        assert "--full" in msg and "--device cpu" in msg
        assert ("d_head 16" in msg) != ("P 16, N 16, chunk 8" in msg)
        with pytest.raises(ValueError, match="--smoke runs only on the CPU"):
            mod.reject_smoke_on_cuda(parse(["--device", "cuda:0", "--smoke"]
                                           + argv))
        mod.reject_smoke_on_cuda(parse(["--full"] + argv))
        mod.reject_smoke_on_cuda(parse(["--device", "cpu"] + argv))
        mod.reject_smoke_on_cuda(parse(["--device", "cpu", "--full"] + argv))


def test_serve_smoke_mamba2_is_not_refused_on_cuda():
    """Smoke mamba2 serving runs no kernel (its prefill takes the plain
    scan, its decode step plain ops), so serve's default arch passes the
    check on a CUDA device."""
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args([])
    assert args.arch == "mamba2-1.3b" and args.smoke and args.device == "cuda"
    serve.reject_smoke_on_cuda(args)


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
