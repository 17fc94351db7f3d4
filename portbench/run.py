"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``) on the card.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
      --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic mix,
metrics and limits are found by name from ``BENCHMARK.json`` and the files
under ``portbench/`` (see ``portbench/README.md``).  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the end-to-end metrics, or with ``--trace 1`` the
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, the card's
name and power limit, and last ``checks``, each number that decided
``correct`` beside its limit, which also end standard error.

The run exits non-zero and prints no result where no CUDA device is
available or fewer than the cell asks for, where the program cannot be
imported (a directory with the benchmark's files alone), and where the
JAX package or JAX itself was loaded into the process.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names the run may not hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CACHES = {"CUDA_CACHE_PATH": "cuda_cache", "TRITON_CACHE_DIR": "triton",
          "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": "inductor"}


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name, compared whole, is one of
    ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def prepare_env():
    """Fixed cache directories inside the checkout; the program's kernels
    on their default route; no library that would load JAX."""
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)
    os.environ.pop("REPRO_TORCH_KERNELS", None)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(HERE)):
        if p not in sys.path:
            sys.path.insert(0, p)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def emit(result) -> None:
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    prepare_env()
    from bench import spec
    bench = spec.load_benchmark()
    cell = spec.find_cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails where the program is absent)
    from bench import harness
    torch.cuda.set_device(0)
    result = harness.run_cell(bench, cell, args.seed, args.seconds,
                              args.trace, "cuda:0", T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
