"""Build the hand-written CUDA kernels into shared libraries with ``nvcc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own into ``build/repro_torch_kernels/lib<name>-<digest>.so`` at the root of
the checkout, where ``<digest>`` hashes the source and the flags, so an
edited source is rebuilt and an unchanged one is reused.  The wrappers load
the library with ``ctypes``.  Nothing here runs at import time: the first
wrapper call (or ``build()``) compiles, and ``build()`` starts one ``nvcc``
per source, all at once.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("flash_attention", "ssd_scan", "sum_tree")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Built:
    name: str
    path: Path
    seconds: float   # compile time; 0.0 when the library was already built
    log: str         # nvcc / ptxas output (registers, shared memory, spills)


def nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then $PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha1(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, Built]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together; raise with the
    compiler's output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, Built] = {}
    procs = {}
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = Built(name, path, 0.0, "")
            continue
        # unique temporary output, renamed into place: a concurrent process
        # never loads a half-written library
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       path, tmp, time.perf_counter())
    errors = []
    for name, (proc, path, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):"
                          f"\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = Built(name, path, time.perf_counter() - t0, log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out
