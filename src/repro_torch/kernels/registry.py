"""Kernel backend dispatch: which implementation serves each hot-path op.

Every hand-written kernel of the port has two runnable forms:

- ``ref``  — plain PyTorch ops (the model layers' own math); runs anywhere.
- ``cuda`` — the hand-written Hopper kernel behind the op's wrapper.  The
  wrapper launches it for CUDA tensors; for CPU tensors it computes the
  kernel's plain version (``attention_reference``, ``ssd_chunked``,
  ``sum_tree.sample_plain``), so the kernel call site stays testable on a
  machine without a GPU.  For ``sum_tree`` the two backends are also two
  algorithms, as in the JAX package: ``ref`` is the sum tree's pointer-walk
  update and fixed-depth descent, ``cuda`` the blocked update (plain
  PyTorch ops) and the blocked sampling kernel.

Selection is per-op via the ``REPRO_TORCH_KERNELS`` environment variable,
with the spec syntax of the JAX package's ``REPRO_KERNELS``::

    REPRO_TORCH_KERNELS=ref                      # every op
    REPRO_TORCH_KERNELS=attention=cuda,ssd=ref   # per-op
    REPRO_TORCH_KERNELS=ref,attention=cuda       # default + override

or programmatically with :func:`override`, whose scope is process-wide,
not per thread: autograd runs a CUDA backward -- and with it the recompute
of a checkpointed layer -- on a device thread of its own, which must see
the override its forward ran under.  The default is ``auto``: it
resolves to ``cuda`` for a CUDA tensor and to ``ref`` for a CPU tensor.  An
explicit ``ref`` on the card is allowed — it is a choice the launch entry
points echo in their "kernel backends:" line, never a silent fallback.

Every op of ``OPS`` is in ``PORTED``: each has its kernel and its call
sites in the port.  An op outside ``PORTED`` would resolve to ``unported``
whatever the spec says, and asking for ``op=cuda`` on it would raise.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from functools import lru_cache
from typing import Dict, Optional

import torch

OPS = ("attention", "ssd", "sum_tree")
PORTED = ("attention", "ssd", "sum_tree")
BACKENDS = ("ref", "cuda", "auto")
ENV = "REPRO_TORCH_KERNELS"

_OVERRIDES: list = []  # process-wide stack of parsed specs, innermost last


@lru_cache(maxsize=32)
def _parse(spec: str) -> Dict[str, str]:
    """``"ref"`` / ``"attention=cuda,ssd=ref"`` -> {op: backend}.

    A bare token sets the default for every op; ``op=backend`` tokens
    override per-op.  Unknown ops/backends raise immediately — a typo'd env
    var must not silently fall back to the reference path.
    """
    out: Dict[str, str] = {}
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "=" in tok:
            op, _, be = tok.partition("=")
            op, be = op.strip(), be.strip()
            if op not in OPS:
                raise ValueError(f"{ENV}: unknown op {op!r} (ops: {OPS})")
            if be not in BACKENDS:
                raise ValueError(f"{ENV}: unknown backend {be!r} for {op!r}")
            if be == "cuda" and op not in PORTED:
                raise ValueError(f"{ENV}: no CUDA kernel for {op!r} in the "
                                 f"port yet (ported: {PORTED})")
            out[op] = be
        else:
            if tok not in BACKENDS:
                raise ValueError(f"{ENV}: unknown backend {tok!r}")
            for op in OPS:
                out.setdefault(op, tok)
    return out


def backend_for(op: str, site: Optional[str] = None, *,
                device=None) -> str:
    """Resolved backend ('ref' | 'cuda') for ``op`` on ``device``, or
    'unported' for an op outside ``PORTED``.

    ``auto`` resolves from the device of the tensors the call site holds:
    ``cuda`` for a CUDA device, ``ref`` otherwise (and when no device is
    given).  ``site`` names the call site (e.g. ``"attention_train"``); when
    given, the resolution is reported as a ``kernel_dispatch`` telemetry
    event, once per tracer for each (op, site, backend)."""
    if op not in OPS:
        raise ValueError(f"unknown kernel op {op!r} (ops: {OPS})")
    be = "auto"
    env = os.environ.get(ENV, "")
    if env:
        be = _parse(env).get(op, "auto")
    for layer in _OVERRIDES:
        if op in layer:
            be = layer[op]
    if op not in PORTED:
        be = "unported"
    elif be == "auto":
        is_cuda = device is not None and torch.device(device).type == "cuda"
        be = "cuda" if is_cuda else "ref"
    if site is not None:
        from ..telemetry import trace

        tracer = trace.get_tracer()
        key = (op, site, be)
        if tracer.recording() and key not in tracer.dispatch_seen:
            tracer.dispatch_seen.add(key)
            tracer.emit("kernel_dispatch", f"{op}@{site}", op=op, site=site,
                        backend=be)
    return be


@contextmanager
def override(spec: str):
    """Scoped backend override, same syntax as the env var::

        with registry.override("ref"):
            ...  # call sites dispatch to the plain PyTorch math
    """
    _OVERRIDES.append(_parse(spec))
    try:
        yield
    finally:
        _OVERRIDES.pop()


def describe(device=None) -> Dict[str, str]:
    """Current resolved backend per op on ``device`` (for --kernels echo)."""
    return {op: backend_for(op, device=device) for op in OPS}


def set_env(spec: str) -> None:
    """Install ``spec`` as the process-wide selection (validates first).
    Used by the launch entry points' ``--kernels`` flag."""
    _parse(spec)  # validate
    os.environ[ENV] = spec
