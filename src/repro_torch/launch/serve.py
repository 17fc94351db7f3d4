"""Serving entry point of the PyTorch port: fixed-batch prefill+decode rounds,
and the continuous-batching (in-flight) service loop.

Port of ``repro/launch/serve.py``.  Two modes:

- default: fixed-batch rounds.  Prefill and decode run as separate
  phases so the service reports per-phase telemetry — prefill tokens/sec,
  decode tokens/sec, per-decode-step latency — through ``MetricsRegistry``
  (see :func:`timed_generate`).  Each phase is bracketed by
  ``torch.cuda.synchronize()``.  On the card each decode step is a replay
  of one CUDA graph (see :func:`make_phases`).
- ``--continuous``: replay a Poisson arrival trace of mixed-length requests
  through ``serving/engine.py`` and report p50/p99 request latency,
  time-to-first-token and decode tokens/sec (``serve.jsonl``); on the card
  each decode block is a replay of one CUDA graph.

``--arch`` defaults to ``mamba2-1.3b``, as in JAX; the other models are
the dense gemma2-2b, glm4-9b, phi3-mini-3.8b and granite-34b, the moe
qwen2-moe-a2.7b and mixtral-8x7b (attention, then a mixture of experts a
layer: capacity-bounded dispatch in the prefill, exact in the decode
step), the hybrid zamba2-7b (Mamba-2 layers and one shared attention
block, a KV cache a site), the vlm llama-3.2-vision-90b (cross layers over
``n_img_tokens`` image tokens) and the encdec whisper-medium (an encoder
over ``enc_len`` frames); the vision and audio frontends are stubs, zeros
of (B, n_img_tokens, D) / (B, enc_len, D) in bf16, as in JAX.  Entry
points run on ``--device cuda`` (the default), where every causal
self-attention call goes through the hand-written CUDA flash attention
kernel unless ``--kernels ref`` asks for the plain PyTorch math (the
encoder's and the cross layers' attention take the plain path, as in
JAX); ``--device cpu`` runs the plain versions.  An ssm model serves
without a kernel: its prefill passes the cache state, so the scan is the
plain chunked one, as in JAX, and its decode step is plain ops (so do the
hybrid's Mamba-2 layers).  ``--smoke`` (the default config) runs on the
card for every arch.  ``--full`` draws the published width and depth:
granite-34b (88 GB of bf16 weights), mixtral-8x7b (87 GB) and
llama-3.2-vision-90b (163 GB) need a depth cut to fit one 80 GB card,
which ``--layers`` gives.  ``--profile[=DIR]`` writes a ``torch.profiler``
Chrome trace with the serving spans annotated.

  PYTHONPATH=src python -m repro_torch.launch.serve --full \\
      --batch 8 --prompt-len 1024 --gen 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \\
      --full --batch 8 --prompt-len 1024 --gen 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \\
      --full --layers 8 --batch 8 --prompt-len 1024 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --full --continuous \\
      --requests 16 --rate 16 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
      --full --batch 8 --prompt-len 1024 --gen 64
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch llama-3.2-vision-90b --full --layers 20 --batch 8 \\
      --prompt-len 1024 --gen 64
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from ..configs import get_config, get_smoke_config
from ..core.graphs import StepGraph
from ..kernels import registry as kernel_registry
from ..models import backbones as bb
from ..serving import ContinuousBatchEngine, DEFAULT_BUCKETS, poisson_trace
from ..serving.engine import sample, sync
from ..serving.slots import family_extras, init_cache
from ..telemetry import trace
from ..telemetry.metrics import MetricsRegistry

F32 = torch.float32


def make_phases(cfg, batch: int, prompt_len: int, gen: int,
                temperature: float = 0.0, *, device, graph: bool = True):
    """(prefill, decode) pair.

    prefill(params, prompts) -> (last_logits, cache)
    decode(params, logits, cache, generator) -> (batch, gen) tokens

    Prefill is deterministic and takes no generator; sampling randomness
    belongs to decode alone.  Decode fills the cache in place.  Each decode
    step is one call of ``step`` on fixed state (logits, cache, the (batch,
    gen) token buffer and the step index ``t``, a device scalar); on a CUDA
    device with ``graph`` (the default) ``step`` is captured once in a CUDA
    graph (core/graphs.py) and replayed ``gen`` times a round, the
    counterpart of JAX's scan over ``gen``; ``graph=False`` calls it
    eagerly, with the same tokens bit for bit.  A round's prefill output is
    copied into the graph's state.  Prefill stays eager.
    """
    S = prompt_len + gen + 1
    toks = torch.zeros((batch, gen), dtype=torch.int32, device=device)
    t = torch.zeros((1,), dtype=torch.int64, device=device)

    @torch.inference_mode()
    def prefill(params, prompts):
        cache = init_cache(cfg, batch, S, device=device)
        hidden, cache = bb.prefill(params, prompts, cfg, cache,
                                   **family_extras(cfg, batch, device))
        logits = bb.lm_logits(params, hidden, cfg)[:, -1].to(F32)
        return logits, cache

    @torch.inference_mode()
    def step(params, logits, cache, toks, t, generator):
        tok = sample(logits, temperature, generator).to(torch.int32)
        hidden, cache = bb.decode_step(params, cache, tok, cfg)
        logits = bb.lm_logits(params, hidden, cfg)[:, 0].to(F32)
        toks.index_copy_(1, t, tok[:, None])
        return (params, logits, cache, toks, t + 1, generator), None

    stepper = StepGraph(step, device=device, name="serve.decode_step") \
        if graph else step

    held = [(toks, t)]   # the state's token buffer and step index

    @torch.inference_mode()
    def decode(params, logits, cache, generator):
        out, i = held[0]
        i.zero_()
        state = (params, logits, cache, out, i, generator)
        for _ in range(gen):
            state, _ = stepper(*state)
        held[0] = (state[3], state[4])
        return state[3].clone()  # (batch, gen)

    decode.step = stepper
    return prefill, decode


def timed_generate(prefill, decode, params, prompts, generator, *,
                   batch: int, prompt_len: int, gen: int, device):
    """One serving round with per-phase timing.

    Returns ``(tokens, metrics)`` where metrics is the serving telemetry
    schema: prefill_tok_per_sec, decode_tok_per_sec, decode_step_ms
    (per-step decode latency across the batch), latency_s (whole round),
    total_tok_per_sec.
    """
    tracer = trace.get_tracer()
    sync(device)
    t0 = time.perf_counter()
    with tracer.span("serve.prefill", tokens=batch * prompt_len):
        logits, cache = prefill(params, prompts)
        sync(device)
    t1 = time.perf_counter()
    with tracer.span("serve.decode", tokens=batch * gen):
        toks = decode(params, logits, cache, generator)
        sync(device)
    t2 = time.perf_counter()
    prefill_s, decode_s = t1 - t0, t2 - t1
    metrics = {
        "prefill_tok_per_sec": batch * prompt_len / max(prefill_s, 1e-9),
        "decode_tok_per_sec": batch * gen / max(decode_s, 1e-9),
        "decode_step_ms": decode_s / max(gen, 1) * 1e3,
        "latency_s": t2 - t0,
        "total_tok_per_sec": batch * (prompt_len + gen) / max(t2 - t0, 1e-9),
    }
    return toks, metrics


def make_prompts(cfg, batch: int, prompt_len: int, generator, device):
    return torch.randint(0, cfg.vocab, (batch, prompt_len), generator=generator,
                         device=device, dtype=torch.int32)


def _run_fixed(args, cfg, params, tracer, registry):
    """Fixed-batch prefill + decode rounds."""
    device = torch.device(args.device)
    gen_ = torch.Generator(device=device).manual_seed(args.seed + 1)
    prefill, decode = make_phases(cfg, args.batch, args.prompt_len, args.gen,
                                  args.temperature, device=device)
    toks = None
    for r in range(args.rounds):
        prompts = make_prompts(cfg, args.batch, args.prompt_len, gen_, device)
        toks, metrics = timed_generate(prefill, decode, params, prompts, gen_,
                                       batch=args.batch,
                                       prompt_len=args.prompt_len,
                                       gen=args.gen, device=device)
        registry.record(r, {"arch": args.arch, "device": str(device),
                            "batch": args.batch,
                            "prompt_len": args.prompt_len, "gen": args.gen,
                            **metrics})
        tracer.memory_snapshot(f"round_{r}")
    if toks is not None:  # --rounds 0 runs nothing — nothing to echo
        print(f"first seq: {toks[0][:8].tolist()}")
    return toks


def _run_continuous(args, cfg, params, tracer, registry):
    """Continuous-batching service: replay a Poisson trace, report the
    serving schema plus p50/p99 latency and TTFT."""
    n_slots = args.slots or args.batch
    buckets = [b for b in DEFAULT_BUCKETS if b <= args.prompt_len] or \
        [args.prompt_len]
    prompt_min = max(args.prompt_min, min(buckets))
    max_context = args.prompt_len + args.gen + 1
    engine = ContinuousBatchEngine(
        cfg, params, n_slots=n_slots, max_context=max_context,
        device=args.device, buckets=buckets, decode_block=args.decode_block,
        temperature=args.temperature, eos_id=args.eos_id,
        max_queue=args.max_queue, seed=args.seed)
    with tracer.span("serve.warmup"):
        engine.warmup()
    reqs = poisson_trace(args.seed, args.requests, args.rate,
                         prompt_len_range=(prompt_min, args.prompt_len),
                         max_tokens_range=(args.gen_min, args.gen),
                         vocab=cfg.vocab)
    with tracer.span("serve.continuous", requests=len(reqs)):
        summary = engine.run(reqs, mode="continuous")
    registry.record(0, {"arch": args.arch, "device": str(engine.device),
                        "slots": n_slots, "decode_block": args.decode_block,
                        **summary})
    tracer.memory_snapshot("continuous_done")
    return summary


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CUDA kernels run on 'cuda', "
                         "'cpu' runs the plain PyTorch versions")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to its first N layers (the port's "
                         "own flag, for archs whose weights exceed one "
                         "card at full depth; default: the config's)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-dir", default=None)
    # continuous-batching service flags
    ap.add_argument("--continuous", action="store_true",
                    help="replay a Poisson arrival trace through the "
                         "in-flight batching engine (serving/engine.py) "
                         "instead of fixed-batch rounds")
    ap.add_argument("--requests", type=int, default=16,
                    help="[continuous] number of requests in the trace")
    ap.add_argument("--rate", type=float, default=16.0,
                    help="[continuous] Poisson arrival rate, requests/sec")
    ap.add_argument("--slots", type=int, default=None,
                    help="[continuous] batch slots (default: --batch)")
    ap.add_argument("--decode-block", type=int, default=4,
                    help="[continuous] decode steps per block; slots swap "
                         "at block boundaries")
    ap.add_argument("--prompt-min", type=int, default=8,
                    help="[continuous] minimum prompt length in the trace")
    ap.add_argument("--gen-min", type=int, default=4,
                    help="[continuous] minimum generation budget")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="[continuous] retire a slot on this token id")
    ap.add_argument("--max-queue", type=int, default=256,
                    help="[continuous] admission cap: waiting requests "
                         "beyond this are rejected")
    ap.add_argument("--kernels", default=None,
                    help="kernel backend spec (REPRO_TORCH_KERNELS syntax: "
                         "'ref', 'cuda', 'attention=cuda', ...)")
    ap.add_argument("--profile", nargs="?", const="", default=None,
                    metavar="DIR",
                    help="write a torch.profiler Chrome trace into DIR "
                         "(default <log-dir>/profile)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           "pass --device cpu to run the plain versions")

    tracer = trace.configure(os.path.join(args.log_dir, "trace.jsonl")
                             if args.log_dir else None)
    registry = MetricsRegistry(args.log_dir, sinks=("console", "jsonl"),
                               jsonl_filename="serve.jsonl")
    if args.kernels:
        kernel_registry.set_env(args.kernels)
    print(f"kernel backends: {kernel_registry.describe(device)}")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    gen_ = torch.Generator(device=device).manual_seed(args.seed)
    params = bb.init_lm(cfg, device=device, generator=gen_)

    try:
        with trace.chrome_trace(args.profile, args.log_dir, device,
                                "serve_trace.json"):
            if args.continuous:
                out = _run_continuous(args, cfg, params, tracer, registry)
            else:
                out = _run_fixed(args, cfg, params, tracer, registry)
    finally:
        registry.close()
    return out


if __name__ == "__main__":
    main()
