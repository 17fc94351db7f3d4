#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA device of compute capability 9.0 and the CUDA toolkit
(nvcc); imports nothing of JAX.  Phases, each of which raises on failure:

1. the card's name and power limit (nvidia-smi);
2. build every hand-written kernel from csrc/ (one nvcc per source, all at
   once) and print the build time and ptxas' register / spill report;
3. kernel phase: each kernel entry point against its plain PyTorch version
   (``attention_reference``) in bf16 on the card, within its own tolerance
   (``TOL``) at every shape the main path gives it: prefill at B 4, T 1024
   and ragged T 1000, H 8, Hkv 4, dh 256, causal, softcap 50, window 4096
   and 256, at the fixed-round shape (B 8, T 1024, local and global
   layers) and at the continuous run's bucketed B 1 prompts (T 8-64, one
   partial tile, local and global); decode at B 8, S 2048 with ragged
   kv_len, at the fixed-round shape (S 1089), and at the continuous run's
   B 8 slot batch and B 1 prompt-tail steps (S 97, ragged kv_len).  One
   case per entry point scales q by 20 so that the scores reach the
   softcap.  Sensitivity checks show that the tolerance would catch a
   dropped softcap, a window or causal edge off by one, and one key lost
   from kv_len.  Then the time of each at the fixed-round shape beside its
   plain version, its bound and one PyTorch library call
   (``scaled_dot_product_attention``, without softcap: not the same
   function, a yardstick only — the port never calls it);
4. slice phase, fixed rounds: full-width gemma2-2b with random bf16 weights
   from a seeded generator on the card, through ``repro_torch.launch.serve
   .main`` (batch 8, prompt 1024, gen 64, two rounds); both kernel entry
   points must launch.  The same weights and prompts then run once with the
   kernels and once with ``--kernels ref``: prefill's last logits and the
   first decode step's logits must agree within LOGIT_TOL, and the greedy
   tokens' agreement over 64 steps is printed;
5. slice phase, continuous: 16 Poisson requests over 8 slots (prompts 8-64,
   gen 4-32) through ``serve.main --continuous``; every request must get
   its max_tokens;
6. on the same weights, a ``torch.profiler`` pass measures the device's
   busy time per prefill and per decode step against the unprofiled wall
   time of the same work (the idle share) — last, since the profiler slows
   every later launch of the process;
7. the ``kernels`` JSON line (launch counts from phases 4-5, the largest
   error of phase 3, times), then ``{"ok": true, "device": {...}}`` last.
"""
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0
# |kernel - attention_reference| <= atol + rtol * |reference|, per entry
# point.  Decode keeps P in f32 like the plain version, so the two differ by
# at most one bf16 rounding of the output (rtol 2^-7 covers one ulp at any
# magnitude).  Prefill also rounds P to bf16 for the P.V product: up to
# 2^-9 of each p_i |v_i|, a few 1e-3 on rows of few keys whatever the
# output's size, so its atol is 8e-3 and its rtol two ulps.  The share of
# each bound that the kernels use on the H100 is in PERF.md.
TOL = {"flash_attn_fwd": (8e-3, 1.6e-2), "flash_attn_decode": (1e-3, 8e-3)}
# the continuous run's traffic (phase 5); its shapes are checked in phase 3
CONT = {"requests": 16, "slots": 8, "prompt_min": 8, "prompt_len": 64,
        "gen_min": 4, "gen": 32, "rate": 16.0}
# kernel route vs --kernels ref at full width, bf16 logits (|logit| <= 30
# after the softcap): both routes round attention to bf16 at other places
# and the difference passes through 26 layers of random weights.
LOGIT_TOL = 0.25
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
L2_BYTES = 50 * 2**20


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


if not (REPO / "src" / "repro_torch").is_dir():
    fail(f"src/repro_torch not found beside {Path(__file__).name}: run this "
         "from a checkout of the repository")
sys.path.insert(0, str(REPO / "src"))

import torch  # noqa: E402

if not torch.cuda.is_available():
    fail("torch.cuda.is_available() is false: this smoke run needs a GPU")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, registry  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_reference  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import backbones as bb  # noqa: E402
from repro_torch.serving import DEFAULT_BUCKETS, poisson_trace  # noqa: E402

DEV = torch.device("cuda")
BF16 = torch.bfloat16
TPU_KERNEL = "src/repro/kernels/flash_attention/flash_attention.py:99"
SOURCE = "src/repro_torch/csrc/flash_attention.cu"


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fns, iters: int = 20) -> float:
    """Mean device time of one call, cycling through ``fns`` (closures over
    input copies that together exceed L2, so each call finds its inputs
    cold as the model's next layer does)."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def copies_for(nbytes: int) -> int:
    return max(2, math.ceil(2 * L2_BYTES / max(nbytes, 1)))


def randn(*shape, gen):
    return torch.randn(shape, generator=gen, device=DEV, dtype=BF16)


def tol_share(got, want, tol) -> float:
    """Largest |got - want| / (atol + rtol |want|): above 1 fails."""
    atol, rtol = tol
    err = (got.float() - want.float()).abs()
    return float((err / (atol + rtol * want.float().abs())).max())


def check(entry, name, got, want):
    """Kernel output against its plain version; returns the max abs error
    and the share of the tolerance it used."""
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"{entry} {name}: non-finite kernel output")
    worst = float((got.float() - want.float()).abs().max())
    share = tol_share(got, want, TOL[entry])
    print(f"  {name}: max_abs_err {worst:.3e}, tolerance used {share:.3f}")
    if share > 1:
        fail(f"{entry} {name}: kernel disagrees with attention_reference "
             f"beyond atol {TOL[entry][0]} + rtol {TOL[entry][1]} (max abs "
             f"err {worst}, {share:.2f} x the tolerance)")
    return worst, share


def must_differ(entry, fault, wrong, want):
    """The check above would catch ``fault``: the plain version with that
    fault lies outside the tolerance."""
    share = tol_share(wrong, want, TOL[entry])
    print(f"  sensitivity: {fault} -> {share:.1f} x the tolerance")
    if share <= 1:
        fail(f"{entry}: the tolerance would not catch {fault}")


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def valid_pairs(T, S, causal, window):
    """(query, key) pairs the masks leave, per (batch row, head)."""
    q = torch.arange(T, device=DEV)[:, None]
    k = torch.arange(S, device=DEV)[None, :]
    m = torch.ones(T, S, dtype=torch.bool, device=DEV)
    if causal:
        m &= k <= q
    if window is not None:
        m &= k > q - window
    return int(m.sum())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain version, then times
# ---------------------------------------------------------------------------
def kernel_phase(cfg):
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    H, Hkv, dh, cap = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.softcap_attn
    errs = {"flash_attn_fwd": 0.0, "flash_attn_decode": 0.0}
    used = dict(errs)

    def record(entry, name, got, want):
        err, share = check(entry, name, got, want)
        errs[entry] = max(errs[entry], err)
        used[entry] = max(used[entry], share)

    def fwd_case(B, T, window, scale=1.0):
        q = randn(B, T, H, dh, gen=gen) * scale
        k, v = randn(B, T, Hkv, dh, gen=gen), randn(B, T, Hkv, dh, gen=gen)
        kw = dict(causal=True, window=window, softcap=cap)
        want = attention_reference(q, k, v, **kw)
        record("flash_attn_fwd", f"B{B} T{T} window {window}"
               + (f" q x{scale:g}" if scale != 1 else ""),
               ops.flash_attention(q, k, v, **kw), want)
        return q, k, v, kw, want

    print("kernel phase: flash_attn_fwd vs attention_reference (bf16, atol "
          f"{TOL['flash_attn_fwd'][0]} + rtol {TOL['flash_attn_fwd'][1]})")
    for B, T, window in ((4, 1024, 256), (4, 1000, 4096), (4, 1000, 256),
                         (8, 1024, cfg.window), (8, 1024, None)):
        fwd_case(B, T, window)
    q, k, v, kw, want = fwd_case(4, 1024, 4096)
    must_differ("flash_attn_fwd", "causal edge one key late",
                attention_reference(q, k, v, **{**kw, "q_offset": 1}), want)
    q, k, v, kw, want = fwd_case(4, 1024, 256)
    must_differ("flash_attn_fwd", "window one key wider",
                attention_reference(q, k, v, **{**kw, "window": 257}), want)
    # the continuous run's prefills: one prompt at each bucket
    for T in [b for b in DEFAULT_BUCKETS if b <= CONT["prompt_len"]]:
        for window in (cfg.window, None):
            fwd_case(1, T, window)
    fwd_case(1, 24, cfg.window, scale=20.0)
    q, k, v, kw, want = fwd_case(4, 1000, 256, scale=20.0)
    must_differ("flash_attn_fwd", "softcap skipped",
                attention_reference(q, k, v, **{**kw, "softcap": None}), want)

    print("kernel phase: flash_attn_decode vs attention_reference (bf16, atol "
          f"{TOL['flash_attn_decode'][0]} + rtol "
          f"{TOL['flash_attn_decode'][1]})")
    S_fixed = 1024 + 64 + 1
    S_cont = CONT["prompt_len"] + CONT["gen"] + 1  # serve's max_context
    ragged = [1, 37, 1089, 2048, 5, 500, 1500, 2047]
    slots = [1, 9, 24, 40, 57, 64, 96, 97]
    cases = [(8, 2048, ragged, 1.0),
             (8, S_fixed, torch.randint(1025, S_fixed, (8,), generator=gen,
                                        device=DEV).tolist(), 1.0),
             # the continuous run: the slot batch, then B 1 prompt-tail steps
             (8, S_cont, slots, 1.0), (1, S_cont, [9], 1.0),
             (1, S_cont, [33], 1.0), (1, S_cont, [64], 1.0),
             (8, 2048, ragged, 20.0), (8, S_cont, slots, 20.0)]
    for B, S, kvl, scale in cases:
        q = randn(B, 1, H, dh, gen=gen) * scale
        k, v = randn(B, S, Hkv, dh, gen=gen), randn(B, S, Hkv, dh, gen=gen)
        kv_len = torch.tensor(kvl, dtype=torch.int32, device=DEV)
        want = attention_reference(q, k, v, causal=False, softcap=cap,
                                   kv_len=kv_len)
        record("flash_attn_decode", f"B{B} S{S} kv_len {kvl}"
               + (f" q x{scale:g}" if scale != 1 else ""),
               ops.flash_attention_decode(q, k, v, kv_len, softcap=cap), want)
    must_differ("flash_attn_decode", "softcap skipped", attention_reference(
        q, k, v, causal=False, softcap=None, kv_len=kv_len), want)
    must_differ("flash_attn_decode", "last key of kv_len dropped",
                attention_reference(q, k, v, causal=False, softcap=cap,
                                    kv_len=torch.clamp(kv_len - 1, min=1)),
                want)

    timing = {}
    # prefill at the fixed-round shape (local layer, window 4096 >= T)
    B, T = 8, 1024
    nbytes = 2 * (2 * B * T * H * dh + 2 * B * T * Hkv * dh)
    sets = [(randn(B, T, H, dh, gen=gen), randn(B, T, Hkv, dh, gen=gen),
             randn(B, T, Hkv, dh, gen=gen)) for _ in range(copies_for(nbytes))]
    kw = dict(causal=True, window=cfg.window, softcap=cap)
    ms = time_ms([lambda s=s: ops.flash_attention(*s, **kw) for s in sets])
    plain = time_ms([lambda s=s: attention_reference(*s, **kw)
                     for s in sets[:2]], iters=4)
    lib = time_ms([lambda s=s: torch.nn.functional.scaled_dot_product_attention(
        s[0].transpose(1, 2), s[1].transpose(1, 2), s[2].transpose(1, 2),
        is_causal=True, enable_gqa=True) for s in sets])
    flops = 4 * dh * B * H * valid_pairs(T, T, True, cfg.window)
    timing["flash_attn_fwd"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                    shape=f"B{B} T{T} H{H} Hkv{Hkv} dh{dh} "
                                          f"causal window {cfg.window} "
                                          f"softcap {cap}",
                                    bound=bound_ms(nbytes, flops))
    # decode at the fixed-round shape: S 1089, kv_len of the 64 decode steps
    S = S_fixed
    kvl = torch.randint(1025, S, (B,), generator=gen, device=DEV)
    kv_len = kvl.to(torch.int32)
    n_kv = int(kvl.sum())
    nbytes = 2 * (2 * B * H * dh + 2 * n_kv * Hkv * dh) + 4 * B
    sets = [(randn(B, 1, H, dh, gen=gen), randn(B, S, Hkv, dh, gen=gen),
             randn(B, S, Hkv, dh, gen=gen))
            for _ in range(copies_for(2 * 2 * B * S * Hkv * dh))]
    mask = (torch.arange(S, device=DEV)[None, :] < kvl[:, None])[:, None, None]
    ms = time_ms([lambda s=s: ops.flash_attention_decode(*s, kv_len,
                                                         softcap=cap)
                  for s in sets], iters=50)
    plain = time_ms([lambda s=s: attention_reference(
        *s, causal=False, softcap=cap, kv_len=kv_len) for s in sets])
    lib = time_ms([lambda s=s: torch.nn.functional.scaled_dot_product_attention(
        s[0].transpose(1, 2), s[1].transpose(1, 2), s[2].transpose(1, 2),
        attn_mask=mask, enable_gqa=True) for s in sets], iters=50)
    flops = 4 * dh * H * n_kv
    timing["flash_attn_decode"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                       shape=f"B{B} S{S} H{H} Hkv{Hkv} dh{dh} "
                                             f"kv_len sum {n_kv} softcap {cap}",
                                       bound=bound_ms(nbytes, flops))
    for name, t in timing.items():
        print(f"  {name} [{t['shape']}]: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms "
              f"({t['bound'][1]}), library_ms (no softcap: not the same "
              f"function) {t['library_ms']:.4f} ms")
    return errs, used, timing


# ---------------------------------------------------------------------------
# phase 4: kernel route vs --kernels ref on the same weights and prompts
# ---------------------------------------------------------------------------
def kernel_vs_ref(cfg, params, prompts, gen):
    batch, prompt_len = prompts.shape
    prefill, decode = serve.make_phases(cfg, batch, prompt_len, gen,
                                        device=DEV)
    out, first_tok = {}, None
    for spec in ("cuda", "ref"):
        with registry.override(spec), torch.inference_mode():
            logits, cache = prefill(params, prompts)
            if first_tok is None:
                first_tok = torch.argmax(logits, -1).to(torch.int32)
            step_cache = {k: v.clone() for k, v in cache.items()}
            hidden, _ = bb.decode_step(params, step_cache, first_tok, cfg)
            step_logits = bb.lm_logits(params, hidden, cfg)[:, 0].float()
            del step_cache
            toks = decode(params, logits, cache, None)
            out[spec] = (logits, step_logits, toks)
        torch.cuda.synchronize()
    for i, what in enumerate(("prefill last-position logits",
                              "first decode step logits")):
        a, b = out["cuda"][i], out["ref"][i]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            fail(f"{what}: non-finite logits")
        if tuple(a.shape) != (batch, cfg.padded_vocab):
            fail(f"{what}: shape {tuple(a.shape)}")
        err = float((a - b).abs().max())
        print(f"  kernel vs ref, {what}: max abs diff {err:.4f} "
              f"(|logit| max {float(b.abs().max()):.3f}, tolerance {LOGIT_TOL})")
        if err > LOGIT_TOL:
            fail(f"{what}: kernel route and ref route differ by {err}")
    agree = float((out["cuda"][2] == out["ref"][2]).float().mean())
    first = float((out["cuda"][2][:, 0] == out["ref"][2][:, 0]).float().mean())
    print(f"  greedy-token agreement over {gen} steps: {agree:.4f} "
          f"(first step {first:.4f})")


def profile_phase(cfg, params, prompts, steps=8):
    """Device busy time per prefill and per decode step (torch.profiler,
    CUDA kernels only) against the unprofiled wall time of the same work:
    the idle share says how far the host holds the card back."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch, prompt_len = prompts.shape
    # the fixed rounds' cache length (gen 64); only `steps` of it are run
    prefill, _ = serve.make_phases(cfg, batch, prompt_len, 64, device=DEV)

    def run_prefill():
        return prefill(params, prompts)

    def run_decode(logits, cache):
        with torch.inference_mode():
            for _ in range(steps):
                tok = torch.argmax(logits, -1).to(torch.int32)
                hidden, cache = bb.decode_step(params, cache, tok, cfg)
                logits = bb.lm_logits(params, hidden, cfg)[:, 0].float()
        return logits

    def wall_ms(fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    # unprofiled walls first: once the profiler has run, CUPTI stays
    # attached and every later launch of the process is slower
    logits, cache = run_prefill()
    walls = {"prefill": wall_ms(run_prefill)[0],
             "decode": wall_ms(run_decode, logits, cache)[0] / steps}
    for phase in ("prefill", "decode"):
        logits, cache = run_prefill()
        fn, args, per = ((run_prefill, (), 1) if phase == "prefill"
                         else (run_decode, (logits, cache), steps))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_ms(fn, *args)
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        if not evs:
            print(f"  profile {phase}: device time not measured (the profiler "
                  "recorded no CUDA kernels)")
            continue
        busy = sum(e.self_device_time_total for e in evs) / 1e3 / per
        n = sum(e.count for e in evs) / per
        wall = walls[phase]
        top = sorted(evs, key=lambda e: -e.self_device_time_total)[:5]
        print(f"  profile {phase} (B{batch}, prompt {prompt_len}): wall "
              f"{wall:.3f} ms unprofiled, device busy {busy:.3f} ms "
              f"({n:.0f} kernels) per {'call' if per == 1 else 'step'}, "
              f"idle share {max(0.0, 1 - busy / wall):.3f}")
        for e in top:
            print(f"    {e.self_device_time_total / 1e3 / per:8.3f} ms "
                  f"x{e.count / per:.0f}  {e.key[:90]}")


def main() -> None:
    t_start = time.perf_counter()
    card = smi()
    print(card)
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        fail(f"compute capability {cap}, the kernels are built for sm_90a")
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    built = build.build()
    print(f"build: {len(built)} librar{'y' if len(built) == 1 else 'ies'} in "
          f"{time.perf_counter() - t0:.1f} s wall")
    for b in built.values():
        print(f"  {b.name}: {b.seconds:.1f} s nvcc; ptxas per entry point:")
        for ln in b.log.splitlines():
            if "Compiling entry function" in ln or "registers" in ln or \
                    "spill" in ln:
                print("   ", ln.replace("ptxas info    : ", "").strip()[:150])

    cfg = get_config("gemma2-2b")
    errs, used, timing = kernel_phase(cfg)

    with tempfile.TemporaryDirectory() as log_dir:
        print("slice phase: fixed rounds (full-width gemma2-2b, bf16)")
        ops.flash_attention.launches = 0
        ops.flash_attention_decode.launches = 0
        toks = serve.main(["--full", "--device", "cuda", "--batch", "8",
                           "--prompt-len", "1024", "--gen", "64", "--rounds",
                           "2", "--seed", str(SEED), "--log-dir", log_dir])
        fixed = {"flash_attn_fwd": ops.flash_attention.launches,
                 "flash_attn_decode": ops.flash_attention_decode.launches}
        print(f"  launches in the fixed rounds: {fixed}")
        if min(fixed.values()) == 0:
            fail(f"a kernel never launched on the fixed rounds: {fixed}")
        if tuple(toks.shape) != (8, 64) or int(toks.min()) < 0 or \
                int(toks.max()) >= cfg.padded_vocab:
            fail(f"fixed rounds: bad tokens {tuple(toks.shape)}")
        torch.cuda.empty_cache()
        params = bb.init_lm(cfg, device=DEV, generator=torch.Generator(
            device=DEV).manual_seed(SEED))  # the weights serve.main drew
        prompts = serve.make_prompts(  # and its first round's prompts
            cfg, 8, 1024, torch.Generator(device=DEV).manual_seed(SEED + 1),
            DEV)
        kernel_vs_ref(cfg, params, prompts, 64)
        torch.cuda.empty_cache()

        print(f"slice phase: continuous batching ({CONT['requests']} "
              f"requests, {CONT['slots']} slots)")
        args = ["--full", "--device", "cuda", "--continuous", "--seed",
                str(SEED), "--log-dir", log_dir]
        for key, val in CONT.items():
            args += ["--" + key.replace("_", "-"), str(val)]
        ops.flash_attention.launches = 0
        ops.flash_attention_decode.launches = 0
        summary = serve.main(args)
        cont = {"flash_attn_fwd": ops.flash_attention.launches,
                "flash_attn_decode": ops.flash_attention_decode.launches}
        print(f"  launches in the continuous run: {cont}")
        if min(cont.values()) == 0:
            fail(f"a kernel never launched on the continuous run: {cont}")
        n = CONT["requests"]
        trace = poisson_trace(
            SEED, n, CONT["rate"],
            prompt_len_range=(CONT["prompt_min"], CONT["prompt_len"]),
            max_tokens_range=(CONT["gen_min"], CONT["gen"]), vocab=cfg.vocab)
        want = sum(r.max_tokens for r in trace)
        if summary["n_finished"] != n or summary["generated_tokens"] != want:
            fail(f"continuous: {summary['n_finished']} finished, "
                 f"{summary['generated_tokens']} tokens, expected {n} / {want}")
        print(f"  p50 latency {summary['p50_latency_s']:.4f} s, p99 latency "
              f"{summary['p99_latency_s']:.4f} s, decode "
              f"{summary['decode_tok_per_sec']:.1f} tok/s, every request got "
              "its max_tokens")

    # last, because the profiler slows every later launch of the process
    print("profile: where the time goes (not the main path's counts)")
    profile_phase(cfg, params, prompts)
    # the main path is the fixed rounds plus the continuous run; the
    # kernel-vs-ref comparison between them does not count
    launches = {k: fixed[k] + cont[k] for k in fixed}
    kernels = []
    for name, t in timing.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": TPU_KERNEL, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"]})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
