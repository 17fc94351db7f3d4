"""The batch-generation cell: the program's ``ContinuousBatchEngine.run``
over a queue deeper than the window can serve, all queued at t = 0,
greedy: a bulk job.

Set-up makes the weights from the seed in the served dtype, builds the
engine, runs its warm-up (each bucket's prefill, the prompt tail's
advance, one decode block) and one short request, so the decode block's
graph is captured before the window.  Then ``run`` starts over the whole
queue.  It first admits a request into every slot, one eager admission
each; that fill is the last of set-up.  The window opens with the first
decode block and closes at the end of the first block that ends
``--seconds`` later: the benchmark's wrapper of the engine's block then
ends ``run``, with the queue still waiting.  Inside the window the wrapper
times each block and each admission (both end synchronised, as the
engine's own timings do) and counts the tokens the blocks emit.  With
``--trace 1`` the profiler then records ``trace_blocks`` more blocks, with
the slots' lengths read before and after each, which the decode
attention's roofline needs; the window itself runs unprofiled.  Once the
engine is freed, the reference runs over a sample of the requests the
window finished, drawn from the seed with the longest among them, and
judges every token served to them by how far its reference logit lies
below the reference's best at its position.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from reference import compare
from reference.lm import RefLM, exact_f32

from . import arith
from . import traffic as TR
from . import weights as W
from .devtrace import DeviceTrace
from .ppo import note, sync


def build(ctx):
    from repro_torch.models import backbones as bb
    from repro_torch.models.config import ModelConfig
    from repro_torch.serving.engine import ContinuousBatchEngine
    from repro_torch.serving.workload import Request

    mix, dev = ctx.mix, ctx.device
    cfg = ModelConfig(**ctx.model)
    dt = getattr(torch, cfg.compute_dtype)
    shapes = W.leaf_shapes(bb.LM(cfg, device="meta", dtype=dt))
    weights = W.make_weights(shapes, ctx.model, ctx.seed, dev)
    lm = bb.LM(cfg, device="meta", dtype=dt)
    W.install(lm, weights, False)
    specs = TR.make_requests(mix, ctx.seconds, ctx.seed, cfg.vocab)
    engine = ContinuousBatchEngine(
        cfg, lm, n_slots=mix["slots"], max_context=mix["max_context"],
        device=dev, buckets=tuple(mix["buckets"]),
        decode_block=mix["decode_block"], temperature=0.0,
        max_queue=len(specs), seed=W.sub_seed(ctx.seed, 3))
    note(ctx, "weights made")
    engine.warmup()
    b0 = min(mix["buckets"])
    engine.run([Request(rid=-1, prompt=np.zeros((b0 + 1,), np.int32),
                        max_tokens=2 * mix["decode_block"])],
               realtime=False)
    note(ctx, "engine warmed up")
    reqs = [Request(rid=r.rid, prompt=r.prompt, max_tokens=r.max_tokens)
            for r in specs]
    return cfg, weights, engine, reqs


class WindowClosed(Exception):
    """Raised by the block wrapper to end ``run`` when the window closes."""


class Window:
    """Wraps the engine's decode block and admission for one ``run``.

    Admissions before the first block are the fill (set-up).  The first
    block opens the window; the first block that ends ``seconds`` after
    that closes it.  In between: each block's and each admission's
    synchronised wall, the tokens the blocks emit, the prompt tokens
    admitted.  Without a ``trace`` the close raises ``WindowClosed``.
    With one, the profiler starts at the close and records
    ``trace_blocks`` more blocks, each in a ``decode_block`` span with the
    slots' lengths read around it, and the admissions between them in
    ``admit`` spans; then ``WindowClosed``.  So the window itself runs
    unprofiled in every run."""

    def __init__(self, engine, seconds, trace=None, trace_blocks=0):
        self.engine, self.seconds = engine, seconds
        self.trace, self.trace_blocks = trace, trace_blocks
        self.t0 = self.t_end = None
        self.blocks = self.emitted = 0
        self.block_s = self.admit_s = 0.0
        self.admits = self.admit_tokens = 0
        self.traced = None          # blocks profiled, once the window closed
        self.lengths = []           # (before, after) a profiled block
        self.marks = []             # (seconds into the window, tokens)
        self._block = engine._run_block
        self._admit = engine.slots.write_prefill_at
        engine._run_block = self.block
        engine.slots.write_prefill_at = self.admit

    def admit(self, params, slot, prompt):
        if self.traced is not None:
            with self.trace.span("admit"):
                return self._admit(params, slot, prompt)
        if self.t0 is None:
            return self._admit(params, slot, prompt)
        ta = time.perf_counter()
        out = self._admit(params, slot, prompt)
        sync(self.engine.device)
        self.admit_s += time.perf_counter() - ta
        self.admits += 1
        self.admit_tokens += int(prompt.shape[0])
        return out

    def block(self, active, remaining):
        if self.traced is not None:
            return self._profiled(active, remaining)
        dev = self.engine.device
        if self.t0 is None:
            sync(dev)
            self.t0 = time.perf_counter()
        tb = time.perf_counter()
        out = self._block(active, remaining)
        sync(dev)
        t = time.perf_counter()
        self.block_s += t - tb
        self.blocks += 1
        self.emitted += int(out[3].sum())
        self.marks.append((t - self.t0, self.emitted))
        if t - self.t0 >= self.seconds:
            self.t_end = t
            if self.trace is None or self.trace_blocks <= 0:
                raise WindowClosed
            self.traced = 0
            self.trace.start()
        return out

    def _profiled(self, active, remaining):
        lens = self.engine.slots.cache["lengths"]
        before = lens.cpu().numpy().copy()
        with self.trace.span("decode_block"):
            out = self._block(active, remaining)
        after = self.engine.slots.cache["lengths"].cpu().numpy().copy()
        self.lengths.append((before, after))
        self.traced += 1
        if self.traced >= self.trace_blocks:
            raise WindowClosed
        return out

    def close(self):
        """End time of a run whose queue drained first, the profiler
        stopped, and the engine's own methods back."""
        if self.t_end is None:
            sync(self.engine.device)
            self.t_end = time.perf_counter()
        if self.traced is not None:
            self.trace.stop()
        self.engine._run_block = self._block
        self.engine.slots.write_prefill_at = self._admit
        self.engine = self._block = self._admit = None


def attn_bound(cfg, block, lengths):
    """(seconds, launches) the decode attention's roofline allows over the
    profiled blocks: each step of a block launches the kernel once a
    shared-attention site over every slot, at kv_len = the slot's length
    before the step + 1."""
    sites = cfg.n_layers // cfg.attn_every
    total, launches = 0.0, 0
    for before, after in lengths:
        bumps = after - before
        for j in range(block):
            n_kv = int(np.sum(before + 1 + np.minimum(j, bumps)))
            t, _ = arith.bound_s(
                arith.decode_attn_bytes(len(before), cfg.n_heads,
                                        cfg.n_kv_heads, cfg.d_head, n_kv),
                arith.decode_attn_flops(cfg.n_heads, cfg.d_head, n_kv))
            total += sites * t
            launches += sites
    return total, launches


def sample(ctx, reqs):
    """The requests the reference judges: the longest and
    ``check_requests - 1`` others drawn from the seed."""
    rng = np.random.Generator(np.random.PCG64(W.sub_seed(ctx.seed, 4)))
    longest = max(range(len(reqs)), key=lambda i: reqs[i].max_tokens)
    rest = [i for i in range(len(reqs)) if i != longest]
    k = min(ctx.mix["check_requests"] - 1, len(rest))
    return [longest] + sorted(rng.choice(rest, size=k, replace=False)
                              .tolist())


def reference_logits(cfg_fields, weights, seqs, prec, device):
    """{request: (n, V) f32 logits at the positions that produced its n
    served tokens}, the model run a layer at a time over every sequence
    (prompt + served tokens but the last)."""
    lm = RefLM(cfg_fields, weights, prec)
    out = {}
    with torch.no_grad(), exact_f32():
        xs = {i: lm.embed(torch.as_tensor(toks, device=device)[None])
              for i, (toks, _) in seqs.items()}
        for fn, pre in lm.blocks():
            for i in xs:
                xs[i] = fn(xs[i], pre)
        for i, (toks, n) in seqs.items():
            h = lm.final(xs[i][:, -n:])
            out[i] = lm.logits(h)[0]
    return out


def token_gaps(logits, served):
    """(gap, rank) of each served token: how far its reference logit lies
    below the reference's best at its position, and its place in the
    reference's order (1 = the best)."""
    tok = torch.as_tensor(served).to(logits.device).long()
    mine = logits.gather(1, tok[:, None])
    gap = logits.max(dim=-1).values - mine[:, 0]
    rank = (logits > mine).sum(dim=-1) + 1
    return gap.cpu(), rank.cpu()


def judge_served(ctx, weights, reqs, chosen, prec="f32"):
    """[(gap, rank) a chosen request] of its served tokens against the
    float32 reference; with ``prec`` below it, of the tokens that the
    reference in that precision puts first at the same positions (the
    control)."""
    seqs = {}
    for i in chosen:
        r = reqs[i]
        toks = np.concatenate([r.prompt, r.tokens[:-1]]).astype(np.int64)
        seqs[i] = (toks, len(r.tokens))
    ref = reference_logits(ctx.model, weights, seqs, "f32", ctx.device)
    if prec == "f32":
        return [token_gaps(ref[i], reqs[i].tokens) for i in chosen]
    low = reference_logits(ctx.model, weights, seqs, prec, ctx.device)
    return [token_gaps(ref[i], low[i].argmax(-1)) for i in chosen]


def served_numbers(stats):
    """The number a served sample is judged by: the root mean square of
    the served tokens' gaps.  Rounding flips only near-ties, so the square
    grows fast with the error of the logits, and one token the reference
    ranks far down moves it alone."""
    gaps = torch.cat([g for g, _ in stats])
    return {"served_gap_rms": float(gaps.square().mean().sqrt())}


def served_diagnostics(stats):
    """What the number leaves out, for the readings that set limits."""
    gaps = torch.cat([g for g, _ in stats])
    return {"widest_gap": float(gaps.max()), "mean_gap": float(gaps.mean()),
            "flip_share": float((gaps > 0).float().mean()),
            "worst_rank": max(int(r.max()) for _, r in stats),
            "tokens": int(gaps.numel())}


def serve(ctx, engine, reqs):
    """One ``run`` of the engine over the queue, ended by the window (and
    with ``--trace 1`` the profiled blocks after it); returns the
    ``Window`` with its readings."""
    trace = DeviceTrace(ctx.device) if ctx.trace else None
    win = Window(engine, ctx.seconds, trace, ctx.mix["trace_blocks"])
    # set-up's objects out of the collector's way: no pass over them
    # inside the window
    gc.collect()
    gc.freeze()
    try:
        engine.run(reqs, realtime=False)
        note(ctx, "the queue drained before the window closed")
    except WindowClosed:
        pass
    finally:
        win.close()
        gc.unfreeze()
    return win


def quarter_rates(marks, wall):
    """Tokens a second in each quarter of the window, from the blocks'
    (end, tokens so far): how steady a run is inside itself."""
    out, prev_t, prev_n = [], 0.0, 0
    for q in (0.25, 0.5, 0.75, 1.0):
        t, n = next(((t, n) for t, n in marks if t >= q * wall - 1e-9),
                    marks[-1] if marks else (0.0, 0))
        out.append(round((n - prev_n) / max(t - prev_t, 1e-9), 2))
        prev_t, prev_n = t, n
    return out


def finished(reqs):
    """The requests the window finished: retired by a block before it
    closed."""
    return [r for r in reqs if r.t_finished is not None]


def run(ctx):
    mix = ctx.mix
    cfg, weights, engine, reqs = build(ctx)
    note(ctx, "built and warmed up")
    win = serve(ctx, engine, reqs)
    setup_s = win.t0 - ctx.t_process
    wall = win.t_end - win.t0
    steps = win.blocks * mix["decode_block"]
    note(ctx, f"window {wall:.3f} s: {win.blocks} blocks, {win.emitted} "
              f"tokens, {win.admits} admissions; fill and set-up "
              f"{setup_s:.2f} s")
    peak = torch.cuda.max_memory_allocated(ctx.device) \
        if ctx.device.type == "cuda" else 0
    done = finished(reqs)
    short = [r for r in done if len(r.tokens) != r.max_tokens]
    counters = {
        "requests": win.admits, "wall_s": wall, "generated": win.emitted,
        "admit_s": win.admit_s,
        "decode_step_ms": win.block_s / steps * 1e3 if steps else None,
        "slot_occupancy": win.emitted / (steps * mix["slots"])
        if steps else None,
        "model_flops": 2 * ctx.token_params * (win.admit_tokens
                                               + win.emitted),
    }
    note(ctx, f"slot occupancy {counters['slot_occupancy']}, admissions "
              f"{win.admit_s:.3f} s of the window; tokens/s a quarter "
              f"{quarter_rates(win.marks, wall)}")
    if win.lengths:
        counters["attn_bound_s"], counters["attn_launches"] = attn_bound(
            cfg, mix["decode_block"], win.lengths)
    # the reference runs once the engine and its caches are freed
    del engine
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ok_n = [r for r in done if len(r.tokens) == r.max_tokens]
    if ok_n:
        values = served_numbers(judge_served(ctx, weights, ok_n,
                                             sample(ctx, ok_n)))
    else:
        values = {k: float("inf") for k in ctx.limits}
    values["short_requests"] = float(len(short))
    note(ctx, "reference done")
    ok, checks = compare.judge(values, ctx.limits)
    return {
        "e2e": {"gen_tok_per_s": win.emitted / wall, "setup_s": setup_s},
        "rec": {"spans": {}, "counters": counters, "trace": win.trace},
        "attempted": len(done), "failed": len(short),
        "correct": ok and not short and bool(done), "checks": checks,
        "memory_peak_bytes": peak,
        "trace_window": win.trace.window("decode_block")
        if win.trace is not None else None,
    }
