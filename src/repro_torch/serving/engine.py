"""In-flight (continuous) batching decode engine.

Port of ``repro/serving/engine.py``.  One decode block steps ALL ``n_slots``
sequences in lockstep; the host swaps requests in and out of slots *between*
blocks:

    admit: queue -> SlotCache.write_prefill_at(slot)   (bucketed prefill)
    step:  decode_block — ``block`` decode steps, on the card one replay of
           a CUDA graph of the block (JAX's one scan a block)
    retire: slots whose budget hit 0 (or emitted EOS) stop in-block via the
            carried active mask; the host releases them to the scheduler

Raggedness lives entirely in ``cache["lengths"]`` / ``kv_len`` masking
inside ``attention_decode`` and in the active mask (retired slots keep
stepping but are masked out of sampling and length bumps).

``mode="static"`` runs the SAME code but only admits when every slot is
free (gang/drain scheduling) — the fixed-batch baseline.

The block's state (the slot logits and cache, the active mask, the
remaining budgets) lives at fixed addresses (core/graphs.py): the host
writes the masks in before each block and reads the tokens, the emitted
mask and the new masks after it, as JAX's engine does.  ``graph=False``
runs the block eagerly, with the same tokens bit for bit.  One generator,
re-seeded at every ``run``, draws the samples.

Spans (``telemetry/trace.py``): ``engine.admit`` an admission (``rid``,
``slot``, ``prompt_len``) holding ``slots.prefill`` and ``slots.tail``
(``tokens`` each), and ``engine.block`` a block (``block``, ``active``
slots, counted only while the span records) holding the graph's
``graph.replay``.

The summary keeps every key of the JAX schema except ``recompile_events``:
eager PyTorch compiles nothing, so there is nothing to count.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.graphs import StepGraph
from ..models import backbones as bb
from ..models.config import ModelConfig
from ..telemetry.trace import NO_SPAN, span
from .scheduler import Scheduler
from .slots import DEFAULT_BUCKETS, SlotCache
from .workload import Request, summarize_requests

F32 = torch.float32


def sync(device) -> None:
    """Wait for the device's queued work (CUDA); nothing to wait for on CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def sample(logits, temperature: float, generator: Optional[torch.Generator]):
    """Greedy argmax at temperature 0, else a draw from softmax(logits/T)."""
    if temperature > 0:
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(logits, dim=-1)


def make_decode_block(cfg: ModelConfig, block: int, temperature: float,
                      eos_id: Optional[int]):
    """``block`` decode steps over the whole slot batch.

    decode_block(params, logits, cache, active, remaining, generator) ->
    (logits, cache, active, remaining, toks (block, n), emitted (block, n)).
    A slot finishes in-block (budget exhausted or EOS) and stops sampling /
    bumping lengths for the remaining steps of the block.  The cache's K/V
    tensors are updated in place.
    """

    @torch.inference_mode()
    def decode_block(params, logits, cache, active, remaining, generator):
        toks, emitted = [], []
        for _ in range(block):
            tok = sample(logits, temperature, generator)
            tok = torch.where(active, tok, 0).to(torch.int32)
            toks.append(tok)
            emitted.append(active)
            hidden, cache = bb.decode_step(params, cache, tok, cfg,
                                           active=active)
            logits = bb.lm_logits(params, hidden, cfg)[:, 0].to(F32)
            remaining = remaining - active.to(torch.int32)
            done = remaining <= 0
            if eos_id is not None:
                done = done | (tok == eos_id)
            active = active & ~done
        return (logits, cache, active, remaining, torch.stack(toks),
                torch.stack(emitted))

    return decode_block


class ContinuousBatchEngine:
    """Slot-based serving engine over one model; run() replays a trace."""

    def __init__(self, cfg: ModelConfig, params, *, n_slots: int,
                 max_context: int, device,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 decode_block: int = 4, temperature: float = 0.0,
                 eos_id: Optional[int] = None, max_queue: int = 256,
                 seed: int = 0, graph: bool = True):
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_queue = max_queue
        self.block = decode_block
        self.seed = seed
        self.device = torch.device(device)
        self.slots = SlotCache(cfg, n_slots, max_context, device=self.device,
                               buckets=buckets)
        self._decode_block = make_decode_block(cfg, decode_block, temperature,
                                               eos_id)
        self._gen = torch.Generator(device=self.device)
        self.blocks_run = 0
        self._block_fn = StepGraph(self._block_step, device=self.device,
                                   name="engine.decode_block") \
            if graph else self._block_step

    def _block_step(self, params, logits, cache, active, remaining,
                    generator):
        logits, cache, active, remaining, toks, emitted = self._decode_block(
            params, logits, cache, active, remaining, generator)
        return ((params, logits, cache, active, remaining, generator),
                (toks, emitted))

    def _run_block(self, active: np.ndarray, remaining: np.ndarray):
        """One decode block from the host's masks; returns the device's
        (active, remaining, toks (block, n), emitted (block, n)) and keeps
        the new slot logits and cache."""
        self.blocks_run += 1
        with span("engine.block", block=self.blocks_run) as sp:
            if sp is not NO_SPAN:
                sp.set(active=int(np.count_nonzero(active)))
            state, (toks, emitted) = self._block_fn(
                self.params, self.slots.logits, self.slots.cache,
                torch.as_tensor(active, device=self.device),
                torch.as_tensor(remaining, device=self.device), self._gen)
        _, self.slots.logits, self.slots.cache, act_d, rem_d, _ = state
        return act_d, rem_d, toks, emitted

    def warmup(self) -> None:
        """Run every bucket prefill, the tail advance and one decode block
        before serving (the block's first call: its graph's warm-up), then
        start from a fresh cache."""
        self.slots.warmup(self.params)
        self._gen.manual_seed(self.seed)
        z = np.zeros((self.n_slots,), np.int32)
        self._run_block(z.astype(bool), z)
        sync(self.device)
        self.slots.reset_all()

    # -- the serving loop -----------------------------------------------------
    def run(self, trace: List[Request], *, mode: str = "continuous",
            realtime: bool = True) -> dict:
        """Replay ``trace``; returns the summary metrics row (the serving
        schema: p50/p99 latency, TTFT, decode_tok_per_sec, ...).

        ``realtime=False`` treats all arrivals as immediate (offline batch)
        — useful for deterministic tests.
        """
        if mode not in ("continuous", "static"):
            raise ValueError(f"mode must be continuous or static, got {mode!r}")
        self.slots.reset_all()
        sched = Scheduler(self.n_slots, self.max_queue)
        pending = sorted(trace, key=lambda r: r.arrival_s)
        slot_req: List[Optional[Request]] = [None] * self.n_slots
        active = np.zeros(self.n_slots, bool)
        remaining = np.zeros(self.n_slots, np.int32)
        self._gen.manual_seed(self.seed)
        decode_s = prefill_s = 0.0
        valid_tokens = n_blocks = 0
        prefill_tok0 = self.slots.prefill_tokens
        i_next = 0
        t0 = time.perf_counter()

        def now() -> float:
            return time.perf_counter() - t0

        while i_next < len(pending) or sched.n_waiting or active.any():
            # arrivals up to the current clock
            while i_next < len(pending) and (
                    not realtime or pending[i_next].arrival_s <= now()):
                if not realtime:  # offline batch: whole trace present at t=0
                    pending[i_next].arrival_s = 0.0
                sched.submit(pending[i_next])
                i_next += 1
            # admission: continuous fills any free slot; static only admits
            # into an empty batch (the lockstep fixed-batch baseline)
            if mode == "continuous" or not active.any():
                while (pair := sched.admit()) is not None:
                    req, slot = pair
                    with span("engine.admit", rid=req.rid, slot=slot,
                              prompt_len=len(req.prompt)):
                        tp = time.perf_counter()
                        self.slots.write_prefill_at(self.params, slot,
                                                    req.prompt)
                        sync(self.device)
                        prefill_s += time.perf_counter() - tp
                        req.t_admitted = now()
                        req.tokens = []
                        slot_req[slot] = req
                        active[slot] = True
                        remaining[slot] = req.max_tokens
            if not active.any():
                if i_next < len(pending):  # idle until the next arrival
                    gap = pending[i_next].arrival_s - now()
                    if realtime and gap > 0:
                        time.sleep(min(gap, 0.02))
                continue

            td = time.perf_counter()
            act_d, rem_d, toks, emitted = self._run_block(active, remaining)
            toks = toks.cpu().numpy()          # (block, n_slots)
            emitted = emitted.cpu().numpy()    # (block, n_slots) bool
            decode_s += time.perf_counter() - td
            n_blocks += 1
            # copies: on the CPU .numpy() would alias the block's state
            new_active = np.array(act_d.cpu())
            remaining = np.array(rem_d.cpu())
            t_block = now()
            valid_tokens += int(emitted.sum())

            for s in range(self.n_slots):
                req = slot_req[s]
                if req is None:
                    continue
                out = toks[emitted[:, s], s]
                if out.size:
                    req.tokens.extend(out.tolist())
                    req.n_generated += int(out.size)
                    if req.t_first_token is None:
                        req.t_first_token = t_block
                if active[s] and not new_active[s]:  # retired this block
                    req.t_finished = t_block
                    req.tokens = np.asarray(req.tokens, np.int32)
                    slot_req[s] = None
                    sched.release(s)
            active = new_active

        wall = now()
        decode_slot_steps = n_blocks * self.block * self.n_slots
        return {
            "mode": mode,
            "n_requests": len(trace),
            "n_rejected": sched.n_rejected,
            **summarize_requests(trace),
            "generated_tokens": valid_tokens,
            "decode_tok_per_sec": valid_tokens / max(decode_s, 1e-9),
            "decode_step_ms": decode_s / max(n_blocks * self.block, 1) * 1e3,
            "prefill_tok_per_sec": (self.slots.prefill_tokens - prefill_tok0)
            / max(prefill_s, 1e-9),
            "slot_occupancy": valid_tokens / max(decode_slot_steps, 1),
            "wall_s": wall,
        }
