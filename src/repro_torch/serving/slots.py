"""SlotCache: a slot-indexed KV cache over ``models/backbones.py``.

Port of ``repro/serving/slots.py``.  The continuous-batching engine keeps ONE
batch cache of ``n_slots`` sequences alive; requests come and go by *slot
surgery*, never by reshaping the batch:

- ``write_prefill_at(slot, prompt)``: run a **single-prompt** prefill at the
  largest *bucket* length <= prompt_len, teacher-force the remaining prompt
  tail through the single-slot decode step (exact: attention KV and
  rolling-window rings advance by the same recurrence decode uses), then
  copy the whole (1,)-batch cache into the batch cache at ``slot``.  The
  source cache is freshly allocated, so the copy overwrites EVERY position
  of the slot — a reused slot is bit-identical to a fresh one.
- ``reset_slot(slot)``: zero the slot (length and contents).  Retirement
  hygiene only — correctness never depends on it.

The port updates caches in place, so the JAX ``warmup`` trick of keeping a
reference to the old cache and restoring it does not work here: ``warmup``
ends with ``reset_all()`` instead, which zeroes every slot in place.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..models import backbones as bb
from ..models.config import ModelConfig

F32 = torch.float32

DEFAULT_BUCKETS = (8, 16, 24, 32, 48, 64)


def bucket_for(prompt_len: int, buckets: Sequence[int]) -> int:
    """Largest bucket <= prompt_len (prefill never sees pad tokens; the tail
    is advanced exactly)."""
    fit = [b for b in buckets if b <= prompt_len]
    if not fit:
        raise ValueError(f"prompt_len {prompt_len} below smallest bucket "
                         f"{min(buckets)}")
    return max(fit)


def family_extras(cfg: ModelConfig, batch: int, device):
    """The stub frontends' inputs, as JAX's: zero image-token embeddings
    (vlm) or frame embeddings (encdec) in bf16."""
    kw = {}
    if cfg.family == "vlm":
        kw["img"] = torch.zeros((batch, cfg.n_img_tokens, cfg.d_model),
                                dtype=torch.bfloat16, device=device)
    if cfg.family == "encdec":
        kw["enc_frames"] = torch.zeros((batch, cfg.enc_len, cfg.d_model),
                                       dtype=torch.bfloat16, device=device)
    return kw


def init_cache(cfg: ModelConfig, batch: int, max_context: int, *, device):
    """The serving cache of ``batch`` sequences, with cross K/V sized for
    the config's image tokens / encoder frames (JAX's ``init_cache(...,
    img_len=cfg.n_img_tokens, enc_len=cfg.enc_len)``)."""
    return bb.init_cache(cfg, batch, max_context, device=device,
                         img_len=cfg.n_img_tokens, enc_len=cfg.enc_len)


def _write_slot(cache, logits, cache1, logits1, slot: int) -> None:
    """Copy the (1,)-batch cache/logits into batch position ``slot``, in
    place.  Cache leaves carry batch at axis 1 ((n_sb, B, ...)),
    ``lengths`` at axis 0."""
    for name, dst in cache.items():
        src = cache1[name]
        if dst.dim() == 1:
            dst[slot] = src[0]
        else:
            dst[:, slot] = src[:, 0]
    logits[slot] = logits1[0]


class SlotCache:
    """Batch cache + the slot-surgery operations for one config."""

    def __init__(self, cfg: ModelConfig, n_slots: int, max_context: int, *,
                 device, buckets: Sequence[int] = DEFAULT_BUCKETS):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_context = max_context
        self.device = torch.device(device)
        self.buckets = tuple(sorted(set(buckets)))
        self.cache = None
        self.logits = None
        self.prefill_tokens = 0  # running count, for prefill tok/s
        self.reset_all()

    def _prefill_one(self, params, prompt):  # prompt: (1, bucket)
        cache1 = init_cache(self.cfg, 1, self.max_context, device=self.device)
        hidden, cache1 = bb.prefill(params, prompt, self.cfg, cache1,
                                    **family_extras(self.cfg, 1,
                                                     self.device))
        logits1 = bb.lm_logits(params, hidden, self.cfg)[:, -1].to(F32)
        return logits1, cache1

    def _advance_one(self, params, cache1, tok):  # tok: (1,) teacher-forced
        hidden, cache1 = bb.decode_step(params, cache1, tok, self.cfg)
        logits1 = bb.lm_logits(params, hidden, self.cfg)[:, 0].to(F32)
        return logits1, cache1

    # -- lifecycle ------------------------------------------------------------
    @torch.inference_mode()
    def reset_all(self) -> None:
        """Fresh batch cache + logits: zeroed in place once allocated, so
        the cache keeps its addresses (the engine's decode-block graph
        reads them)."""
        if self.cache is not None:
            for x in self.cache.values():
                x.zero_()
            self.logits.zero_()
            return
        self.cache = init_cache(self.cfg, self.n_slots, self.max_context,
                                device=self.device)
        self.logits = torch.zeros((self.n_slots, self.cfg.padded_vocab),
                                  dtype=F32, device=self.device)

    @torch.inference_mode()
    def write_prefill_at(self, params, slot: int, prompt: np.ndarray) -> None:
        """Prefill ``prompt`` single-sequence and install it at ``slot``."""
        plen = int(prompt.shape[0])
        if plen >= self.max_context:
            raise ValueError(f"prompt_len {plen} >= max_context "
                             f"{self.max_context}")
        b = bucket_for(plen, self.buckets)
        toks = torch.as_tensor(np.asarray(prompt, np.int32),
                               device=self.device)
        logits1, cache1 = self._prefill_one(params, toks[None, :b])
        for i in range(b, plen):  # exact tail advance (B=1)
            logits1, cache1 = self._advance_one(params, cache1, toks[i:i + 1])
        _write_slot(self.cache, self.logits, cache1, logits1, slot)
        self.prefill_tokens += plen

    @torch.inference_mode()
    def reset_slot(self, slot: int) -> None:
        for dst in self.cache.values():
            if dst.dim() == 1:
                dst[slot] = 0
            else:
                dst[:, slot] = 0
        self.logits[slot] = 0

    def lengths(self) -> np.ndarray:
        return self.cache["lengths"].cpu().numpy()

    def warmup(self, params) -> None:
        """Run every bucket prefill and the tail advance once (first CUDA
        launches, kernel build, library handles) before serving, then start
        from a fresh cache."""
        keep_count = self.prefill_tokens
        for i, b in enumerate(self.buckets):
            # smallest bucket warms the tail-advance path too (len b+1)
            dummy = np.zeros((b + 1 if i == 0 else b,), np.int32)
            self.write_prefill_at(params, 0, dummy)
        self.reset_all()
        self.prefill_tokens = keep_count
