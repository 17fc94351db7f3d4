"""Token MDP: the RLHF-style environment where the policy IS a language model.

Port of ``repro/envs/token_lm.py``.  A fixed random Markov chain over the
vocabulary plays "environment": the observation is the current token, the
action is the next token, and the reward is the log-probability of that
transition under the chain.  Batched action selection over this env is
exactly LM decoding.

The port's env is batched: ``reset(batch, generator)`` and
``step(state, action, generator)`` work on ``(B,)`` tensors with the same
auto-reset and reward ``chain_logp[tok, a]`` as the JAX env's ``vmap``.  The
chain is drawn from a ``torch.Generator`` seeded with ``seed`` on
``device`` (so it differs from JAX's ``PRNGKey(seed)`` chain), or passed in
as ``chain_logp``.  At a real vocabulary the chain is large (V = 50 280:
10.1 GB in f32), so its log-softmax is taken IN PLACE, in row blocks.
"""
from __future__ import annotations

import torch

from ..core.spaces import Discrete
from .base import EnvInfo, EnvSpec

_ROW_BLOCK = 4096


def chain_log_probs(vocab: int = 256, temp: float = 1.0, seed: int = 0, *,
                    device="cpu"):
    """The env's transition log-probs (V, V) f32: ``log_softmax(temp * z)``
    over rows, z ~ N(0, 1) from ``torch.Generator(device).manual_seed(seed)``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    chain = torch.empty((vocab, vocab), dtype=torch.float32, device=device)
    chain.normal_(generator=gen).mul_(temp)
    for r0 in range(0, vocab, _ROW_BLOCK):
        blk = chain[r0:r0 + _ROW_BLOCK]
        blk.sub_(torch.logsumexp(blk, dim=1, keepdim=True))
    return chain


def make_token_lm(vocab: int = 256, episode_len: int = 64, temp: float = 1.0,
                  seed: int = 0, *, device="cpu", chain_logp=None) -> EnvSpec:
    chain = (chain_log_probs(vocab, temp, seed, device=device)
             if chain_logp is None else torch.as_tensor(
                 chain_logp, dtype=torch.float32, device=device))
    if tuple(chain.shape) != (vocab, vocab):
        raise ValueError(f"chain_logp must be ({vocab}, {vocab}), got "
                         f"{tuple(chain.shape)}")

    def _fresh(batch, generator):
        return torch.randint(0, vocab, (batch,), generator=generator,
                             device=chain.device, dtype=torch.int32)

    def reset(batch: int, generator):
        tok = _fresh(batch, generator)
        s = {"tok": tok, "t": torch.zeros_like(tok)}
        return s, tok

    def step(state, action, generator):
        a = action.to(torch.int32)
        reward = chain[state["tok"].long(), a.long()]
        t = state["t"] + 1
        timeout = t >= episode_len
        done = timeout
        fresh = _fresh(a.shape[0], generator)
        tok = torch.where(done, fresh, a)
        t = torch.where(done, torch.zeros_like(t), t)
        info = EnvInfo(timeout=timeout, episode_step=t, terminal_obs=a)
        return {"tok": tok, "t": t}, tok, reward, done, info

    return EnvSpec(
        name="token_lm",
        reset=reset,
        step=step,
        observation_space=Discrete(vocab),
        action_space=Discrete(vocab),
        max_episode_steps=episode_len,
    )
