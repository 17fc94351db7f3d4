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

Above ``TABLE_MAX_VOCAB`` the (V, V) table cannot be held at all (gemma2's
V = 256 000 would take 262 GB, on the TPU as on the card), so the env keeps
no table: each step computes the B rows it reads, row r being
``log_softmax(temp * z_r)`` with z_r ~ N(0, 1) drawn from a counter-based
hash of (seed, r, column) (``chain_rows``).  That is a fixed random chain of
its own, a pure function of (seed, V), and costs B x V work a step with no
host sync.
"""
from __future__ import annotations

import torch

from ..core.spaces import Discrete
from .base import EnvInfo, EnvSpec

_ROW_BLOCK = 4096
# the largest vocabulary whose (V, V) f32 table the env holds: 17.2 GB
TABLE_MAX_VOCAB = 65_536
_MASK64 = (1 << 64) - 1


def _i64(c: int) -> int:
    """A 64-bit constant as the signed int64 torch stores."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _shr(z, s: int):
    """Logical right shift of an int64 tensor (torch's ``>>`` is
    arithmetic)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _splitmix64(z):
    """The splitmix64 finalizer on int64 tensors (wrapping products)."""
    z = (z ^ _shr(z, 30)) * _i64(0xBF58476D1CE4E5B9)
    z = (z ^ _shr(z, 27)) * _i64(0x94D049BB133111EB)
    return z ^ _shr(z, 31)


def chain_rows(rows, vocab: int, temp: float = 1.0, seed: int = 0):
    """Rows ``rows`` ((B,) int) of the table-free chain: (B, V) f32
    ``log_softmax(temp * z)``, z[r, c] ~ N(0, 1) by Box-Muller from two
    24-bit fields of splitmix64(key(seed) + r * V + c), on ``rows``' device
    with no host sync."""
    key = _i64((seed * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019) & _MASK64)
    cols = torch.arange(vocab, device=rows.device, dtype=torch.int64)
    h = _splitmix64(rows.to(torch.int64)[:, None] * vocab + cols + key)
    u1 = (_shr(h, 40).to(torch.float32) + 0.5) * 2.0 ** -24
    u2 = ((h >> 16) & 0xFFFFFF).to(torch.float32) * 2.0 ** -24
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * torch.pi * u2)
    return torch.log_softmax(temp * z, dim=1)


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
    if chain_logp is not None:
        chain = torch.as_tensor(chain_logp, dtype=torch.float32, device=device)
        if tuple(chain.shape) != (vocab, vocab):
            raise ValueError(f"chain_logp must be ({vocab}, {vocab}), got "
                             f"{tuple(chain.shape)}")
    elif vocab <= TABLE_MAX_VOCAB:
        chain = chain_log_probs(vocab, temp, seed, device=device)
    else:
        chain = None

    def transition_logp(tok, a):
        if chain is not None:
            return chain[tok.long(), a.long()]
        rows = chain_rows(tok, vocab, temp, seed)
        return torch.gather(rows, 1, a.long()[:, None])[:, 0]

    def _fresh(batch, generator):
        return torch.randint(0, vocab, (batch,), generator=generator,
                             device=device, dtype=torch.int32)

    def reset(batch: int, generator):
        tok = _fresh(batch, generator)
        s = {"tok": tok, "t": torch.zeros_like(tok)}
        return s, tok

    def step(state, action, generator):
        a = action.to(torch.int32)
        reward = transition_logp(state["tok"], a)
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
