"""Action distributions, port of the discrete half of
``repro/core/distributions.py`` (paper §6.1 'Distribution').

``Categorical`` (log-likelihood, entropy, KL, mode, sampling) and the
vector-valued ``EpsilonGreedy`` of Ape-X/R2D2 (per-env epsilon).  Sampling
draws from an explicit ``torch.Generator``; ``EpsilonGreedy.select`` takes
the uniforms and random actions themselves, so a test can hand both
frameworks the same draws.  ``Gaussian`` and ``SquashedGaussian`` wait for
the Q-value-policy-gradient slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


class Categorical:
    def __init__(self, dim: int):
        self.dim = dim

    def sample(self, generator, logits):
        # Gumbel-max, as jax.random.categorical
        u = torch.rand(logits.shape, generator=generator, device=logits.device,
                       dtype=logits.dtype)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        return torch.argmax(logits + gumbel, dim=-1)

    def log_likelihood(self, actions, logits):
        logp = F.log_softmax(logits, dim=-1)
        return torch.gather(logp, -1, actions.long()[..., None])[..., 0]

    def entropy(self, logits):
        logp = F.log_softmax(logits, dim=-1)
        return -torch.sum(torch.exp(logp) * logp, dim=-1)

    def kl(self, logits_p, logits_q):
        logp = F.log_softmax(logits_p, dim=-1)
        logq = F.log_softmax(logits_q, dim=-1)
        return torch.sum(torch.exp(logp) * (logp - logq), dim=-1)

    def mode(self, logits):
        return torch.argmax(logits, dim=-1)


class EpsilonGreedy:
    def __init__(self, dim: int):
        self.dim = dim

    @staticmethod
    def apex_epsilons(n_envs: int, base: float = 0.4, alpha: float = 7.0,
                      device="cpu"):
        """epsilon_i = base ** (1 + alpha * i / (N-1)); Ape-X eq. (1)."""
        i = torch.arange(n_envs, dtype=torch.float32, device=device)
        return base ** (1.0 + alpha * i / max(n_envs - 1, 1))

    @staticmethod
    def select(q_values, epsilon, u, rand):
        """The random action ``rand`` where ``u < epsilon``, else the greedy
        one.  epsilon: scalar or per-batch vector broadcast against the
        leading dims of q."""
        greedy = torch.argmax(q_values, dim=-1)
        eps = torch.as_tensor(epsilon, device=q_values.device)
        return torch.where(u < eps.expand(greedy.shape), rand.to(greedy.dtype),
                           greedy)

    def sample(self, generator, q_values, epsilon):
        shape = q_values.shape[:-1]
        dev = q_values.device
        u = torch.rand(shape, generator=generator, device=dev)
        rand = torch.randint(0, q_values.shape[-1], shape, generator=generator,
                             device=dev)
        return self.select(q_values, epsilon, u, rand)
