"""Action distributions, port of ``repro/core/distributions.py`` (paper
§6.1 'Distribution').

``Categorical`` (log-likelihood, entropy, KL, mode, sampling), the diagonal
``Gaussian`` and the tanh-squashed ``SquashedGaussian`` of SAC, and the
vector-valued ``EpsilonGreedy`` of Ape-X/R2D2 (per-env epsilon).  Sampling
draws from an explicit ``torch.Generator`` in a thin wrapper over a pure
function of the draws themselves (``EpsilonGreedy.select``,
``Gaussian.sample_given``, ``SquashedGaussian.sample_with_logprob_given``),
so a test can hand both frameworks the same draws.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .narrtup import namedarraytuple

DistInfo = namedarraytuple("DistInfo", ["mean", "log_std"])
DistInfoStd = DistInfo  # alias, rlpyt naming
EPS = 1e-8


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


class Gaussian:
    """Diagonal Gaussian over (mean, log_std) (DDPG/TD3 target noise,
    PPO-continuous)."""

    def __init__(self, dim: int, min_std: float = 1e-6, clip=None):
        self.dim = dim
        self.min_std = min_std
        self.clip = clip  # optional action clip (DDPG/TD3 exploration)

    def _std(self, log_std):
        return torch.clamp(torch.exp(log_std), min=self.min_std)

    def sample_given(self, mean, log_std, noise):
        """The sample for standard-normal ``noise`` of ``mean``'s shape."""
        a = mean + self._std(log_std) * noise
        if self.clip is not None:
            a = torch.clamp(a, -self.clip, self.clip)
        return a

    def sample(self, generator, mean, log_std):
        return self.sample_given(mean, log_std, _normal(generator, mean))

    def log_likelihood(self, actions, mean, log_std):
        std = self._std(log_std)
        z = (actions - mean) / std
        return torch.sum(-0.5 * z ** 2 - torch.log(std)
                         - 0.5 * math.log(2 * math.pi), dim=-1)

    def entropy(self, mean, log_std):
        return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e),
                         dim=-1)

    def kl(self, mean_p, log_std_p, mean_q, log_std_q):
        var_p, var_q = torch.exp(2 * log_std_p), torch.exp(2 * log_std_q)
        return torch.sum(log_std_q - log_std_p
                         + (var_p + (mean_p - mean_q) ** 2) / (2 * var_q)
                         - 0.5, dim=-1)


class SquashedGaussian(Gaussian):
    """a = tanh(u), u ~ N(mean, std); the log-prob includes the tanh
    Jacobian in the stable form 2 (log 2 - u - softplus(-2u)), which stays
    finite where tanh(u) rounds to +-1 in f32."""

    def sample_with_logprob_given(self, mean, log_std, noise):
        u = mean + self._std(log_std) * noise
        logp = super().log_likelihood(u, mean, log_std)
        logp = logp - torch.sum(
            2.0 * (math.log(2.0) - u - F.softplus(-2.0 * u)), dim=-1)
        return torch.tanh(u), logp

    def sample_with_logprob(self, generator, mean, log_std):
        return self.sample_with_logprob_given(mean, log_std,
                                              _normal(generator, mean))

    def sample_given(self, mean, log_std, noise):
        return self.sample_with_logprob_given(mean, log_std, noise)[0]

    def mode(self, mean, log_std):
        return torch.tanh(mean)


def _normal(generator, like):
    return torch.randn(like.shape, generator=generator, device=like.device,
                       dtype=like.dtype)


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
