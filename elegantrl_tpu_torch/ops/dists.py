"""Closed-form distribution math (counterpart of ``elegantrl_tpu/ops/dists.py``)."""

from __future__ import annotations

import math

import torch

LOG_SQRT_2PI = math.log(math.sqrt(2.0 * math.pi))


def normal_logprob(x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """Elementwise N(mean, std) log-density."""
    z = (x - mean) / std
    return -0.5 * torch.square(z) - torch.log(std) - LOG_SQRT_2PI


def normal_entropy(std: torch.Tensor) -> torch.Tensor:
    """Elementwise N(., std) entropy = 0.5 + 0.5*log(2*pi) + log(std)."""
    return 0.5 + LOG_SQRT_2PI + torch.log(std)


def normal_sample(gen: torch.Generator, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    z = torch.randn(mean.shape, generator=gen, device=mean.device, dtype=mean.dtype)
    return mean + std * z


def categorical_sample(gen: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=gen).reshape(probs.shape[:-1])


def categorical_logprob(logits: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, action[..., None].long())[..., 0]


def categorical_entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def tanh_normal_logprob_simple(mean: torch.Tensor, std: torch.Tensor,
                               pre_tanh: torch.Tensor) -> torch.Tensor:
    """The reference ``ActorSAC`` form: the Gaussian density evaluated at the
    mean (its quirk, kept) with the ``log(1 - tanh(x)^2 + 1e-6)`` correction,
    summed over the action axis."""
    logprob = normal_logprob(mean, mean, std)
    logprob = logprob - torch.log(1.000001 - torch.square(torch.tanh(pre_tanh)))
    return torch.sum(logprob, dim=-1)


def tanh_normal_logprob(log_std: torch.Tensor, noise: torch.Tensor,
                        pre_tanh: torch.Tensor) -> torch.Tensor:
    """The reference ``ActorFixSAC`` softplus form, stable for large ``|x|``:
    ``-log_std - noise^2/2 - log(sqrt(2 pi)) - 2 (log 2 - x - softplus(-2x))``
    with x the pre-tanh action, summed over the action axis."""
    logprob = -log_std - 0.5 * torch.square(noise) - LOG_SQRT_2PI
    logprob = logprob - 2.0 * (math.log(2.0) - pre_tanh
                               - torch.nn.functional.softplus(-2.0 * pre_tanh))
    return torch.sum(logprob, dim=-1)
