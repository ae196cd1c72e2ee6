"""Advantage estimation (counterpart of ``elegantrl_tpu/ops/gae.py``).

All functions take time-major ``(H, N)`` tensors.  The recursions run as a
plain reverse loop over H; the V-trace one also as K10 on a card.  The
JAX package evaluates them with ``associative_scan`` at H >= 16, which
reassociates the f32 sums: the two agree to about 1e-5 relative at the
horizons of the tests.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .kernels import gae_vtrace_kernel, gae_vtrace_reference, vtrace_advantages_reference


def apply_truncation_bootstrap(rewards: torch.Tensor, undones: torch.Tensor,
                               unmasks: torch.Tensor, values: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """At truncated steps (unmask == 0) add V(s_t) to the reward and force
    undone to 0.  Returns (rewards', undones')."""
    truncated = 1.0 - unmasks
    return rewards + truncated * values, undones * unmasks


def gae_vtrace(rewards: torch.Tensor, undones: torch.Tensor, values: torch.Tensor,
               next_value: torch.Tensor, gamma: float, lam: float) -> torch.Tensor:
    """V-trace-style recursion:
    ``adv[t] = r[t] + m[t]*v[t+1] - v[t] + m[t]*lam*adv[t+1]`` with
    ``m = gamma*undone`` and ``v[H] = next_value``; the reverse loop,
    ``ops/kernels.py:gae_vtrace_reference``."""
    return gae_vtrace_reference(rewards, undones, values, next_value, gamma, lam)


def vtrace_advantages(rewards: torch.Tensor, undones: torch.Tensor, unmasks: torch.Tensor,
                      values: torch.Tensor, next_value: torch.Tensor, gamma: float, lam: float,
                      use_kernel: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The PPO advantage step before normalisation: the truncation bootstrap,
    the V-trace recursion and ``reward_sums = adv + v``; returns ``(adv,
    reward_sums)``.  With ``use_kernel`` (``config.py:select_kernel`` on
    ``use_gae_kernel``) all three are one K10 launch on a card
    (``ops/kernels.py:gae_vtrace_kernel``); else
    :func:`apply_truncation_bootstrap`, the reverse loop and the sum
    (``vtrace_advantages_reference``), which the kernel repeats operation by
    operation: the two are bitwise equal."""
    if use_kernel:
        return gae_vtrace_kernel(rewards.contiguous(), undones.contiguous(),
                                 unmasks.contiguous(), values.contiguous(),
                                 next_value.contiguous(), gamma, lam)
    return vtrace_advantages_reference(rewards, undones, unmasks, values, next_value, gamma, lam)


def gae_plain(rewards: torch.Tensor, undones: torch.Tensor, values: torch.Tensor,
              gamma: float, lam: float) -> torch.Tensor:
    """Plain-GAE variant: ``adv[t] = r[t] - v[t] + m[t]*carry``,
    ``carry = v[t] + lam*adv[t]``, carry starting at zero."""
    masks = undones * gamma
    advantages = torch.empty_like(rewards)
    carry = torch.zeros_like(values[0])
    for t in range(rewards.shape[0] - 1, -1, -1):
        adv = rewards[t] - values[t] + masks[t] * carry
        advantages[t] = adv
        carry = values[t] + lam * adv
    return advantages


def normalize_advantages(advantages: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``(adv - mean) / (adv[::4, ::4].std() + eps)`` with the unbiased
    (n-1) std of the strided sub-grid."""
    mean = torch.mean(advantages)
    sub = advantages[::4, ::4]
    n = sub.numel()
    sub_mean = torch.sum(sub) / n
    std = torch.sqrt(torch.sum(torch.square(sub - sub_mean)) / max(n - 1, 1))
    return (advantages - mean) / (std + eps)


def cumulative_returns(rewards: torch.Tensor, undones: torch.Tensor, next_value: torch.Tensor,
                       gamma: float) -> torch.Tensor:
    """Backward discounted returns ``ret[t] = r[t] + gamma * undone[t] *
    ret[t+1]`` seeded with ``ret[H] = next_value``."""
    masks = undones * gamma
    returns = torch.empty_like(rewards)
    ret = next_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        ret = rewards[t] + masks[t] * ret
        returns[t] = ret
    return returns
