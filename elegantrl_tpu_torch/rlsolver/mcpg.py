"""MCPG, Monte Carlo policy gradient for MaxCut (counterpart of
``elegantrl_tpu/rlsolver/mcpg.py``).

A per-node Bernoulli policy, ``(sigmoid(theta) - 0.5) 0.6 + 0.5``, drives
Metropolis chains toward its product distribution; the chains' samples get
the simulator's local search, and the policy ascends the advantage-weighted
log-likelihood of the searched samples (the gradient through autograd, the
step the optax-exact Adam of ``agents/base.py`` without a clip).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..agents.base import ClipAdam, clip_adam_
from ._draws import as_draws
from .maxcut import MaxCutSimulator, best_of


def _policy_probs(theta: torch.Tensor) -> torch.Tensor:
    """Per-node probability of a 1, squashed into [0.2, 0.8]."""
    return (torch.sigmoid(theta) - 0.5) * 0.6 + 0.5


def metro_sampling(probs: torch.Tensor, xs: torch.Tensor, gen, num_transfers: int,
                   draws=None) -> torch.Tensor:
    """Metropolis-Hastings toward the product Bernoulli ``probs``: each
    transfer, every chain proposes flipping one random node (``'node'``)
    and accepts with the odds ratio (``'accept'``)."""
    d = as_draws(gen, xs.device, draws)
    num_chains, num_nodes = xs.shape
    rows = torch.arange(num_chains, device=xs.device)
    for _ in range(int(num_transfers)):
        nodes = d.randint('node', num_nodes, (num_chains,))
        u = d.rand('accept', (num_chains,))
        p = probs[nodes]
        cur = xs[rows, nodes]
        q = torch.where(cur > 0.5, p, 1.0 - p)   # the probability of the current value
        accept = (u < (1.0 - q) / q).to(xs.dtype)
        xs = xs.clone()
        xs[rows, nodes] = torch.abs(cur - accept)
    return xs


def mcpg_solve(sim: MaxCutSimulator, gen, num_chains: int = 512, num_epochs: int = 30,
               num_transfers: int = 32, num_ls: int = 8, lr: float = 8e-2,
               draws=None) -> Tuple[float, torch.Tensor, dict]:
    """Returns ``(best_obj, best_solution, {'theta': theta})``.  Draws: the
    chains' start (``'rand_xs'``), then each epoch's transfers (``'node'``,
    ``'accept'``) and local-search sweeps (``'coin'``)."""
    d = as_draws(gen, sim.device, draws)
    theta = torch.zeros(sim.num_nodes, device=sim.device)
    opt = ClipAdam(float(lr), float('inf'))     # optax.adam: no clip
    mu, nu = torch.zeros_like(theta), torch.zeros_like(theta)
    xs = sim.rand_xs(d, num_chains)
    best_obj = torch.tensor(-float('inf'), device=sim.device)
    best_x = torch.zeros(sim.num_nodes, device=sim.device)
    for epoch in range(int(num_epochs)):
        xs = metro_sampling(_policy_probs(theta), xs, d, num_transfers)
        xs = sim.local_search_sweep(xs, d, num_sweeps=num_ls)
        objs = sim.obj(xs)
        best_obj, best_x = best_of(objs, xs, best_obj, best_x)
        adv = objs - torch.mean(objs)
        adv = adv / (torch.std(adv, unbiased=False) + 1e-6)
        th = theta.detach().requires_grad_(True)
        p = _policy_probs(th)
        logp = (xs * torch.log(p + 1e-9) + (1 - xs) * torch.log(1 - p + 1e-9)).sum(-1)
        grad, = torch.autograd.grad(-torch.mean(adv * logp), th)
        clip_adam_(opt, theta, mu, nu, grad, epoch + 1)
    return float(best_obj), best_x, {'theta': theta}
