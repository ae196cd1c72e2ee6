"""Cardinality-constrained portfolio selection simulator (counterpart of
``elegantrl_tpu/rlsolver/portfolio.py``).

Markowitz selection of exactly ``k`` assets maximizing ``mu.x - lam x'Sx``
with a quadratic cardinality penalty, the standard QUBO form.  The
quadratic term and the exact flip gains are one covariance product a
sweep, every sim at once.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ._draws import as_draws, solver_device


class PortfolioSimulator:
    """max mu.x - lam x'Sx - penalty (sum x - k)^2  over x in {0,1}^n."""

    def __init__(self, mu: np.ndarray, sigma: np.ndarray, k: int, risk_lambda: float = 1.0,
                 penalty: float = None, device=None):
        self.device = solver_device(device, type(self).__name__)
        self.mu = torch.as_tensor(np.asarray(mu), dtype=torch.float32, device=self.device)
        self.sigma = torch.as_tensor(np.asarray(sigma), dtype=torch.float32,
                                     device=self.device)          # (n, n) symmetric PSD
        self.k = int(k)
        self.lam = float(risk_lambda)
        self.num_nodes = int(self.mu.shape[0])
        if penalty is None:
            penalty = float(np.max(np.abs(np.asarray(mu)))) + 1.0
        self.penalty = float(penalty)
        self.if_maximize = True

    def rand_xs(self, gen, num_sims: int, draws=None) -> torch.Tensor:
        """Random selections, each asset in with probability ``k / n`` (draw
        ``'rand_xs'``)."""
        p = self.k / max(self.num_nodes, 1)
        return as_draws(gen, self.device, draws).bernoulli('rand_xs', p,
                                                           (num_sims, self.num_nodes))

    def obj(self, xs: torch.Tensor) -> torch.Tensor:
        risk = torch.sum((xs @ self.sigma) * xs, dim=-1)
        card = torch.square(torch.sum(xs, dim=-1) - self.k)
        return xs @ self.mu - self.lam * risk - self.penalty * card

    def flip_gains(self, xs: torch.Tensor) -> torch.Tensor:
        """The exact objective delta of flipping each asset, every sim: the
        risk moves by ``+-2 (Sigma x)_j + Sigma_jj`` (Sigma symmetric)."""
        sign = 1.0 - 2.0 * xs
        sx = xs @ self.sigma                            # (S, n)
        diag = torch.diagonal(self.sigma)[None, :]
        d_risk = sign * 2.0 * sx + diag
        n_sel = torch.sum(xs, dim=-1, keepdim=True)
        d_card = torch.square(n_sel + sign - self.k) - torch.square(n_sel - self.k)
        return sign * self.mu[None, :] - self.lam * d_risk - self.penalty * d_card

    def local_search_sweep(self, xs: torch.Tensor, gen, num_sweeps: int = 4,
                           draws=None) -> torch.Tensor:
        """``methods.greedy_flip_sweeps`` (``'tie'``)."""
        from .methods import greedy_flip_sweeps
        return greedy_flip_sweeps(self, xs, gen, num_sweeps, draws=draws)

    def best(self, xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The best exactly-k selection's mean-variance value (-inf if none)."""
        value = xs @ self.mu - self.lam * torch.sum((xs @ self.sigma) * xs, -1)
        objs = torch.where(torch.sum(xs, -1) == self.k, value,
                           torch.full_like(value, -float('inf')))
        i = torch.argmax(objs)
        return objs[i], xs[i]
