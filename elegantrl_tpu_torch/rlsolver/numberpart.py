"""Number partitioning simulator (counterpart of
``elegantrl_tpu/rlsolver/numberpart.py``).

Split a multiset ``a`` into two halves minimizing ``|sum(A) - sum(B)|``:
solutions are ``(num_sims, N)`` 0/1 side assignments on the simulator's
device, the objective and flip gains elementwise, so the generic annealing
and genetic drivers apply.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ._draws import as_draws, solver_device


class NumberPartitionSimulator:
    """Maximizes ``-|a.(2x - 1)|`` (0 is a perfect partition)."""

    def __init__(self, numbers: np.ndarray, device=None):
        self.device = solver_device(device, type(self).__name__)
        self.numbers = torch.as_tensor(np.asarray(numbers), dtype=torch.float32,
                                       device=self.device)
        self.num_nodes = int(len(numbers))
        self.if_maximize = True

    def rand_xs(self, gen, num_sims: int, draws=None) -> torch.Tensor:
        return as_draws(gen, self.device, draws).bernoulli('rand_xs', 0.5,
                                                           (num_sims, self.num_nodes))

    def imbalance(self, xs: torch.Tensor) -> torch.Tensor:
        return torch.abs((2.0 * xs - 1.0) @ self.numbers)

    def obj(self, xs: torch.Tensor) -> torch.Tensor:
        return -self.imbalance(xs)

    def flip_gains(self, xs: torch.Tensor) -> torch.Tensor:
        """The objective's delta of flipping each element, every sim."""
        diff = ((2.0 * xs - 1.0) @ self.numbers)[:, None]      # (S, 1)
        delta = -2.0 * (2.0 * xs - 1.0) * self.numbers[None, :]
        return torch.abs(diff) - torch.abs(diff + delta)

    def local_search_sweep(self, xs: torch.Tensor, gen, num_sweeps: int = 4,
                           draws=None) -> torch.Tensor:
        """``methods.greedy_flip_sweeps`` with tie noise far below the small
        gains near a perfect partition (``'tie'``)."""
        from .methods import greedy_flip_sweeps
        return greedy_flip_sweeps(self, xs, gen, num_sweeps, tie_noise=1e-6, draws=draws)

    def best(self, xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        objs = self.obj(xs)
        i = torch.argmax(objs)
        return objs[i], xs[i]
