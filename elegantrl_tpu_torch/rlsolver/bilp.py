"""Binary integer linear programming simulator (counterpart of
``elegantrl_tpu/rlsolver/bilp.py``).

Maximize ``c.x`` subject to ``A x <= b`` over x in {0,1}^n, with a linear
penalty on the violation.  The constraint slacks are one product; the
exact flip gains take every sim and variable at once, so the generic
annealing and genetic drivers apply.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ._draws import as_draws, solver_device


class BILPSimulator:
    """max c.x  s.t.  A x <= b, x binary, penalized:
    ``obj = c.x - penalty * sum(relu(A x - b))``."""

    def __init__(self, c: np.ndarray, a: np.ndarray, b: np.ndarray, penalty: float = None,
                 device=None):
        self.device = solver_device(device, type(self).__name__)
        self.c = torch.as_tensor(np.asarray(c), dtype=torch.float32, device=self.device)  # (n,)
        self.a = torch.as_tensor(np.asarray(a), dtype=torch.float32, device=self.device)  # (m, n)
        self.b = torch.as_tensor(np.asarray(b), dtype=torch.float32, device=self.device)  # (m,)
        self.num_nodes = int(self.c.shape[0])
        if penalty is None:
            # with continuous slacks a linear penalty can trade a small
            # violation for a large c_j; 2 sum|c| + 1 makes that trade lose
            penalty = 2.0 * float(np.sum(np.abs(np.asarray(c)))) + 1.0
        self.penalty = float(penalty)
        self.if_maximize = True

    def rand_xs(self, gen, num_sims: int, draws=None) -> torch.Tensor:
        """Random selections, each variable 1 with probability 0.25 (draw
        ``'rand_xs'``)."""
        return as_draws(gen, self.device, draws).bernoulli('rand_xs', 0.25,
                                                           (num_sims, self.num_nodes))

    def violation(self, xs: torch.Tensor) -> torch.Tensor:
        slack = xs @ self.a.T - self.b[None, :]        # (S, m)
        return torch.sum(torch.clamp(slack, min=0.0), dim=-1)

    def obj(self, xs: torch.Tensor) -> torch.Tensor:
        return xs @ self.c - self.penalty * self.violation(xs)

    def flip_gains(self, xs: torch.Tensor) -> torch.Tensor:
        """The exact objective delta of flipping each variable, every sim."""
        slack = xs @ self.a.T - self.b[None, :]        # (S, m)
        sign = 1.0 - 2.0 * xs                          # (S, n)
        # the slack after flipping j: slack + sign_j * A[:, j]
        new_pen = torch.clamp(slack[:, None, :] + sign[:, :, None] * self.a.T[None, :, :],
                              min=0.0)
        d_pen = torch.sum(new_pen, -1) - torch.sum(torch.clamp(slack, min=0.0), -1,
                                                   keepdim=True)
        return sign * self.c[None, :] - self.penalty * d_pen

    def local_search_sweep(self, xs: torch.Tensor, gen, num_sweeps: int = 4,
                           draws=None) -> torch.Tensor:
        """``methods.greedy_flip_sweeps`` (``'tie'``)."""
        from .methods import greedy_flip_sweeps
        return greedy_flip_sweeps(self, xs, gen, num_sweeps, draws=draws)

    def best(self, xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The best feasible objective (-inf if no sim is feasible)."""
        value = xs @ self.c
        objs = torch.where(self.violation(xs) <= 1e-6, value,
                           torch.full_like(value, -float('inf')))
        i = torch.argmax(objs)
        return objs[i], xs[i]
