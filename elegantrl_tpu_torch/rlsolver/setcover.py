"""Set cover simulator (counterpart of ``elegantrl_tpu/rlsolver/setcover.py``).

Given a membership matrix M ``(num_sets, num_elems)``, pick the fewest
sets covering every element.  Solutions are ``(num_sims, num_sets)`` 0/1 on
the simulator's device; the coverage counts are one product, so the
objective and the exact flip gains take every sim and set at once.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ._draws import as_draws, solver_device


class SetCoverSimulator:
    """Maximizes ``-(#sets) - penalty * #uncovered``."""

    def __init__(self, membership: np.ndarray, penalty: float = None, device=None):
        self.device = solver_device(device, type(self).__name__)
        self.m = torch.as_tensor((np.asarray(membership) > 0).astype(np.float32),
                                 device=self.device)
        self.num_nodes = int(self.m.shape[0])        # = num_sets
        self.num_elems = int(self.m.shape[1])
        # a penalty above num_sets makes any full cover beat any non-cover
        self.penalty = float(penalty if penalty is not None else self.num_nodes + 1.0)
        self.if_maximize = True

    def rand_xs(self, gen, num_sims: int, draws=None) -> torch.Tensor:
        """Uniform random selections (draw ``'rand_xs'``)."""
        return as_draws(gen, self.device, draws).bernoulli('rand_xs', 0.5,
                                                           (num_sims, self.num_nodes))

    def num_uncovered(self, xs: torch.Tensor) -> torch.Tensor:
        counts = xs @ self.m                          # (S, E)
        return torch.sum(counts < 0.5, dim=-1).to(torch.float32)

    def obj(self, xs: torch.Tensor) -> torch.Tensor:
        return -torch.sum(xs, dim=-1) - self.penalty * self.num_uncovered(xs)

    def flip_gains(self, xs: torch.Tensor) -> torch.Tensor:
        """The exact objective delta of flipping each set, every sim: adding
        set j covers the elements of j whose count is 0; dropping it
        uncovers those whose count is 1."""
        counts = xs @ self.m                          # (S, E)
        newly_covered = (counts < 0.5).to(torch.float32) @ self.m.T            # (S, sets)
        newly_uncovered = (torch.abs(counts - 1.0) < 0.5).to(torch.float32) @ self.m.T
        sign = 1.0 - 2.0 * xs                          # +1 add, -1 drop
        d_uncov = torch.where(sign > 0, -newly_covered, newly_uncovered * xs)
        return -sign - self.penalty * d_uncov

    def local_search_sweep(self, xs: torch.Tensor, gen, num_sweeps: int = 4,
                           draws=None) -> torch.Tensor:
        """``methods.greedy_flip_sweeps`` (``'tie'``)."""
        from .methods import greedy_flip_sweeps
        return greedy_flip_sweeps(self, xs, gen, num_sweeps, draws=draws)

    def best(self, xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The smallest full cover's size (inf if no sim covers everything)."""
        size = torch.sum(xs, dim=-1)
        sizes = torch.where(self.num_uncovered(xs) == 0, size,
                            torch.full_like(size, float('inf')))
        i = torch.argmin(sizes)
        return sizes[i], xs[i]
