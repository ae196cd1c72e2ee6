"""Balanced graph partitioning simulator (counterpart of
``elegantrl_tpu/rlsolver/partition.py``).

Split the nodes into two equal halves minimizing the cut.  Solutions are
``(num_sims, N)`` 0/1 side assignments on the simulator's device; the
penalized objective (maximized)

    obj(x) = -cut(x) - penalty * |sum(2x - 1)|

and the exact per-node flip gains are products with the adjacency and
elementwise terms, so the generic annealing and genetic drivers apply.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ._draws import as_draws, solver_device
from .graphs import edges_to_adjacency


class GraphPartitionSimulator:
    def __init__(self, edges: np.ndarray, num_nodes: int, penalty: float = None,
                 device=None):
        self.device = solver_device(device, type(self).__name__)
        self.num_nodes = int(num_nodes)
        adj = np.asarray(edges_to_adjacency(edges, num_nodes))
        self.adj = torch.as_tensor(adj, dtype=torch.float32, device=self.device)
        if penalty is None:
            # moving one node across changes the imbalance by 2 and the cut
            # by at most its weighted degree, so a penalty of the largest
            # degree makes every imbalanced state improvable toward balance,
            # on any edge-weight scale
            penalty = max(1.0, float(adj.sum(axis=1).max()))
        self.penalty = float(penalty)
        self.if_maximize = True

    def rand_xs(self, gen, num_sims: int, draws=None) -> torch.Tensor:
        """Uniform random sides (draw ``'rand_xs'``)."""
        return as_draws(gen, self.device, draws).bernoulli('rand_xs', 0.5,
                                                           (num_sims, self.num_nodes))

    def cut(self, xs: torch.Tensor) -> torch.Tensor:
        return torch.sum((xs @ self.adj) * (1.0 - xs), dim=-1)

    def imbalance(self, xs: torch.Tensor) -> torch.Tensor:
        return torch.abs(torch.sum(2.0 * xs - 1.0, dim=-1))

    def obj(self, xs: torch.Tensor) -> torch.Tensor:
        return -self.cut(xs) - self.penalty * self.imbalance(xs)

    def flip_gains(self, xs: torch.Tensor) -> torch.Tensor:
        """The exact objective delta of flipping each node, every sim."""
        s = 2.0 * xs - 1.0
        cut_gain = s * (s @ self.adj)              # the cut's change of flipping i
        bal = torch.sum(s, dim=-1, keepdim=True)
        bal_new = torch.abs(bal - 2.0 * s)         # flipping i moves the sum by -2 s_i
        return -cut_gain - self.penalty * (bal_new - torch.abs(bal))

    def local_search_sweep(self, xs: torch.Tensor, gen, num_sweeps: int = 4,
                           draws=None) -> torch.Tensor:
        """``methods.greedy_flip_sweeps`` (``'tie'``)."""
        from .methods import greedy_flip_sweeps
        return greedy_flip_sweeps(self, xs, gen, num_sweeps, draws=draws)

    def best(self, xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The best balanced partition's cut (inf if none is balanced)."""
        cut = -self.cut(xs)
        objs = torch.where(self.imbalance(xs) <= (self.num_nodes % 2), cut,
                           torch.full_like(cut, -float('inf')))
        i = torch.argmax(objs)
        return -objs[i], xs[i]
