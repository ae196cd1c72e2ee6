"""Maximum independent set and minimum vertex cover simulators
(counterpart of ``elegantrl_tpu/rlsolver/mis.py``).

Solutions are ``(num_sims, num_nodes)`` 0/1 on the simulator's device; the
penalized objective

    obj(x) = sum_i x_i - penalty * sum_{(i,j) in E} x_i x_j

is one product with the 0/1 adjacency, and the local search drops
conflicted nodes and adds free ones in batched sweeps.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ._draws import as_draws, solver_device
from .graphs import edges_to_adjacency


class MISSimulator:
    def __init__(self, edges: np.ndarray, num_nodes: int, penalty: float = 2.0, device=None):
        self.device = solver_device(device, type(self).__name__)
        self.num_nodes = int(num_nodes)
        self.adj = torch.as_tensor((edges_to_adjacency(edges, num_nodes) > 0)
                                   .astype(np.float32), device=self.device)
        self.penalty = float(penalty)
        self.if_maximize = True

    def rand_xs(self, gen, num_sims: int, draws=None) -> torch.Tensor:
        """Random sets, each node in with probability 0.15 (``'rand_xs'``)."""
        return as_draws(gen, self.device, draws).bernoulli('rand_xs', 0.15,
                                                           (num_sims, self.num_nodes))

    def obj(self, xs: torch.Tensor) -> torch.Tensor:
        """Penalized size; exactly ``|S|`` when S is independent."""
        return torch.sum(xs, dim=-1) - self.penalty * self.num_conflicts(xs)

    def num_conflicts(self, xs: torch.Tensor) -> torch.Tensor:
        return torch.sum((xs @ self.adj) * xs, dim=-1) / 2.0

    def flip_gains(self, xs: torch.Tensor) -> torch.Tensor:
        """Objective delta of flipping each node: adding node i gains ``1 -
        penalty * (selected neighbours)``, removing it the opposite."""
        return (1.0 - 2.0 * xs) * (1.0 - self.penalty * (xs @ self.adj))

    def local_search(self, xs: torch.Tensor, gen, num_sweeps: int = 16,
                     draws=None) -> torch.Tensor:
        """Repair and grow sweeps: drop the conflicted selected nodes whose
        coin comes up (``'coin'``, one a sweep), then add every node with no
        selected neighbour; at the end drop every node still conflicted, so
        the returned sets are independent."""
        d = as_draws(gen, self.device, draws)
        for _ in range(int(num_sweeps)):
            conflicted = (xs > 0.5) & ((xs @ self.adj) > 0.5)
            coin = d.bernoulli('coin', 0.5, xs.shape) > 0.5
            xs = torch.where(conflicted & coin, torch.zeros_like(xs), xs)
            free = (xs < 0.5) & ((xs @ self.adj) < 0.5)
            xs = torch.where(free, torch.ones_like(xs), xs)
        return torch.where((xs > 0.5) & ((xs @ self.adj) > 0.5), torch.zeros_like(xs), xs)

    # the generic drivers' entry point (methods.greedy_local_search)
    local_search_sweep = local_search

    def best(self, xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The largest independent set (conflicted sets count -inf)."""
        objs = torch.where(self.num_conflicts(xs) == 0, torch.sum(xs, dim=-1),
                           torch.full_like(xs[:, 0], -float('inf')))
        i = torch.argmax(objs)
        return objs[i], xs[i]


class VertexCoverSimulator:
    """Minimum vertex cover in complement space: a set is a cover iff its
    complement is independent, so each operation is
    :class:`MISSimulator`'s on ``1 - xs``.  Solutions are cover indicators;
    ``obj`` is the maximized ``-|cover| - penalty * uncovered_edges``, and
    ``best`` reports the smallest valid cover with its (positive) size."""

    def __init__(self, edges: np.ndarray, num_nodes: int, penalty: float = 2.0, device=None):
        self._mis = MISSimulator(edges, num_nodes, penalty=penalty, device=device)
        self.device = self._mis.device
        self.num_nodes = self._mis.num_nodes
        self.if_maximize = True

    def rand_xs(self, gen, num_sims: int, draws=None) -> torch.Tensor:
        return 1.0 - self._mis.rand_xs(gen, num_sims, draws)

    def obj(self, xs: torch.Tensor) -> torch.Tensor:
        return self._mis.obj(1.0 - xs) - self.num_nodes

    def num_uncovered(self, xs: torch.Tensor) -> torch.Tensor:
        """Edges with neither endpoint in the cover."""
        return self._mis.num_conflicts(1.0 - xs)

    def flip_gains(self, xs: torch.Tensor) -> torch.Tensor:
        # flipping cover bit i flips complement bit i; the objectives differ
        # by the constant N, so the gains are the same
        return self._mis.flip_gains(1.0 - xs)

    def local_search(self, xs: torch.Tensor, gen, num_sweeps: int = 16,
                     draws=None) -> torch.Tensor:
        return 1.0 - self._mis.local_search(1.0 - xs, gen, num_sweeps=num_sweeps, draws=draws)

    local_search_sweep = local_search

    def best(self, xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The smallest valid cover's size (inf if no sim covers every edge)."""
        sizes = torch.where(self.num_uncovered(xs) == 0, torch.sum(xs, dim=-1),
                            torch.full_like(xs[:, 0], float('inf')))
        i = torch.argmin(sizes)
        return sizes[i], xs[i]


def greedy_mis(sim: MISSimulator, gen, num_sims: int = 512, num_sweeps: int = 32,
               draws=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random sets (``'rand_xs'``) through ``num_sweeps`` sweeps of the
    simulator's local search (``'coin'``); the best independent set."""
    d = as_draws(gen, sim.device, draws)
    xs = sim.rand_xs(d, num_sims)
    xs = sim.local_search(xs, d, num_sweeps=num_sweeps)
    return sim.best(xs)
