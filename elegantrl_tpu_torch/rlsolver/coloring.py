"""Graph coloring simulator and solvers (counterpart of
``elegantrl_tpu/rlsolver/coloring.py``).

Solutions are a ``(num_sims, num_nodes)`` int color matrix on the
simulator's device; the conflicts of every node under every color for all
sims come from one product with the one-hot coloring,
``C[s, n, k] = sum_m A[n, m] onehot(x)[s, m, k]``, which drives batched
min-conflict descent.  Objective: the count of monochromatic edges (0 is a
proper coloring), minimized.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ._draws import as_draws, solver_device
from .graphs import edges_to_adjacency


class GraphColoringSimulator:
    """Batched K-coloring over a fixed graph; minimizes conflicts."""

    def __init__(self, edges: np.ndarray, num_nodes: int, num_colors: int, device=None):
        self.device = solver_device(device, type(self).__name__)
        self.num_nodes = int(num_nodes)
        self.num_colors = int(num_colors)
        self.adj = torch.as_tensor((edges_to_adjacency(edges, num_nodes) > 0)
                                   .astype(np.float32), device=self.device)
        self.if_maximize = False

    def rand_xs(self, gen, num_sims: int, draws=None) -> torch.Tensor:
        """Uniform random colorings (``'rand_xs'``)."""
        return as_draws(gen, self.device, draws).randint('rand_xs', self.num_colors,
                                                         (num_sims, self.num_nodes))

    def _onehot(self, xs: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.one_hot(xs.long(), self.num_colors).to(torch.float32)

    def obj(self, xs: torch.Tensor) -> torch.Tensor:
        """Monochromatic edges per sim: xs (S, N) int -> (S,)."""
        onehot = self._onehot(xs)
        return torch.sum(onehot * torch.einsum('nm,smk->snk', self.adj, onehot),
                         dim=(1, 2)) / 2.0

    def color_conflicts(self, xs: torch.Tensor) -> torch.Tensor:
        """(S, N, K): the conflicts node n would have under each color k."""
        return torch.einsum('nm,smk->snk', self.adj, self._onehot(xs))

    def local_search(self, xs: torch.Tensor, gen, num_sweeps: int = 16,
                     draws=None) -> torch.Tensor:
        """Parallel min-conflict sweeps: every node moves to its least
        conflicted color (ties broken by uniform noise of 1e-3, ``'tie'``)
        where that lowers its conflicts and its coin comes up (``'coin'``),
        so neighbours do not move in lockstep."""
        d = as_draws(gen, self.device, draws)
        xs = xs.long()
        for _ in range(int(num_sweeps)):
            conf = self.color_conflicts(xs)
            best = torch.argmin(conf + d.rand('tie', conf.shape) * 1e-3, dim=-1)
            coin = d.bernoulli('coin', 0.5, xs.shape) > 0.5
            cur = conf.gather(-1, xs[..., None])[..., 0]
            new = conf.gather(-1, best[..., None])[..., 0]
            xs = torch.where(coin & (new < cur), best, xs)
        return xs

    def best(self, xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        objs = self.obj(xs)
        i = torch.argmin(objs)
        return objs[i], xs[i]


def color_graph(sim: GraphColoringSimulator, gen, num_sims: int = 512, num_sweeps: int = 64,
                draws=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random restarts (``'rand_xs'``) and min-conflict descent.  Returns
    ``(conflicts, colors)``; 0 conflicts is a proper ``num_colors``-coloring."""
    d = as_draws(gen, sim.device, draws)
    xs = sim.rand_xs(d, num_sims)
    xs = sim.local_search(xs, d, num_sweeps=num_sweeps)
    return sim.best(xs)


def chromatic_upper_bound(sim_factory, edges: np.ndarray, num_nodes: int, gen,
                          k_max: int = 16, num_sims: int = 256, device=None,
                          draws=None) -> int:
    """The least K <= k_max for which :func:`color_graph` finds a proper
    coloring (K from 2 up, each K's draws after the last's), else
    ``k_max + 1``.  ``sim_factory(edges, num_nodes, K, device=)``."""
    d = None
    for k in range(2, k_max + 1):
        sim = sim_factory(edges, num_nodes, k, device=device)
        d = d or as_draws(gen, sim.device, draws)
        conflicts, _ = color_graph(sim, d, num_sims=num_sims)
        if float(conflicts) == 0.0:
            return k
    return k_max + 1
