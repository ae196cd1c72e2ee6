"""Batched MaxCut simulator (counterpart of ``elegantrl_tpu/rlsolver/maxcut.py``).

Solutions are a ``(num_sims, num_nodes)`` 0/1 matrix and the objective is
one product with the symmetric adjacency ``A`` (counted once)::

    cut(x) = x^T A (1 - x)

and the flip gain of every node of every sim comes from the same product
(``s = 2x - 1``; a flip improves iff its gain is positive)::

    gain_i = s_i (A s)_i

which drives the greedy local searches here and the annealing drivers of
:mod:`.methods`, :mod:`.isco` and :mod:`.mcpg`.  The products are
``torch.matmul`` on the simulator's device (the card unless ``device`` names
another), as the JAX package computes them outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ._draws import as_draws, solver_device
from .graphs import edges_to_adjacency


class MaxCutSimulator:
    """Batched MaxCut over a fixed graph on ``device`` (None: the card)."""

    def __init__(self, edges: np.ndarray, num_nodes: int, device=None):
        self.device = solver_device(device, type(self).__name__)
        self.num_nodes = int(num_nodes)
        adj = edges_to_adjacency(edges, num_nodes)
        self.adj = torch.as_tensor(adj, device=self.device)     # (N, N) symmetric
        self.total_weight = float(adj.sum() / 2)
        self.num_edges = int((adj != 0).sum() // 2)
        self.if_maximize = True

    def rand_xs(self, gen, num_sims: int, draws=None) -> torch.Tensor:
        """``num_sims`` uniform random 0/1 solutions (draw ``'rand_xs'``)."""
        return as_draws(gen, self.device, draws).bernoulli('rand_xs', 0.5,
                                                           (num_sims, self.num_nodes))

    def obj(self, xs: torch.Tensor) -> torch.Tensor:
        """Cut value per sim: xs (S, N) in {0, 1} -> (S,)."""
        return torch.sum((xs @ self.adj) * (1.0 - xs), dim=-1)

    def flip_gains(self, xs: torch.Tensor) -> torch.Tensor:
        """gain_i = cut(flip i) - cut(x), every node of every sim."""
        s = 2.0 * xs - 1.0
        return s * (s @ self.adj)

    def local_search(self, xs: torch.Tensor, gen, num_iters: int = 8,
                     draws=None) -> torch.Tensor:
        """Greedy best-improvement search, all sims at once: each iteration
        flips every sim's highest-gain node where that gain is positive,
        ties broken by uniform noise of 1e-3 (draw ``'tie'``, one an
        iteration)."""
        d = as_draws(gen, self.device, draws)
        rows = torch.arange(xs.shape[0], device=xs.device)
        for _ in range(int(num_iters)):
            gains = self.flip_gains(xs)
            best = torch.argmax(gains + d.rand('tie', gains.shape) * 1e-3, dim=-1)
            improve = (gains[rows, best] > 0).to(xs.dtype)
            xs = xs.clone()
            xs[rows, best] = torch.abs(xs[rows, best] - improve)
        return xs

    def local_search_sweep(self, xs: torch.Tensor, gen, num_sweeps: int = 4,
                           draws=None) -> torch.Tensor:
        """Parallel conditional-flip sweeps: every node whose flip improves
        and whose coin comes up (draw ``'coin'``, one a sweep: the coin keeps
        neighbours from flipping together) flips at once."""
        d = as_draws(gen, self.device, draws)
        for _ in range(int(num_sweeps)):
            gains = self.flip_gains(xs)
            coin = d.bernoulli('coin', 0.5, gains.shape)
            xs = torch.abs(xs - (gains > 0).to(xs.dtype) * coin)
        return xs

    def best(self, xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        objs = self.obj(xs)
        i = torch.argmax(objs)
        return objs[i], xs[i]


def best_of(objs: torch.Tensor, xs: torch.Tensor, best_obj: torch.Tensor,
            best_x: torch.Tensor, maximize: bool = True):
    """The running best of a search: the step's best sim replaces the kept
    one where strictly better (the first best sim on a tie)."""
    i = torch.argmax(objs) if maximize else torch.argmin(objs)
    better = objs[i] > best_obj if maximize else objs[i] < best_obj
    return torch.where(better, objs[i], best_obj), torch.where(better, xs[i], best_x)
