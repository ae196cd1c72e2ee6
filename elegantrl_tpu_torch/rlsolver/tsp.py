"""TSP: batched tour construction and 2-opt search (counterpart of
``elegantrl_tpu/rlsolver/tsp.py``).

A population of tours ``(num_sims, N)`` improves in lockstep on the
simulator's device: nearest-neighbour construction as a masked argmin per
step for all sims at once, and best-improvement 2-opt that evaluates every
sim's whole ``(N, N)`` table of move deltas and applies its best improving
segment reversal by index arithmetic.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ._draws import as_draws, solver_device


def random_cities(num_cities: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (num_cities, 2)).astype(np.float32)


class TSPSimulator:
    def __init__(self, cities: np.ndarray, device=None):
        self.device = solver_device(device, type(self).__name__)
        self.cities = torch.as_tensor(np.asarray(cities), dtype=torch.float32,
                                      device=self.device)
        self.num_cities = int(cities.shape[0])
        diff = self.cities[:, None, :] - self.cities[None, :, :]
        self.dist = torch.sqrt(torch.sum(torch.square(diff), -1))   # (N, N)
        self.if_maximize = False

    def rand_tours(self, gen, num_sims: int, draws=None) -> torch.Tensor:
        """``num_sims`` uniform random permutations (``'rand_tours'``)."""
        n = self.num_cities
        return as_draws(gen, self.device, draws)(
            'rand_tours', lambda g: torch.argsort(
                torch.rand((num_sims, n), generator=g, device=self.device), dim=-1),
            torch.int64)

    def tour_length(self, tours: torch.Tensor) -> torch.Tensor:
        nxt = torch.roll(tours, -1, dims=-1)
        return torch.sum(self.dist[tours, nxt], dim=-1)

    def nearest_neighbor(self, gen, num_sims: int, draws=None) -> torch.Tensor:
        """Greedy construction from random start cities (``'start'``),
        every sim at once."""
        n = self.num_cities
        cur = as_draws(gen, self.device, draws).randint('start', n, (num_sims,))
        rows = torch.arange(num_sims, device=self.device)
        visited = torch.zeros((num_sims, n), dtype=torch.bool, device=self.device)
        visited[rows, cur] = True
        tour = [cur]
        for _ in range(n - 1):
            d = torch.where(visited, torch.full_like(self.dist[cur], float('inf')),
                            self.dist[cur])
            cur = torch.argmin(d, dim=-1)
            visited[rows, cur] = True
            tour.append(cur)
        return torch.stack(tour, dim=1)

    def two_opt(self, tours: torch.Tensor, num_iters: int = 64) -> torch.Tensor:
        """Best-improvement 2-opt, one move a sim an iteration."""
        n = self.num_cities
        pos = torch.arange(n, device=tours.device)
        valid = pos[None, :, None] < pos[None, None, :] - 1     # non-adjacent edges
        for _ in range(int(num_iters)):
            a, b = tours, torch.roll(tours, -1, dims=-1)      # edge i: (a_i, b_i)
            # delta(i, j) = d(a_i, a_j) + d(b_i, b_j) - d(a_i, b_i) - d(a_j, b_j)
            cur = self.dist[a, b]
            delta = (self.dist[a[:, :, None], a[:, None, :]] + self.dist[b[:, :, None], b[:, None, :]]
                     - cur[:, :, None] - cur[:, None, :])
            flat = torch.where(valid, delta, torch.full_like(delta, float('inf'))).reshape(
                tours.shape[0], -1)
            best = torch.argmin(flat, dim=-1)
            improve = flat.gather(1, best[:, None])[:, 0] < -1e-6
            i = torch.where(improve, best // n, torch.zeros_like(best))
            j = torch.where(improve, best % n, torch.zeros_like(best))
            p = pos[None, :]
            rev = torch.where((p >= i[:, None] + 1) & (p <= j[:, None]),
                              j[:, None] + i[:, None] + 1 - p, p)
            tours = torch.gather(tours, 1, rev)
        return tours

    def best(self, tours: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        lens = self.tour_length(tours)
        i = torch.argmin(lens)
        return lens[i], tours[i]


def tsp_solve(cities: np.ndarray, gen, num_sims: int = 256, num_iters: int = 128,
              device=None, draws=None) -> Tuple[float, torch.Tensor]:
    """Nearest-neighbour construction from random starts (``'start'``) and
    2-opt polishing; the shortest tour."""
    sim = TSPSimulator(cities, device=device)
    tours = sim.nearest_neighbor(as_draws(gen, sim.device, draws), num_sims)
    tours = sim.two_opt(tours, num_iters)
    length, tour = sim.best(tours)
    return float(length), tour
