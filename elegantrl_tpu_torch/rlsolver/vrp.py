"""Capacitated VRP with time windows (Solomon instances), batched on the
card (counterpart of ``elegantrl_tpu/rlsolver/vrp.py``).

Construction is a batched time-window-feasible randomized greedy: every
sim advances in lockstep, one step for all ``num_sims`` at once, each
keeping (position, clock, remaining capacity, visited mask) and returning
to the depot whenever no customer is feasible.  All feasibility math is
dense ``(num_sims, n)`` masking; the distance matrix lives on the device
once.

Solomon semantics: service at customer i may START no later than ``due[i]``
(waiting until ``ready[i]`` is allowed); vehicles leave the depot at time 0
and must return before ``due[0]``; each vehicle carries ``capacity``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ._draws import as_draws, solver_device


class VRPTWSimulator:
    """Batched Solomon-instance evaluator and randomized-greedy constructor.

    Tours are ``(num_sims, tour_len)`` int64 tensors of node ids where 0 is
    the depot (consecutive depot entries are idle padding); ``tour_len =
    2 * n`` is enough for any feasible instance (worst case: one customer
    per vehicle)."""

    def __init__(self, inst: dict, device=None):
        self.device = solver_device(device, type(self).__name__)
        xy = np.asarray(inst['xy'], np.float64)
        self.n = len(xy)                    # customers + depot
        self.tour_len = 2 * self.n
        self.num_vehicles = int(inst['num_vehicles'])
        self.capacity = float(inst['capacity'])

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

        self.dist = f32(np.sqrt(((xy[:, None, :] - xy[None, :, :]) ** 2).sum(-1)))
        self.demand = f32(inst['demand'])
        self.ready = f32(inst['ready'])
        self.due = f32(inst['due'])
        self.service = f32(inst['service'])

    def construct(self, gen, num_sims: int, noise: float = 0.15, wait_w: float = 0.5,
                  urgency_w: float = 0.1, draws=None) -> torch.Tensor:
        """Randomized time-aware greedy: each sim repeatedly visits the best
        time-window-feasible customer scored by ``distance + wait_w * wait +
        urgency_w * slack`` (wait = idle time until the window opens; slack =
        time left until it closes, so urgent customers come first), with
        ``noise * U[0,1) * mean_dist`` jitter (``'jitter'``, one ``(S, n)``
        draw a step); a sim returns to the depot when nothing is feasible."""
        d = as_draws(gen, self.device, draws)
        S, n = int(num_sims), self.n
        mean_d = torch.mean(self.dist)
        rows = torch.arange(S, device=self.device)
        back = self.dist[:, 0][None, :]
        pos = torch.zeros(S, dtype=torch.int64, device=self.device)
        clock = torch.zeros(S, device=self.device)
        cap = torch.full((S,), self.capacity, device=self.device)
        visited = torch.zeros((S, n), dtype=torch.bool, device=self.device)
        visited[:, 0] = True
        inf = torch.tensor(float('inf'), device=self.device)
        tours = []
        for _ in range(self.tour_len):
            leg = self.dist[pos]                                     # (S, n)
            arrive = clock[:, None] + leg
            start = torch.maximum(arrive, self.ready[None, :])
            # start service before due, fit capacity, be unvisited, and
            # allow returning to the depot before ITS due date
            back_ok = (start + self.service[None, :] + back) <= self.due[0]
            feasible = ((~visited) & (start <= self.due[None, :])
                        & (self.demand[None, :] <= cap[:, None]) & back_ok)
            feasible[:, 0] = False
            any_feas = torch.any(feasible, dim=-1)                   # (S,)

            jitter = d.rand('jitter', (S, n)) * noise * mean_d
            wait = start - arrive
            slack = self.due[None, :] - arrive
            score = torch.where(feasible, leg + wait_w * wait + urgency_w * slack + jitter, inf)
            nxt = torch.where(any_feas, torch.argmin(score, dim=-1), 0)   # else depot
            clock = torch.where(any_feas, start[rows, nxt] + self.service[nxt],
                                torch.zeros_like(clock))   # a depot return resets the clock
            cap = torch.where(any_feas, cap - self.demand[nxt],
                              torch.full_like(cap, self.capacity))
            visited = visited.clone()
            visited[rows, nxt] = True
            pos = nxt
            tours.append(nxt)
        return torch.stack(tours, dim=1)                             # (S, L)

    @staticmethod
    def _prev(tours: torch.Tensor) -> torch.Tensor:
        return torch.cat([torch.zeros_like(tours[:, :1]), tours[:, :-1]], dim=1)

    def tour_distance(self, tours: torch.Tensor) -> torch.Tensor:
        """Total travel distance including the first leg out of the depot."""
        return torch.sum(self.dist[self._prev(tours), tours], dim=-1)

    def num_vehicles_used(self, tours: torch.Tensor) -> torch.Tensor:
        """Depot->customer transitions = vehicles dispatched."""
        return torch.sum((self._prev(tours) == 0) & (tours != 0), dim=-1)

    def is_complete(self, tours: torch.Tensor) -> torch.Tensor:
        """Every customer visited exactly once (a per-row count of each id)."""
        counts = torch.zeros((tours.shape[0], self.n), dtype=torch.int64, device=tours.device)
        counts.scatter_add_(1, tours, torch.ones_like(tours))
        return torch.all(counts[:, 1:] == 1, dim=-1)

    def best(self, tours: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(distance, tour) of the shortest complete solution within the
        vehicle budget (inf, and the first tour, if none)."""
        ok = self.is_complete(tours) & (self.num_vehicles_used(tours) <= self.num_vehicles)
        dists = self.tour_distance(tours)
        dists = torch.where(ok, dists, torch.full_like(dists, float('inf')))
        i = torch.argmin(dists)
        return dists[i], tours[i]


def random_vrptw(n_customers: int, seed: int = 0, num_vehicles: int = 8,
                 capacity: float = 100.0) -> dict:
    """Synthetic Solomon-style instance (wide, satisfiable time windows)."""
    rng = np.random.default_rng(seed)
    xy = np.vstack([[50.0, 50.0], rng.uniform(0, 100, (n_customers, 2))])
    demand = np.concatenate([[0.0], rng.integers(5, 25, n_customers)])
    ready = np.concatenate([[0.0], rng.uniform(0, 600, n_customers)])
    due = np.concatenate([[2000.0], ready[1:] + rng.uniform(300, 900, n_customers)])
    service = np.concatenate([[0.0], np.full(n_customers, 10.0)])
    return {'name': f'rand{n_customers}', 'num_vehicles': num_vehicles,
            'capacity': capacity, 'xy': xy, 'demand': demand,
            'ready': ready, 'due': due, 'service': service}


def vrptw_solve(inst: dict, gen, num_sims: int = 512, noise: float = 0.15, device=None,
                draws=None) -> Tuple[float, np.ndarray, int]:
    """Best of ``num_sims`` randomized time-aware greedy constructions
    (``'jitter'``).  Returns (total distance, tour node sequence, vehicles
    used)."""
    sim = VRPTWSimulator(inst, device=device)
    tours = sim.construct(as_draws(gen, sim.device, draws), num_sims, noise=noise)
    dist, tour = sim.best(tours)
    vehicles = int(sim.num_vehicles_used(tour[None])[0])
    return float(dist), tour.cpu().numpy(), vehicles
