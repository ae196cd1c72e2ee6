"""0/1 knapsack: batched simulator, heuristic solver and exact dynamic
program (counterpart of ``elegantrl_tpu/rlsolver/knapsack.py``).

Solutions are ``(num_sims, num_items)`` 0/1 on the simulator's device; the
penalized objective and the per-item flip gains are elementwise, so the
generic annealing and genetic drivers apply.  ``knapsack_dp`` is the exact
``O(N W)`` program with the capacity axis a tensor: one shifted maximum
over the whole value table an item.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ._draws import as_draws, solver_device


class KnapsackSimulator:
    """max v.x  s.t.  w.x <= capacity, x in {0,1}^N.

    Penalized objective ``v.x - penalty relu(w.x - C) - B (w.x > C)`` with
    ``B = sum(v) + 1``: the step makes every infeasible solution worse than
    the empty set, so the penalized optimum is feasible at any scale, and
    the linear term (``penalty >= 2 max(v_i / w_i)``) keeps a slope toward
    feasibility.  The flip gains are exact deltas."""

    def __init__(self, values: np.ndarray, weights: np.ndarray, capacity: float,
                 penalty: float = None, device=None):
        self.device = solver_device(device, type(self).__name__)
        self.values = torch.as_tensor(np.asarray(values), dtype=torch.float32,
                                      device=self.device)
        self.weights = torch.as_tensor(np.asarray(weights), dtype=torch.float32,
                                       device=self.device)
        self.capacity = float(capacity)
        self.num_nodes = int(len(values))   # the generic drivers' name
        if penalty is None:
            penalty = 2.0 * float(np.max(np.asarray(values)
                                         / np.maximum(np.asarray(weights), 1e-9)))
        self.penalty = float(penalty)
        self.infeasible_penalty = float(np.sum(np.asarray(values))) + 1.0
        self.if_maximize = True

    def rand_xs(self, gen, num_sims: int, draws=None) -> torch.Tensor:
        """Random sets, each item in with probability ``min(0.5, C / sum(w))``
        (``'rand_xs'``)."""
        p = min(0.5, self.capacity / max(float(torch.sum(self.weights)), 1e-9))
        return as_draws(gen, self.device, draws).bernoulli('rand_xs', p,
                                                           (num_sims, self.num_nodes))

    def obj(self, xs: torch.Tensor) -> torch.Tensor:
        over = torch.clamp(xs @ self.weights - self.capacity, min=0.0)
        return (xs @ self.values - self.penalty * over
                - self.infeasible_penalty * (over > 0.0).to(torch.float32))

    def feasible_value(self, xs: torch.Tensor) -> torch.Tensor:
        """v.x where feasible, -inf otherwise."""
        value = xs @ self.values
        return torch.where(xs @ self.weights <= self.capacity + 1e-6, value,
                           torch.full_like(value, -float('inf')))

    def flip_gains(self, xs: torch.Tensor) -> torch.Tensor:
        """The exact objective delta of flipping each item, every sim."""
        w_tot = (xs @ self.weights)[:, None]                   # (S, 1)
        sign = 1.0 - 2.0 * xs                                  # +1 add, -1 drop
        new_w = w_tot + sign * self.weights[None, :]
        pen_old = torch.clamp(w_tot - self.capacity, min=0.0)
        pen_new = torch.clamp(new_w - self.capacity, min=0.0)
        return (sign * self.values[None, :] - self.penalty * (pen_new - pen_old)
                - self.infeasible_penalty * ((pen_new > 0.0).to(torch.float32)
                                             - (pen_old > 0.0).to(torch.float32)))

    def local_search_sweep(self, xs: torch.Tensor, gen, num_sweeps: int = 4,
                           draws=None) -> torch.Tensor:
        """Greedy one-flip ascent (``methods.greedy_flip_sweeps``, ``'tie'``):
        adds value under capacity, repairs an overweight set by dropping."""
        from .methods import greedy_flip_sweeps
        return greedy_flip_sweeps(self, xs, gen, num_sweeps, draws=draws)

    def best(self, xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        objs = self.feasible_value(xs)
        i = torch.argmax(objs)
        return objs[i], xs[i]


def knapsack_solve(sim: KnapsackSimulator, gen, num_sims: int = 256,
                   num_generations: int = 64, draws=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The memetic genetic algorithm (crossover and greedy flip search;
    ``ga.genetic_algorithm``'s draws).  Returns ``(feasible value, x)``."""
    from .ga import genetic_algorithm
    _, x = genetic_algorithm(sim, gen, pop_size=num_sims, num_generations=num_generations,
                             draws=draws)
    return sim.feasible_value(x[None])[0], x


def knapsack_dp(values: np.ndarray, weights: np.ndarray, capacity: int, device=None) -> float:
    """The exact 0/1 knapsack optimum (integer weights): the per-item
    recurrence with the whole ``(capacity + 1,)`` table updated as one
    shifted maximum an item."""
    device = solver_device(device, 'knapsack_dp')
    w = np.asarray(weights).astype(np.int64)
    v = torch.as_tensor(np.asarray(values), dtype=torch.float32, device=device)
    cap = int(capacity)
    table = torch.zeros(cap + 1, dtype=torch.float32, device=device)
    idx = torch.arange(cap + 1, device=device)
    for wi, vi in zip(w, v):
        # taking the item: the table shifted right by w_i, plus v_i
        src = idx - int(wi)
        shifted = torch.where(src >= 0, table[src.clamp(min=0)] + vi,
                              torch.full_like(table, -float('inf')))
        table = torch.maximum(table, shifted)
    return float(table[cap])
