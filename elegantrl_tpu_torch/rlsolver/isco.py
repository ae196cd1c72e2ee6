"""iSCO-style sampler: locally balanced MCMC with a linear temperature
anneal (counterpart of ``elegantrl_tpu/rlsolver/isco.py``).

Each outer step, every chain makes ``path_length`` single-flip moves: the
flip is drawn from ``softmax(gain / (2T))`` over all nodes (Gumbel-max, as
``jax.random.categorical``) and accepted by Metropolis on its gain.  The
permutation form for TSP draws 2-opt moves from ``softmax(-delta / (2T))``
over every segment reversal.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ._draws import as_draws
from .maxcut import best_of
from .methods import annealing_temps, metropolis_flip


def isco_solve(sim, gen, num_sims: int = 1024, num_steps: int = 256,
               path_length: int = 4, t0: float = 1.5, t1: float = 0.05,
               draws=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sim`` is any simulator with ``rand_xs``, ``obj`` and ``flip_gains``
    (the objective's delta of each single flip).  Draws: ``'rand_xs'``, then
    each move's ``'select'`` (Gumbel noise over the nodes) and ``'accept'``.
    Returns ``(best_obj, best_x)``."""
    d = as_draws(gen, sim.device, draws)
    xs = sim.rand_xs(d, num_sims)
    temps = annealing_temps(t0, t1, int(num_steps), False, sim.device)
    rows = torch.arange(num_sims, device=sim.device)
    best_obj = torch.tensor(-float('inf'), device=sim.device)
    best_x = torch.zeros(sim.num_nodes, device=sim.device)
    for t in range(int(num_steps)):
        temp = temps[t]
        for _ in range(int(path_length)):
            gains = sim.flip_gains(xs)                                   # (S, N)
            nodes = torch.argmax(d.gumbel('select', gains.shape) + gains / (2.0 * temp), dim=-1)
            xs = metropolis_flip(xs, nodes, gains[rows, nodes], d.rand('accept', (num_sims,)),
                                 temp)
        best_obj, best_x = best_of(sim.obj(xs), xs, best_obj, best_x)
    return best_obj, best_x


def isco_mis_solve(sim, gen, num_sims: int = 1024, num_steps: int = 256, draws=None,
                   **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """iSCO on the penalized MIS gains, then a repair pass of the
    simulator's local search (8 sweeps, ``'coin'``) so the returned set is
    independent.  Returns ``(set_size, x)``."""
    d = as_draws(gen, sim.device, draws)
    _, best_x = isco_solve(sim, d, num_sims=num_sims, num_steps=num_steps, **kw)
    xs = sim.local_search(best_x[None], d, num_sweeps=8)
    return torch.sum(xs[0]), xs[0]


def isco_tsp_solve(sim, gen, num_sims: int = 256, num_steps: int = 512, t0: float = 0.5,
                   t1: float = 0.01, draws=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Permutation-space iSCO for TSP: each step every chain draws one 2-opt
    move from ``softmax(-delta / (2T))`` over all segment reversals
    (``'select'``, Gumbel noise over the ``n * n`` pairs) and accepts it by
    Metropolis on the true delta (``'accept'``); starts from
    ``'rand_tours'``.  Returns ``(best_len, tour)``."""
    d = as_draws(gen, sim.device, draws)
    n = sim.num_cities
    tours = sim.rand_tours(d, num_sims)
    temps = annealing_temps(t0, t1, int(num_steps), False, sim.device)
    pos = torch.arange(n, device=sim.device)
    # valid 2-opt pairs: 0 <= i < j < n, without the full reversal (0, n - 1)
    valid = (pos[:, None] < pos[None, :]) & ~((pos[:, None] == 0) & (pos[None, :] == n - 1))
    dist = sim.dist
    best_len = torch.tensor(float('inf'), device=sim.device)
    best_tour = tours[0]
    for t in range(int(num_steps)):
        temp = temps[t]
        # delta(i, j) of reversing tour[i..j]: d(a, c) + d(b, e) - d(a, b) - d(c, e)
        # with a = t[i - 1], b = t[i], c = t[j], e = t[j + 1] (cyclic)
        prv, nxt = torch.roll(tours, 1, dims=-1), torch.roll(tours, -1, dims=-1)
        dl = (dist[prv[:, :, None], tours[:, None, :]] + dist[tours[:, :, None], nxt[:, None, :]]
              - dist[prv, tours][:, :, None] - dist[tours, nxt][:, None, :])
        logits = torch.where(valid, -dl / (2.0 * temp), torch.full_like(dl, -float('inf')))
        flat = torch.argmax(d.gumbel('select', (num_sims, n * n)) + logits.reshape(num_sims, -1),
                            dim=-1)
        i, j = flat // n, flat % n
        g = dl.reshape(num_sims, -1).gather(1, flat[:, None])[:, 0]
        u = d.rand('accept', (num_sims,))
        accept = (g < 0) | (u < torch.exp(torch.clamp(-g / temp, max=20.0)))
        p = pos[None, :]
        inside = (p >= i[:, None]) & (p <= j[:, None])
        new_tours = torch.gather(tours, 1, torch.where(inside, i[:, None] + j[:, None] - p, p))
        tours = torch.where(accept[:, None], new_tours, tours)
        best_len, best_tour = best_of(sim.tour_length(tours), tours, best_len, best_tour,
                                      maximize=False)
    return best_len, best_tour
