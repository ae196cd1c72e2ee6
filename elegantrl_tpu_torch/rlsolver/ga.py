"""Batched genetic algorithm for binary combinatorial problems (counterpart
of ``elegantrl_tpu/rlsolver/ga.py``).

The population is one ``(pop_size, num_nodes)`` 0/1 matrix on the
simulator's device: tournament selection, uniform crossover, mutation and
(where the simulator has one) a few sweeps of its local search run on the
whole population each generation, with elitism.  Works with any simulator
exposing ``rand_xs``, ``obj`` and ``num_nodes``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ._draws import as_draws


def genetic_algorithm(sim, gen, pop_size: int = 256, num_generations: int = 64,
                      elite_frac: float = 0.125, mutate_p: float = 0.02,
                      tournament_k: int = 2, local_search_sweeps: int = 2,
                      draws=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(best_obj, best_x)``; maximizes ``sim.obj``.  Draws: the
    population (``'rand_xs'``) and its search, then each generation's two
    tournaments (``'tournament'``), crossover mask (``'crossover'``),
    mutation (``'mutate'``) and the children's search (the simulator's
    names: ``'coin'`` or ``'tie'``)."""
    from .methods import _require_maximizer
    _require_maximizer(sim, 'genetic_algorithm')
    n = sim.num_nodes
    n_elite = max(1, int(pop_size * elite_frac))
    ls = None
    if local_search_sweeps > 0:
        search = getattr(sim, 'local_search_sweep', None) or getattr(sim, 'local_search', None)
        if search is not None:
            ls = lambda xs, dr: search(xs, dr, num_sweeps=local_search_sweeps)  # noqa: E731
    d = as_draws(gen, sim.device, draws)
    pop = sim.rand_xs(d, pop_size)
    if ls is not None:
        pop = ls(pop, d)
    rows = torch.arange(pop_size, device=pop.device)

    def tournament(objs):
        """One parent a child: the best of ``tournament_k`` random ones."""
        cand = d.randint('tournament', pop_size, (pop_size, tournament_k))
        return cand[rows, torch.argmax(objs[cand], dim=-1)]

    objs = sim.obj(pop)
    for _ in range(int(num_generations)):
        pa, pb = tournament(objs), tournament(objs)
        mask = d.bernoulli('crossover', 0.5, (pop_size, n)) > 0.5
        children = torch.where(mask, pop[pa], pop[pb])
        children = torch.abs(children - d.bernoulli('mutate', mutate_p, (pop_size, n)))
        if ls is not None:
            children = ls(children, d)
        child_objs = sim.obj(children)
        # elitism: the best n_elite parents replace the worst n_elite children
        elite = torch.argsort(-objs, stable=True)[:n_elite]
        worst = torch.argsort(child_objs, stable=True)[:n_elite]
        children[worst] = pop[elite]
        child_objs[worst] = objs[elite]
        pop, objs = children, child_objs
    i = torch.argmax(objs)
    return objs[i], pop[i]
