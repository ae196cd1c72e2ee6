"""Classical MaxCut baselines, batched on the simulator's device
(counterpart of ``elegantrl_tpu/rlsolver/methods.py``).

Random search, random walk, greedy local search and simulated annealing,
each over thousands of candidate solutions at once.  Every driver takes
``gen`` (a ``torch.Generator`` on the simulator's device, an int seed, or
a ``Draws``) and ``draws=``, the draws to replay (by name, as each driver
says), and returns ``(best_obj, best_x)`` as tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ._draws import as_draws
from .maxcut import best_of


def _require_maximizer(sim, driver: str) -> None:
    """The batched binary drivers maximize ``sim.obj``; a simulator that
    declares ``if_maximize = False`` (tsp, coloring) minimizes and has a
    non-binary encoding: it is refused rather than optimized the wrong way."""
    if not getattr(sim, 'if_maximize', True):
        raise ValueError(
            f"{driver} maximizes sim.obj over binary solutions; "
            f"{type(sim).__name__} declares if_maximize=False — use its "
            f"dedicated solver (local_search / two_opt) instead")


def greedy_flip_sweeps(sim, xs: torch.Tensor, gen, num_sweeps: int = 4,
                       tie_noise: float = 1e-4, draws=None) -> torch.Tensor:
    """One-flip greedy ascent: each sweep every sim flips its best-gain
    variable where that gain is positive; uniform noise times ``tie_noise``
    (draw ``'tie'``, one a sweep) breaks exact ties, far below the least
    nonzero gain.  The ``local_search_sweep`` of every binary simulator with
    ``flip_gains`` but no search of its own."""
    d = as_draws(gen, xs.device, draws)
    rows = torch.arange(xs.shape[0], device=xs.device)
    for _ in range(int(num_sweeps)):
        gains = sim.flip_gains(xs)
        best = torch.argmax(gains + d.rand('tie', gains.shape) * tie_noise, dim=-1)
        improve = (gains[rows, best] > 0).to(xs.dtype)
        xs = xs.clone()
        xs[rows, best] = torch.abs(xs[rows, best] - improve)
    return xs


def _start(sim, device):
    return (torch.tensor(-float('inf'), device=device),
            torch.zeros(sim.num_nodes, device=device))


def random_search(sim, gen, num_sims: int = 1024, num_rounds: int = 8,
                  draws=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best of ``num_sims * num_rounds`` uniform random solutions (draw
    ``'rand_xs'``, one a round)."""
    _require_maximizer(sim, 'random_search')
    d = as_draws(gen, sim.device, draws)
    best_obj, best_x = _start(sim, sim.device)
    for _ in range(int(num_rounds)):
        xs = sim.rand_xs(d, num_sims)
        best_obj, best_x = best_of(sim.obj(xs), xs, best_obj, best_x)
    return best_obj, best_x


def random_walk(sim, gen, num_sims: int = 1024, num_steps: int = 1024,
                draws=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched random walk: each step flips one uniformly random node of
    every sim, unconditionally (draw ``'node'``, one a step, after
    ``'rand_xs'``), and the best objective ever visited is kept (the
    starting solutions count)."""
    _require_maximizer(sim, 'random_walk')
    d = as_draws(gen, sim.device, draws)
    xs = sim.rand_xs(d, num_sims)
    rows = torch.arange(num_sims, device=sim.device)
    objs = sim.obj(xs)
    i = torch.argmax(objs)
    best_obj, best_x = objs[i], xs[i]
    for _ in range(int(num_steps)):
        nodes = d.randint('node', sim.num_nodes, (num_sims,))
        xs = xs.clone()
        xs[rows, nodes] = 1.0 - xs[rows, nodes]
        best_obj, best_x = best_of(sim.obj(xs), xs, best_obj, best_x)
    return best_obj, best_x


def greedy_local_search(sim, gen, num_sims: int = 1024, num_iters: int = 64,
                        draws=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random restarts (``'rand_xs'``) and ``num_iters`` sweeps of the
    simulator's ``local_search_sweep`` to a local optimum."""
    _require_maximizer(sim, 'greedy_local_search')
    d = as_draws(gen, sim.device, draws)
    xs = sim.rand_xs(d, num_sims)
    xs = sim.local_search_sweep(xs, d, num_sweeps=num_iters)
    return sim.best(xs)


def annealing_temps(t0: float, t1: float, num_steps: int, geometric: bool,
                    device) -> torch.Tensor:
    """The float32 temperature schedule from ``t0`` to ``t1``: geometric
    (simulated annealing) or linear (iSCO)."""
    frac = torch.arange(num_steps, dtype=torch.float32, device=device) / max(num_steps - 1, 1)
    if geometric:
        return t0 * torch.pow(torch.tensor(t1 / t0, dtype=torch.float32, device=device), frac)
    return t0 + (t1 - t0) * frac


def metropolis_flip(xs: torch.Tensor, nodes: torch.Tensor, gains: torch.Tensor,
                    u: torch.Tensor, temp) -> torch.Tensor:
    """Flip ``nodes[s]`` of each sim where its gain is positive or ``u <
    exp(min(gain / temp, 0))``."""
    accept = (u < torch.exp(torch.clamp(gains / temp, max=0.0))) | (gains > 0)
    rows = torch.arange(xs.shape[0], device=xs.device)
    xs = xs.clone()
    xs[rows, nodes] = torch.abs(xs[rows, nodes] - accept.to(xs.dtype))
    return xs


def simulated_annealing(sim, gen, num_sims: int = 1024, num_steps: int = 512,
                        t0: float = 2.0, t1: float = 1e-2,
                        draws=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Metropolis annealing: each step every sim proposes one random
    node flip (``'node'``) and accepts it with ``min(1, exp(gain / T))``
    (``'accept'``) on a geometric temperature schedule from ``t0`` to
    ``t1``; starts from ``'rand_xs'``."""
    _require_maximizer(sim, 'simulated_annealing')
    d = as_draws(gen, sim.device, draws)
    xs = sim.rand_xs(d, num_sims)
    temps = annealing_temps(t0, t1, int(num_steps), True, sim.device)
    rows = torch.arange(num_sims, device=sim.device)
    best_obj, best_x = _start(sim, sim.device)
    for t in range(int(num_steps)):
        nodes = d.randint('node', sim.num_nodes, (num_sims,))
        u = d.rand('accept', (num_sims,))
        gains = sim.flip_gains(xs)[rows, nodes]
        xs = metropolis_flip(xs, nodes, gains, u, temps[t])
        best_obj, best_x = best_of(sim.obj(xs), xs, best_obj, best_x)
    return best_obj, best_x
