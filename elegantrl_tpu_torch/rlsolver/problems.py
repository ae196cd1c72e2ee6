"""Problem registry: the reference's ``Problem`` enum mapped to simulators
(counterpart of ``elegantrl_tpu/rlsolver/problems.py``).

Every problem of the enum has a batched simulator in both packages.
``minimum_vertex_cover`` is solved through the complement of the MIS
simulator (a set is a cover iff its complement is independent).
"""

from __future__ import annotations

from enum import Enum, unique
from typing import Tuple

import numpy as np
import torch


@unique
class GraphType(Enum):
    BA = "BA"   # barabasi_albert
    ER = "ER"   # erdos_renyi
    PL = "PL"   # powerlaw


@unique
class Problem(Enum):
    maxcut = "maxcut"
    graph_partitioning = "graph_partitioning"
    number_partitioning = "number_partitioning"
    minimum_vertex_cover = "minimum_vertex_cover"
    bilp = "bilp"
    maximum_independent_set = "maximum_independent_set"
    knapsack = "knapsack"
    set_cover = "set_cover"
    graph_coloring = "graph_coloring"
    portfolio_allocation = "portfolio_allocation"
    tnco = "tnco"
    vrp = "vrp"
    tsp = "tsp"


def supported_problems() -> set:
    """The problems with a batched simulator in the port: all of them."""
    return set(Problem)


_REQUIRED_KWARGS = {
    Problem.maxcut: ('edges', 'num_nodes'),
    Problem.maximum_independent_set: ('edges', 'num_nodes'),
    Problem.minimum_vertex_cover: ('edges', 'num_nodes'),
    Problem.graph_coloring: ('edges', 'num_nodes', 'num_colors'),
    Problem.knapsack: ('values', 'weights', 'capacity'),
    Problem.number_partitioning: ('numbers',),
    Problem.tsp: ('cities',),
    Problem.graph_partitioning: ('edges', 'num_nodes'),
    Problem.set_cover: ('membership',),
    Problem.bilp: ('c', 'a', 'b'),
    Problem.vrp: ('instance',),
    Problem.portfolio_allocation: ('mu', 'sigma', 'k'),
    Problem.tnco: ('bonds_log2',),
}


def make_simulator(problem: Problem, device=None, **kwargs):
    """The batched simulator of ``problem`` on ``device`` (None: the card).
    kwargs are the problem's own parameters (edges/num_nodes,
    values/weights/capacity, numbers, cities, num_colors, ...)."""
    if isinstance(problem, str):
        problem = Problem(problem)
    missing = [k for k in _REQUIRED_KWARGS.get(problem, ()) if k not in kwargs]
    if missing:
        raise TypeError(
            f"make_simulator({problem}) missing required kwargs {missing}; "
            f"expects {_REQUIRED_KWARGS[problem]}")
    if problem == Problem.maxcut:
        from .maxcut import MaxCutSimulator
        return MaxCutSimulator(kwargs['edges'], kwargs['num_nodes'], device=device)
    if problem == Problem.maximum_independent_set:
        from .mis import MISSimulator
        return MISSimulator(kwargs['edges'], kwargs['num_nodes'],
                            penalty=kwargs.get('penalty', 2.0), device=device)
    if problem == Problem.minimum_vertex_cover:
        # the cover-space wrapper: solutions and objectives are covers
        from .mis import VertexCoverSimulator
        return VertexCoverSimulator(kwargs['edges'], kwargs['num_nodes'],
                                    penalty=kwargs.get('penalty', 2.0), device=device)
    if problem == Problem.graph_coloring:
        from .coloring import GraphColoringSimulator
        return GraphColoringSimulator(kwargs['edges'], kwargs['num_nodes'],
                                      kwargs['num_colors'], device=device)
    if problem == Problem.knapsack:
        from .knapsack import KnapsackSimulator
        return KnapsackSimulator(kwargs['values'], kwargs['weights'], kwargs['capacity'],
                                 penalty=kwargs.get('penalty'), device=device)
    if problem == Problem.number_partitioning:
        from .numberpart import NumberPartitionSimulator
        return NumberPartitionSimulator(kwargs['numbers'], device=device)
    if problem == Problem.graph_partitioning:
        from .partition import GraphPartitionSimulator
        return GraphPartitionSimulator(kwargs['edges'], kwargs['num_nodes'],
                                       penalty=kwargs.get('penalty', 2.0), device=device)
    if problem == Problem.set_cover:
        from .setcover import SetCoverSimulator
        return SetCoverSimulator(kwargs['membership'], penalty=kwargs.get('penalty'),
                                 device=device)
    if problem == Problem.bilp:
        from .bilp import BILPSimulator
        return BILPSimulator(kwargs['c'], kwargs['a'], kwargs['b'],
                             penalty=kwargs.get('penalty'), device=device)
    if problem == Problem.vrp:
        from .vrp import VRPTWSimulator
        return VRPTWSimulator(kwargs['instance'], device=device)
    if problem == Problem.tnco:
        from .tnco import TNCOSimulator
        return TNCOSimulator(kwargs['bonds_log2'], open_log2=kwargs.get('open_log2'),
                             device=device)
    if problem == Problem.portfolio_allocation:
        from .portfolio import PortfolioSimulator
        return PortfolioSimulator(kwargs['mu'], kwargs['sigma'], kwargs['k'],
                                  risk_lambda=kwargs.get('risk_lambda', 1.0),
                                  penalty=kwargs.get('penalty'), device=device)
    from .tsp import TSPSimulator
    return TSPSimulator(kwargs['cities'], device=device)


def min_vertex_cover(edges: np.ndarray, num_nodes: int, gen, num_sims: int = 512,
                     num_sweeps: int = 32, device=None,
                     draws=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Minimum vertex cover through the MIS complement: ``|MVC| = N -
    |MIS|`` and the cover is the independent set's complement
    (``mis.greedy_mis``'s draws)."""
    from .mis import greedy_mis
    sim = make_simulator(Problem.maximum_independent_set, edges=edges, num_nodes=num_nodes,
                         device=device)
    mis_size, mis_x = greedy_mis(sim, gen, num_sims=num_sims, num_sweeps=num_sweeps,
                                 draws=draws)
    return float(num_nodes) - mis_size, 1.0 - mis_x
