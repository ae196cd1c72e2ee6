"""Combinatorial-optimization solvers on the card (counterpart of
``elegantrl_tpu/rlsolver``): batched simulators whose thousands of
candidate solutions are evaluated by products with the graph's adjacency,
the classical search baselines, MCPG, iSCO, PPO on node flips, the genetic
algorithm, the SDP relaxation and QAOA.  Each simulator and solver runs on
``device`` (None: the card) and draws from a ``torch.Generator`` (the JAX
package's ``key``), or replays given draws (``draws=``).

Still to come (ROADMAP.md): ``partition``, ``setcover``, ``bilp``,
``portfolio``, ``exact``, the learned solvers (``s2v_dqn``, ``eco_dqn``,
``runcsp``, ``l2a``, ``attention_tsp``, ``graph_trs``, ``pignn``), ``vrp``
and ``tnco``.
"""
from .graphs import (  # noqa: F401
    generate_graph, read_graph_txt, write_graph_txt, edges_to_adjacency,
    write_graph_result, read_tsplib, write_tsplib, data_path,
    summarize_results,
)
from .maxcut import MaxCutSimulator  # noqa: F401
from .methods import (  # noqa: F401
    random_search, random_walk, greedy_local_search, simulated_annealing,
    greedy_flip_sweeps,
)
from .mcpg import mcpg_solve  # noqa: F401
from .mis import MISSimulator, VertexCoverSimulator, greedy_mis  # noqa: F401
from .isco import isco_solve, isco_mis_solve, isco_tsp_solve  # noqa: F401
from .tsp import TSPSimulator, tsp_solve, random_cities  # noqa: F401
from .ga import genetic_algorithm  # noqa: F401
from .coloring import (  # noqa: F401
    GraphColoringSimulator, color_graph, chromatic_upper_bound,
)
from .knapsack import KnapsackSimulator, knapsack_solve, knapsack_dp  # noqa: F401
from .numberpart import NumberPartitionSimulator  # noqa: F401
from .problems import (  # noqa: F401
    Problem, GraphType, make_simulator, supported_problems, min_vertex_cover,
)
from .sdp import sdp_maxcut  # noqa: F401
from .qaoa import qaoa_maxcut  # noqa: F401
from .ppo_maxcut import maxcut_flip_env, ppo_maxcut_solve  # noqa: F401
