"""Combinatorial-optimization solvers on the card (counterpart of
``elegantrl_tpu/rlsolver``): batched simulators whose thousands of
candidate solutions are evaluated by products with the problem's matrices,
the classical search baselines, MCPG, iSCO, PPO on node flips, the genetic
algorithm, the SDP relaxation, QAOA, the learned solvers (S2V-DQN,
ECO-DQN, RUN-CSP, L2A with the GraphTRS pretrain, the attention-model TSP
constructor, PI-GNN) and the optional exact wrappers.  Each simulator and
solver runs on ``device`` (None: the card; a learned solver's inference on
its parameters' device) and draws from a ``torch.Generator`` (the JAX
package's ``key``), or replays given draws (``draws=``).  The VRPTW
constructor and the tensor-network contraction ordering (TNCO) solvers
complete the JAX package's set.
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
from .s2v_dqn import make_s2v_dqn, s2v_dqn_solve  # noqa: F401
from .eco_dqn import (build_pool, make_eco_dqn, eco_greedy_solve,  # noqa: F401
                      init_mpnn, mpnn_q)
from .runcsp import make_runcsp, runcsp_solve  # noqa: F401
from .tsp import TSPSimulator, tsp_solve, random_cities  # noqa: F401
from .attention_tsp import make_attention_tsp, train_attention_tsp  # noqa: F401
from .l2a import make_l2a, l2a_solve  # noqa: F401
from .graph_trs import make_graph_trs, pretrain_graph_trs  # noqa: F401
from .ga import genetic_algorithm  # noqa: F401
from .vrp import VRPTWSimulator, vrptw_solve, random_vrptw  # noqa: F401
from .tnco import (TNCOSimulator, tnco_greedy, tnco_anneal,  # noqa: F401
                   matrix_chain, matrix_chain_dp, random_tn, grid_tn)
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
from .exact import (  # noqa: F401
    SolverUnavailable, gurobi_solve_maxcut, gurobi_solve_knapsack,
    scip_solve_maxcut,
)
from .partition import GraphPartitionSimulator  # noqa: F401
from .setcover import SetCoverSimulator  # noqa: F401
from .bilp import BILPSimulator  # noqa: F401
from .portfolio import PortfolioSimulator  # noqa: F401
from .ppo_maxcut import maxcut_flip_env, ppo_maxcut_solve  # noqa: F401
from .pignn import (  # noqa: F401
    pignn_minimize, pignn_maxcut, pignn_mis, maxcut_qubo, mis_qubo,
)
