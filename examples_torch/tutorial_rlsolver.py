"""Tutorial: the combinatorial-optimization (rlsolver) layer, on the card.

The PyTorch counterpart of ``examples/tutorial_rlsolver.py``: the same
workflow as the reference's rlsolver README — generate or load an
instance, run classical baselines, then an RL/MCMC solver, and write a
result file (``rlsolver/methods/util_result.py`` style) — on the port's
batched simulators.  Every solver runs on ``device`` (None: the card) and
draws from a generator seeded with 0.

Run:  python examples_torch/tutorial_rlsolver.py [--device cpu]

Output: one line per problem (MaxCut on a BA-128 graph: random search,
greedy local search, simulated annealing, MCPG; the TSPLIB sample tour;
the Solomon-format VRPTW sample; knapsack GA against the exact DP; the
matrix-chain TNCO by annealing against its DP optimum) and the result
file's path under the temporary directory.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import numpy as np                                          # noqa: E402

from elegantrl_tpu_torch.rlsolver import (                  # noqa: E402
    MaxCutSimulator, generate_graph, random_search, greedy_local_search,
    simulated_annealing, mcpg_solve, write_graph_result,
    read_tsplib, data_path, tsp_solve,
    vrptw_solve, genetic_algorithm,
)
from elegantrl_tpu_torch.rlsolver.graphs import read_solomon          # noqa: E402
from elegantrl_tpu_torch.rlsolver.knapsack import KnapsackSimulator, knapsack_dp  # noqa: E402


def main(device=None):
    seed = 0

    # 1) MaxCut on a synthetic Barabasi-Albert graph: classical baselines
    #    vs MCPG (reference: methods/{greedy,simulated_annealing,mcpg}.py)
    edges = generate_graph('BA', 128, seed=0)
    sim = MaxCutSimulator(edges, 128, device=device)
    r, _ = random_search(sim, seed, num_sims=512)
    g, _ = greedy_local_search(sim, seed, num_sims=512)
    s, _ = simulated_annealing(sim, seed, num_sims=512, num_steps=512)
    m, x, _ = mcpg_solve(sim, seed, num_chains=512, num_epochs=30)
    print(f"[maxcut BA-128] random {float(r):.0f}  greedy-LS {float(g):.0f}"
          f"  SA {float(s):.0f}  MCPG {float(m):.0f}")

    # 2) TSP from a TSPLIB file (bundled sample; berlin52 etc. load the same)
    cities = read_tsplib(data_path('rand48.tsp'))
    length, _ = tsp_solve(cities, seed, num_sims=256, num_iters=64, device=device)
    print(f"[tsp rand48 / TSPLIB] tour {length:.1f} (2-opt over 256 starts)")

    # 3) VRPTW from a Solomon-format file (bundled sample; c101 loads the same)
    inst = read_solomon(data_path('rand24_vrptw.txt'))
    dist, _, veh = vrptw_solve(inst, seed, num_sims=256, device=device)
    print(f"[vrptw rand24 / Solomon] dist {dist:.1f} with {veh} vehicles")

    # 4) Knapsack: memetic GA vs the exact vectorized DP ground truth
    rng = np.random.default_rng(1)
    values = rng.uniform(10, 100, 64)
    weights = rng.uniform(5, 50, 64)
    ksim = KnapsackSimulator(values, weights, capacity=400.0, device=device)
    ga_val, _ = genetic_algorithm(ksim, seed, pop_size=256, num_generations=48)
    exact = knapsack_dp(values.astype(int), weights.astype(int), 400, device=device)
    print(f"[knapsack n=64] GA {float(ga_val):.1f} vs exact DP {float(exact):.1f}")

    # 5) Tensor-network contraction ordering (TNCO): SA over edge priorities
    #    finds the exact matrix-chain DP optimum (the reference's
    #    env_l2a_TNCO.py imports a simulator absent from its tree)
    from elegantrl_tpu_torch.rlsolver import matrix_chain, matrix_chain_dp, tnco_anneal
    dims = [32, 2, 64, 4, 128, 2]
    tsim = matrix_chain(dims, device=device)
    sa_log2, _ = tnco_anneal(tsim, seed, num_sims=256, num_steps=128)
    print(f"[tnco matrix-chain] SA {2.0 ** float(sa_log2):.0f} multiplies "
          f"vs exact DP {matrix_chain_dp(dims):.0f}")

    # 6) Result file, reference util_result.write_graph_result style
    out = write_graph_result(float(m), 0.0, 128, 'mcpg', x.cpu().numpy(),
                             os.path.join(tempfile.gettempdir(), 'rlsolver_tutorial',
                                          'maxcut_BA128'))
    print(f"result file written: {out}")
    return {'maxcut': (float(r), float(g), float(s), float(m)), 'tsp': length,
            'vrptw': (dist, veh), 'knapsack': (float(ga_val), float(exact)),
            'tnco': (float(sa_log2), matrix_chain_dp(dims))}


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--device', default=None, help="'cuda' (default) or 'cpu'")
    main(parser.parse_args().device)
