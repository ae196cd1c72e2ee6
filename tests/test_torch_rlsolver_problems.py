"""``elegantrl_tpu_torch/rlsolver``'s other problems and solvers against
``elegantrl_tpu/rlsolver`` on the CPU: MIS and vertex cover, TSP with its
iSCO, the genetic algorithm, the SDP relaxation, QAOA, coloring, knapsack,
number partitioning and the registry, each on the JAX package's draws
(``tests/rlsolver_jax_draws.py``) where it draws, and the JAX package's
quality tests (``tests/test_rlsolver.py``, ``tests/test_rlsolver_extra.py``,
``tests/test_rlsolver_problems2.py``) for what the port has.

Tolerances: integer objectives, sets, colorings and tours exact; float
objectives (tour lengths, knapsack and partition values) rtol 1e-5, the
distance table rtol 1e-6 (XLA may fuse its squares and sum); the
SDP's cut exact on the JAX draws (300 ascent steps whose products sum in
another order round to the same signs); QAOA's expectation rtol 1e-4 (150
gradient steps through a complex statevector).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu import rlsolver as jr
from elegantrl_tpu_torch import rlsolver as r
from rlsolver_jax_draws import (add, bern, color_graph_draws, coloring_ls_draws, ga_draws,
                                greedy_ls_draws, isco_draws, isco_tsp_draws, permutations_each,
                                random_search_draws, sa_draws, sdp_draws, split, sweep_draws)

CPU = 'cpu'
KEY = jax.random.key(0)
K4 = np.array([(0, 1, 1), (0, 2, 1), (0, 3, 1), (1, 2, 1), (1, 3, 1), (2, 3, 1)], np.float64)
K33 = np.array([[i, 3 + j, 1.0] for i in range(3) for j in range(3)])
PETERSEN = np.array(
    [(0, 1, 1), (1, 2, 1), (2, 3, 1), (3, 4, 1), (4, 0, 1),
     (5, 7, 1), (7, 9, 1), (9, 6, 1), (6, 8, 1), (8, 5, 1),
     (0, 5, 1), (1, 6, 1), (2, 7, 1), (3, 8, 1), (4, 9, 1)], np.float64)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small products: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got.cpu() if torch.is_tensor(got) else got),
                                  np.asarray(want))


def _t(x, dtype=np.float32):
    return torch.tensor(np.asarray(x, dtype))


def _ba64():
    return r.read_graph_txt(r.data_path('syn_BA_64.txt'))


# -------------------------------------------------------- MIS, vertex cover

def test_mis_simulator_and_greedy_mis_as_jax():
    n, edges = _ba64()
    sim, jsim = r.MISSimulator(edges, n, device=CPU), jr.MISSimulator(edges, n)
    jxs = jsim.rand_xs(jax.random.key(1), 16)
    xs = _t(jxs)
    for f in ('obj', 'num_conflicts', 'flip_gains'):
        _same(getattr(sim, f)(xs), getattr(jsim, f)(jxs))
    key = jax.random.key(2)
    _same(sim.local_search(xs, None, 5, draws=sweep_draws(key, (16, n), 5)),
          jsim.local_search(jxs, key, 5))
    key = jax.random.key(3)
    obj, x = r.greedy_mis(sim, None, num_sims=16, num_sweeps=6,
                          draws=greedy_ls_draws(key, 16, n, 6, p=0.15))
    jobj, jx = jr.greedy_mis(jsim, key, num_sims=16, num_sweeps=6)
    assert float(obj) == float(jobj)
    _same(x, jx)
    vc, jvc = r.VertexCoverSimulator(edges, n, device=CPU), jr.VertexCoverSimulator(edges, n)
    cover = 1.0 - xs
    for f in ('obj', 'num_uncovered', 'flip_gains'):
        _same(getattr(vc, f)(cover), getattr(jvc, f)(1.0 - jxs))
    size, c = vc.best(cover)
    jsize, jc = jvc.best(1.0 - jxs)
    assert float(size) == float(jsize)
    _same(c, jc)


def test_isco_mis_as_jax():
    """iSCO on the MIS gains and its repair pass, on the JAX draws."""
    n, edges = _ba64()
    sim, jsim = r.MISSimulator(edges, n, device=CPU), jr.MISSimulator(edges, n)
    key = jax.random.key(4)
    k_isco, k_rep = split(key)
    draws = add(isco_draws(k_isco, 16, n, 12, 4, p=0.15), sweep_draws(k_rep, (1, n), 8))
    size, x = r.isco_mis_solve(sim, None, num_sims=16, num_steps=12, draws=draws)
    jsize, jx = jr.isco_mis_solve(jsim, key, num_sims=16, num_steps=12)
    assert float(size) == float(jsize)
    _same(x, jx)


def test_mis_on_known_graphs():
    star = np.array([[0, i, 1.0] for i in range(1, 6)])   # MIS: the 5 leaves
    obj, x = r.greedy_mis(r.MISSimulator(star, 6, device=CPU), 0, num_sims=64)
    assert float(obj) == 5.0 and float(x[0]) == 0.0
    sim2 = r.MISSimulator(K33, 6, device=CPU)             # MIS: one side, 3
    obj2, x2 = r.greedy_mis(sim2, 1, num_sims=64)
    assert float(obj2) == 3.0 and float(sim2.num_conflicts(x2[None])[0]) == 0.0


def test_isco_mis_matches_greedy():
    edges = r.generate_graph('ER', 48, seed=3, avg_degree=6)
    sim = r.MISSimulator(edges, 48, device=CPU)
    g_obj, _ = r.greedy_mis(sim, 0, num_sims=128)
    i_obj, i_x = r.isco_mis_solve(sim, 1, num_sims=256, num_steps=192)
    assert float(sim.num_conflicts(i_x[None])[0]) == 0.0
    assert float(i_obj) >= float(g_obj) - 1.0, (float(i_obj), float(g_obj))


def test_min_vertex_cover_as_jax_and_petersen():
    key = jax.random.key(5)
    size, cover = r.min_vertex_cover(PETERSEN, 10, None, num_sims=32, num_sweeps=8,
                                     device=CPU, draws=greedy_ls_draws(key, 32, 10, 8, p=0.15))
    jsize, jcover = jr.min_vertex_cover(PETERSEN, 10, key, num_sims=32, num_sweeps=8)
    assert float(size) == float(jsize)
    _same(cover, jcover)
    size, cover = r.min_vertex_cover(PETERSEN, 10, 0, device=CPU)   # optimum 6
    assert float(size) == 6.0
    c = cover.numpy()
    assert all(c[int(i)] + c[int(j)] >= 1 for i, j, _ in PETERSEN)


def test_vertex_cover_registry_returns_cover_space():
    edges = np.array([[0, 1, 1.0], [1, 2, 1.0]])      # path 0-1-2: cover {1}
    sim = r.make_simulator(r.Problem.minimum_vertex_cover, edges=edges, num_nodes=3,
                           device=CPU)
    xs = sim.local_search(sim.rand_xs(0, 256), 1)
    size, cover = sim.best(xs)
    assert float(size) == 1.0 and np.allclose(cover.numpy(), [0, 1, 0])
    assert float(sim.num_uncovered(cover[None])[0]) == 0.0
    assert float(sim.obj(cover[None])[0]) == -1.0


def test_vertex_cover_with_generic_sa():
    edges = np.array([[0, i, 1.0] for i in range(1, 5)])   # star: the center covers all
    sim = r.make_simulator(r.Problem.minimum_vertex_cover, edges=edges, num_nodes=5,
                           device=CPU)
    obj, x = r.simulated_annealing(sim, 0, num_sims=128, num_steps=256)
    assert float(sim.num_uncovered(x[None])[0]) == 0.0 and float(obj) == -1.0


# -------------------------------------------------------------------- TSP

def test_tsp_as_jax():
    """Tour lengths, nearest neighbour on the JAX starts, 2-opt, tsp_solve
    and iSCO on permutations, on the JAX draws."""
    cities = r.read_tsplib(r.data_path('rand48.tsp'))
    sim, jsim = r.TSPSimulator(cities, device=CPU), jr.TSPSimulator(cities)
    np.testing.assert_allclose(sim.dist.numpy(), np.asarray(jsim.dist), rtol=1e-6)
    jt = jsim.rand_tours(jax.random.key(1), 8)
    tours = sim.rand_tours(None, 8, draws={'rand_tours': [np.asarray(jt)]})
    np.testing.assert_allclose(sim.tour_length(tours).numpy(), np.asarray(jsim.tour_length(jt)),
                               rtol=1e-5)
    _same(sim.two_opt(tours, 12), jsim.two_opt(jt, 12))
    key = jax.random.key(2)
    starts = np.asarray(jax.random.randint(key, (8,), 0, 48))
    _same(sim.nearest_neighbor(None, 8, draws={'start': [starts]}),
          jsim.nearest_neighbor(key, 8))
    k1, _ = split(key)
    length, tour = r.tsp_solve(cities, None, num_sims=8, num_iters=12, device=CPU,
                               draws={'start': [np.asarray(jax.random.randint(k1, (8,), 0, 48))]})
    jlength, jtour = jr.tsp_solve(cities, key, num_sims=8, num_iters=12)
    np.testing.assert_allclose(length, jlength, rtol=1e-5)
    _same(tour, jtour)
    key = jax.random.key(3)
    small = r.random_cities(12, seed=1)
    sim, jsim = r.TSPSimulator(small, device=CPU), jr.TSPSimulator(small)
    blen, btour = r.isco_tsp_solve(sim, None, num_sims=8, num_steps=40,
                                   draws=isco_tsp_draws(key, 8, 12, 40))
    jblen, jbtour = jr.isco_tsp_solve(jsim, key, num_sims=8, num_steps=40)
    np.testing.assert_allclose(float(blen), float(jblen), rtol=1e-5)
    _same(btour, jbtour)


def test_tsp_square_optimal():
    square = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.float32)
    length, tour = r.tsp_solve(square, 0, num_sims=16, num_iters=8, device=CPU)
    assert abs(length - 4.0) < 1e-5 and sorted(tour.tolist()) == [0, 1, 2, 3]


def test_tsp_two_opt_improves_random():
    sim = r.TSPSimulator(r.random_cities(30, seed=1), device=CPU)
    tours = sim.rand_tours(0, 64)
    before = float(sim.tour_length(tours).min())
    after_tours = sim.two_opt(tours, num_iters=64)
    after = float(sim.tour_length(after_tours).min())
    assert after < before * 0.75
    nn = sim.two_opt(sim.nearest_neighbor(1, 64), 64)
    assert float(sim.tour_length(nn).min()) <= after * 1.05
    assert (np.sort(after_tours.numpy(), axis=-1) == np.arange(30)).all()


def test_tsplib_solve_bundled_instance():
    cities = r.read_tsplib(r.data_path('rand48.tsp'))
    length, tour = r.tsp_solve(cities, 0, num_sims=64, num_iters=32, device=CPU)
    sim = r.TSPSimulator(cities, device=CPU)
    rand_len = float(torch.mean(sim.tour_length(sim.rand_tours(1, 64))))
    assert sorted(tour.tolist()) == list(range(48)) and length < 0.7 * rand_len


def test_isco_tsp_beats_nearest_neighbor():
    cities = r.random_cities(20, seed=4)
    sim = r.TSPSimulator(cities, device=CPU)
    nn_len = float(sim.tour_length(sim.nearest_neighbor(0, 1)).min())
    length, tour = r.isco_tsp_solve(sim, 1, num_sims=64, num_steps=300)
    assert sorted(tour.tolist()) == list(range(20)) and float(length) < nn_len


# --------------------------------------------------------- GA, SDP, QAOA

def test_genetic_algorithm_as_jax():
    n, edges = _ba64()
    sim, jsim = r.MaxCutSimulator(edges, n, device=CPU), jr.MaxCutSimulator(edges, n)
    key = jax.random.key(6)
    obj, x = r.genetic_algorithm(sim, None, pop_size=24, num_generations=6,
                                 draws=ga_draws(key, 24, n, 6, 2))
    jobj, jx = jr.genetic_algorithm(jsim, key, pop_size=24, num_generations=6)
    assert float(obj) == float(jobj)
    _same(x, jx)


def test_sdp_maxcut_as_jax_and_gw_quality():
    n, edges = _ba64()
    key = jax.random.key(7)
    cut, x = r.sdp_maxcut(edges, n, None, num_roundings=256, device=CPU,
                          draws=sdp_draws(key, n, 12, 256))
    jcut, jx = jr.sdp_maxcut(edges, n, key, num_roundings=256)
    assert float(cut) == float(jcut)
    sim = r.MaxCutSimulator(edges, n, device=CPU)
    assert float(sim.obj(x[None])[0]) == float(cut)
    cut4, _ = r.sdp_maxcut(K4, 4, 0, device=CPU)
    assert float(cut4) == 4.0
    edges = r.generate_graph('BA', 64, seed=3)
    sim = r.MaxCutSimulator(edges, 64, device=CPU)
    sdp_cut, sdp_x = r.sdp_maxcut(edges, 64, 0, device=CPU)
    sa_cut, _ = r.simulated_annealing(sim, 0, num_sims=128, num_steps=256)
    assert float(sim.obj(sdp_x[None])[0]) == float(sdp_cut)
    assert float(sdp_cut) >= 0.95 * float(sa_cut), (float(sdp_cut), float(sa_cut))


def test_qaoa_maxcut_as_jax_and_small_graphs():
    ring = np.array([(0, 1, 1), (1, 2, 1), (2, 3, 1), (3, 0, 1)], np.float64)
    cut, x, exp_c = r.qaoa_maxcut(ring, 4, None, p_layers=3, device=CPU)
    jcut, jx, jexp = jr.qaoa_maxcut(ring, 4, KEY, p_layers=3)
    assert float(cut) == float(jcut) == 4.0
    _same(x, jx)
    np.testing.assert_allclose(float(exp_c), float(jexp), rtol=1e-4)
    assert float(exp_c) > 2.5
    cut4, _, _ = r.qaoa_maxcut(K4, 4, None, p_layers=2, device=CPU)
    assert float(cut4) == 4.0


def test_ga_finds_k4_maxcut_optimum():
    sim = r.MaxCutSimulator(K4, 4, device=CPU)
    best, x = r.genetic_algorithm(sim, 0, pop_size=64, num_generations=8)
    assert float(best) == 4.0 and float(sim.obj(x[None])[0]) == 4.0


def test_ga_matches_sa_on_ba_graph():
    sim = r.MaxCutSimulator(r.generate_graph('BA', 64, seed=3), 64, device=CPU)
    ga_best, _ = r.genetic_algorithm(sim, 0, pop_size=128, num_generations=24)
    sa_best, _ = r.simulated_annealing(sim, 0, num_sims=128, num_steps=256)
    assert float(ga_best) >= 0.95 * float(sa_best)


# -------------------------------------------- coloring, knapsack, partition

def test_coloring_as_jax():
    sim, jsim = (r.GraphColoringSimulator(PETERSEN, 10, 3, device=CPU),
                 jr.GraphColoringSimulator(PETERSEN, 10, 3))
    jxs = jsim.rand_xs(jax.random.key(1), 16)
    xs = _t(jxs, np.int64)
    _same(sim.obj(xs), jsim.obj(jxs))
    _same(sim.color_conflicts(xs), jsim.color_conflicts(jxs))
    key = jax.random.key(2)
    _same(sim.local_search(xs, None, 6, draws=coloring_ls_draws(key, 16, 10, 3, 6)),
          jsim.local_search(jxs, key, 6))
    conflicts, colors = r.color_graph(sim, None, num_sims=16, num_sweeps=6,
                                      draws=color_graph_draws(key, 16, 10, 3, 6))
    jconflicts, jcolors = jr.color_graph(jsim, key, num_sims=16, num_sweeps=6)
    assert float(conflicts) == float(jconflicts)
    _same(colors, jcolors)


def test_coloring_petersen_chromatic_3():
    sim3 = r.GraphColoringSimulator(PETERSEN, 10, 3, device=CPU)
    conflicts, colors = r.color_graph(sim3, 0, num_sims=256, num_sweeps=32)
    assert float(conflicts) == 0.0
    c = colors.numpy()
    assert all(c[int(i)] != c[int(j)] for i, j, _ in PETERSEN)
    sim2 = r.GraphColoringSimulator(PETERSEN, 10, 2, device=CPU)   # odd cycles
    conflicts2, _ = r.color_graph(sim2, 0, num_sims=256, num_sweeps=32)
    assert float(conflicts2) > 0.0
    assert r.chromatic_upper_bound(r.GraphColoringSimulator, PETERSEN, 10, 0, k_max=6,
                                   device=CPU) == 3
    sim = r.GraphColoringSimulator(K4, 4, 2, device=CPU)
    assert float(sim.obj(torch.zeros((1, 4), dtype=torch.int64))[0]) == 6.0
    assert float(sim.obj(torch.tensor([[0, 0, 1, 1]]))[0]) == 2.0


def _knapsack_instance(n=24, seed=11):
    rng = np.random.default_rng(seed)
    values = rng.integers(1, 100, n).astype(np.float64)
    weights = rng.integers(1, 50, n)
    return values, weights, int(weights.sum() // 3)


def test_knapsack_as_jax():
    """The simulator's objective, gains and feasible value; the exact
    program; and the memetic solver on the JAX draws."""
    values, weights, cap = _knapsack_instance()
    sim, jsim = (r.KnapsackSimulator(values, weights, cap, device=CPU),
                 jr.KnapsackSimulator(values, weights, cap))
    assert sim.penalty == jsim.penalty and sim.infeasible_penalty == jsim.infeasible_penalty
    jxs = jsim.rand_xs(jax.random.key(1), 8)
    xs = _t(jxs)
    for f in ('obj', 'flip_gains', 'feasible_value'):
        np.testing.assert_allclose(getattr(sim, f)(xs).numpy(), np.asarray(getattr(jsim, f)(jxs)),
                                   rtol=1e-5)
    assert r.knapsack_dp(values, weights, cap, device=CPU) == jr.knapsack_dp(values, weights, cap)
    key = jax.random.key(2)
    p = min(0.5, cap / float(weights.sum()))
    val, x = r.knapsack_solve(sim, None, num_sims=16, num_generations=5,
                              draws=ga_draws(key, 16, 24, 5, 2, search='tie', p=p))
    jval, jx = jr.knapsack_solve(jsim, key, num_sims=16, num_generations=5)
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-5)
    _same(x, jx)


def test_knapsack_dp_vs_bruteforce():
    rng = np.random.default_rng(5)
    values = rng.integers(1, 50, 12).astype(np.float64)
    weights = rng.integers(1, 20, 12)
    best = max((float(values[[i for i in range(12) if m >> i & 1]].sum())
                for m in range(1 << 12)
                if weights[[i for i in range(12) if m >> i & 1]].sum() <= 40), default=0.0)
    assert r.knapsack_dp(values, weights, 40, device=CPU) == best


def test_knapsack_heuristic_near_dp_optimum():
    values, weights, cap = _knapsack_instance(64, 11)
    opt = r.knapsack_dp(values, weights, cap, device=CPU)
    sim = r.KnapsackSimulator(values, weights, cap, device=CPU)
    val, x = r.knapsack_solve(sim, 0, num_sims=256, num_generations=64)
    assert float(x.numpy() @ weights) <= cap
    assert float(val) >= 0.99 * opt, (float(val), opt)


def test_knapsack_infeasible_item_rejected():
    sim = r.KnapsackSimulator(values=[100.0], weights=[10.0], capacity=9.0, device=CPU)
    assert float(sim.obj(torch.tensor([[1.0]]))[0]) < 0.0   # below the empty set
    v, x = r.knapsack_solve(sim, 0, num_sims=32, num_generations=8)
    assert float(v) == 0.0 and float(x[0]) == 0.0


def test_number_partition_as_jax_and_perfect_split():
    numbers = np.array([30, 4, 5, 6, 7, 8], np.float64)
    sim, jsim = r.NumberPartitionSimulator(numbers, device=CPU), jr.NumberPartitionSimulator(numbers)
    key = jax.random.key(3)
    jxs = jsim.rand_xs(key, 8)
    xs = _t(jxs)
    for f in ('obj', 'imbalance', 'flip_gains'):
        _same(getattr(sim, f)(xs), getattr(jsim, f)(jxs))
    _same(sim.local_search_sweep(xs, None, 3, draws=sweep_draws(key, (8, 6), 3, 'tie')),
          jsim.local_search_sweep(jxs, key, 3))
    obj, x = r.simulated_annealing(sim, None, num_sims=16, num_steps=32,
                                   draws=sa_draws(key, 16, 6, 32))
    jobj, jx = jr.simulated_annealing(jsim, key, num_sims=16, num_steps=32)
    assert float(obj) == float(jobj)
    _same(x, jx)
    best, x = r.simulated_annealing(sim, 0, num_sims=256, num_steps=256)
    assert float(best) == 0.0 and float(sim.imbalance(x[None])[0]) == 0.0
    best_ga, _ = r.genetic_algorithm(sim, 0, pop_size=128, num_generations=16)
    assert float(best_ga) == 0.0


# ---------------------------------------------------------------- registry

def test_problem_registry():
    """The same enums; every problem of the enum builds its simulator."""
    assert [p.value for p in r.Problem] == [p.value for p in jr.Problem]
    assert [g.value for g in r.GraphType] == [g.value for g in jr.GraphType]
    assert r.supported_problems() == set(r.Problem)
    sim = r.make_simulator('maxcut', edges=K4, num_nodes=4, device=CPU)
    assert float(sim.obj(torch.tensor([[0., 0., 1., 1.]]))[0]) == 4.0
    assert isinstance(r.make_simulator(r.Problem.graph_coloring, edges=K4, num_nodes=4,
                                       num_colors=4, device=CPU), r.GraphColoringSimulator)
    assert isinstance(r.make_simulator('tsp', cities=r.random_cities(5), device=CPU),
                      r.TSPSimulator)
    with pytest.raises(TypeError, match='instance'):
        r.make_simulator(r.Problem.vrp)
    assert isinstance(r.make_simulator(r.Problem.vrp, instance=r.random_vrptw(4), device=CPU),
                      r.VRPTWSimulator)
    assert r.make_simulator('tnco', bonds_log2=np.ones((2, 2)) - np.eye(2),
                            device=CPU).num_edges == 1


def test_generic_drivers_reject_minimizing_sims():
    edges = np.array([[0, 1, 1.0], [1, 2, 1.0]])
    coloring = r.make_simulator(r.Problem.graph_coloring, edges=edges, num_nodes=3,
                                num_colors=2, device=CPU)
    for driver in (r.simulated_annealing, r.genetic_algorithm, r.random_search,
                   r.greedy_local_search, r.random_walk):
        with pytest.raises(ValueError, match='if_maximize'):
            driver(coloring, 0)
