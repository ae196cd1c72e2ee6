"""``elegantrl_tpu_torch/rlsolver``'s VRPTW and TNCO solvers against
``elegantrl_tpu/rlsolver`` on the CPU.

The instance generators are numpy copies, equal bit for bit.  With the JAX
draws replayed (``tests/rlsolver_jax_draws.py``) the VRPTW constructions
give the same tours (distances rtol 1e-5: float32 sums in another order;
vehicle counts and completeness exactly), and the TNCO costs and peaks
agree within 1e-4 in log2 (a row sum per merge, summed in another order),
the greedy merges and the annealed priorities are the same.  The port's
own draws are held to the JAX package's quality checks
(``tests/test_vrp.py``, ``tests/test_tnco.py``), with copies of their
independent host checkers."""
import itertools

import jax
import numpy as np
import pytest
import torch

import elegantrl_tpu.rlsolver as jr
import elegantrl_tpu_torch.rlsolver as r
from elegantrl_tpu.rlsolver.graphs import read_solomon as j_read_solomon
from elegantrl_tpu_torch.rlsolver.graphs import data_path, read_solomon
from rlsolver_jax_draws import tnco_anneal_draws, tnco_greedy_draws, vrptw_draws

CPU = torch.device('cpu')
KEY = jax.random.PRNGKey(0)


def _validate(inst, tour):
    """Host-side independent checker (``tests/test_vrp.py``): visit counts,
    capacity, windows."""
    demand, ready = inst['demand'], inst['ready']
    due, service = inst['due'], inst['service']
    xy = np.asarray(inst['xy'])
    dist = lambda a, b: float(np.hypot(*(xy[a] - xy[b])))   # noqa: E731
    seen = set()
    pos, clock, cap = 0, 0.0, inst['capacity']
    for node in np.asarray(tour).tolist():
        if node == 0:
            pos, clock, cap = 0, 0.0, inst['capacity']
            continue
        assert node not in seen, f"customer {node} visited twice"
        seen.add(node)
        start = max(clock + dist(pos, node), ready[node])
        assert start <= due[node] + 1e-4, f"window violated at {node}"
        cap -= demand[node]
        assert cap >= -1e-6, f"capacity violated at {node}"
        clock = start + service[node]
        pos = node
    assert seen == set(range(1, len(xy))), "not all customers served"


def host_contract_cost(bonds, open_, order_pairs):
    """Independent reference evaluator (``tests/test_tnco.py``): explicit
    per-cluster bond dicts, float dims."""
    n = len(bonds)
    clusters = {i: {i} for i in range(n)}
    owner = list(range(n))
    total = 0.0
    for (u, v) in order_pairs:
        a, b = owner[u], owner[v]
        if a == b:
            continue
        ca, cb = clusters[a], clusters[b]

        def ext(cl):
            d = 1.0
            for i in cl:
                d *= 2.0 ** open_[i]
                for j in range(n):
                    if j not in cl:
                        d *= 2.0 ** bonds[i][j]
            return d

        shared = 1.0
        for i in ca:
            for j in cb:
                shared *= 2.0 ** bonds[i][j]
        total += ext(ca) * ext(cb) / shared
        clusters[a] = ca | cb
        del clusters[b]
        for i in clusters[a]:
            owner[i] = a
    return total


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _instances():
    return {'rand24': (read_solomon(data_path('rand24_vrptw.txt')),
                       j_read_solomon(jr.data_path('rand24_vrptw.txt'))),
            'rand20': (r.random_vrptw(20, seed=2), jr.random_vrptw(20, seed=2))}


# ---------------------------------------------------------------- VRPTW

@pytest.mark.parametrize('args', [(20, 2, 8, 100.0), (100, 0, 25, 200.0)])
def test_random_vrptw_is_jax_bit_for_bit(args):
    a, b = r.random_vrptw(*args), jr.random_vrptw(*args)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize('name', ['rand24', 'rand20'])
def test_construct_on_jax_draws_gives_jax_tours(name):
    inst, jinst = _instances()[name]
    sim, jsim = r.VRPTWSimulator(inst, device=CPU), jr.VRPTWSimulator(jinst)
    assert np.array_equal(_np(sim.dist), np.asarray(jsim.dist))
    S = 32
    jt = np.asarray(jsim.construct(KEY, S))
    tours = sim.construct(0, S, draws=vrptw_draws(KEY, S, sim.n))
    assert tours.dtype == torch.int64 and tours.shape == (S, 2 * sim.n)
    assert np.array_equal(_np(tours), jt)
    np.testing.assert_allclose(_np(sim.tour_distance(tours)),
                               np.asarray(jsim.tour_distance(jt)), rtol=1e-5)
    assert np.array_equal(_np(sim.num_vehicles_used(tours)),
                          np.asarray(jsim.num_vehicles_used(jt)))
    complete = _np(sim.is_complete(tours))
    assert np.array_equal(complete, np.asarray(jsim.is_complete(jt))) and complete.any()
    (d, t), (jd, jtour) = sim.best(tours), jsim.best(jt)
    np.testing.assert_allclose(float(d), float(jd), rtol=1e-5)
    assert np.array_equal(_np(t), np.asarray(jtour))


def test_best_without_a_complete_tour_is_inf_at_index_0():
    inst = r.random_vrptw(6, seed=1)
    sim, jsim = r.VRPTWSimulator(inst, device=CPU), jr.VRPTWSimulator(inst)
    tours = np.zeros((3, sim.tour_len), np.int64)
    tours[0, :2], tours[1, :3], tours[2, :4] = [3, 1], [2, 2, 5], [1, 0, 4, 6]
    d, t = sim.best(torch.as_tensor(tours))
    jd, jt = jsim.best(tours.astype(np.int32))
    assert float(d) == float(jd) == float('inf')
    assert np.array_equal(_np(t), tours[0]) and np.array_equal(np.asarray(jt), tours[0])
    assert not _np(sim.is_complete(torch.as_tensor(tours))).any()


@pytest.mark.parametrize('name', ['rand24', 'rand20'])
def test_vrptw_solve_on_jax_draws_is_jax_and_feasible(name):
    inst, jinst = _instances()[name]
    S = 64
    n = len(inst['xy'])
    d, tour, veh = r.vrptw_solve(inst, 0, num_sims=S, device=CPU,
                                 draws=vrptw_draws(KEY, S, n))
    jd, jtour, jveh = jr.vrptw_solve(jinst, KEY, num_sims=S)
    assert isinstance(d, float) and isinstance(tour, np.ndarray) and isinstance(veh, int)
    np.testing.assert_allclose(d, jd, rtol=1e-5)
    assert np.array_equal(tour, jtour) and veh == jveh <= inst['num_vehicles']
    _validate(inst, tour)


def test_vrptw_solver_feasible_on_its_own_draws():
    """The JAX package's ``test_vrptw_solver_feasible_on_synthetic``."""
    inst = r.random_vrptw(20, seed=2, num_vehicles=8)
    d, tour, veh = r.vrptw_solve(inst, torch.Generator().manual_seed(0), num_sims=128,
                                 device=CPU)
    assert np.isfinite(d) and veh <= 8
    _validate(inst, tour)
    np.testing.assert_allclose(
        d, sum(np.hypot(*(inst['xy'][a] - inst['xy'][b]))
               for a, b in zip([0] + tour[:-1].tolist(), tour.tolist())), rtol=1e-5)


# ---------------------------------------------------------------- TNCO

def _nets():
    return {'random_tn12': (r.random_tn(12, device=CPU), jr.random_tn(12)),
            'grid3x3': (r.grid_tn(3, 3, device=CPU), jr.grid_tn(3, 3)),
            'chain': (r.matrix_chain([32, 2, 64, 4, 128, 2], device=CPU),
                      jr.matrix_chain([32, 2, 64, 4, 128, 2]))}


@pytest.mark.parametrize('name', ['random_tn12', 'grid3x3', 'chain'])
def test_networks_are_jax_bit_for_bit(name):
    sim, jsim = _nets()[name]
    assert np.array_equal(_np(sim.bonds), np.asarray(jsim.bonds))
    assert np.array_equal(_np(sim.open), np.asarray(jsim.open))
    assert np.array_equal(_np(sim.edges_u), np.asarray(jsim.edges_u))
    assert np.array_equal(_np(sim.edges_v), np.asarray(jsim.edges_v))
    assert sim.num_edges == jsim.num_edges and sim.num_nodes == jsim.num_nodes


def test_random_tn_at_the_card_size_is_jax_bit_for_bit():
    a, b = r.random_tn(64, degree=3, seed=0, device=CPU), jr.random_tn(64, degree=3, seed=0)
    assert np.array_equal(_np(a.bonds), np.asarray(b.bonds)) and a.num_edges == 96


@pytest.mark.parametrize('name', ['random_tn12', 'grid3x3'])
def test_costs_and_peaks_match_jax(name):
    sim, jsim = _nets()[name]
    xs = jsim.rand_xs(KEY, 16)
    # ties in the priorities too: the stable sort must keep JAX's order
    xs = xs.at[:, 1].set(xs[:, 0]).at[3].set(0.0)
    tx = torch.tensor(np.asarray(xs))
    np.testing.assert_allclose(_np(sim.contraction_cost(tx)),
                               np.asarray(jsim.contraction_cost(xs)), rtol=0, atol=1e-4)
    np.testing.assert_allclose(_np(sim.peak_size(tx)), np.asarray(jsim.peak_size(xs)),
                               rtol=0, atol=1e-4)
    (o, x), (jo, jx) = sim.best(tx), jsim.best(xs)
    np.testing.assert_allclose(float(o), float(jo), atol=1e-4)
    assert np.array_equal(_np(x), np.asarray(jx))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_cost_matches_independent_host_evaluator(seed):
    sim = r.random_tn(7, degree=3, max_log2=2.0, seed=seed, device=CPU)
    bonds, open_ = _np(sim.bonds), _np(sim.open)
    xs = sim.rand_xs(torch.Generator().manual_seed(seed), 8)
    got = _np(sim.contraction_cost(xs))
    eu, ev = _np(sim.edges_u), _np(sim.edges_v)
    for s in range(8):
        order = np.argsort(_np(xs[s]), kind='stable')
        want = host_contract_cost(bonds, open_, list(zip(eu[order].tolist(),
                                                         ev[order].tolist())))
        assert np.isclose(2.0 ** got[s], want, rtol=1e-4), (s, got[s], want)


@pytest.mark.parametrize('name', ['random_tn12', 'grid3x3', 'chain'])
def test_greedy_on_jax_draws_gives_jax_merges(name):
    sim, jsim = _nets()[name]
    S = 16
    c, m = r.tnco_greedy(sim, 0, num_sims=S, draws=tnco_greedy_draws(KEY, S, sim.num_nodes))
    jc, jm = jr.tnco_greedy(jsim, KEY, num_sims=S)
    np.testing.assert_allclose(float(c), float(jc), rtol=0, atol=1e-4)
    assert m.dtype == torch.int64 and np.array_equal(_np(m), np.asarray(jm))


def test_greedy_defers_the_outer_product_to_the_last_merge():
    """Two disconnected pairs: both bonds are contracted before the outer
    product, as in the JAX package; a one-node network merges nothing."""
    bonds = np.zeros((4, 4), np.float32)
    bonds[0, 1] = bonds[1, 0] = bonds[2, 3] = bonds[3, 2] = 1.0
    sim, jsim = r.TNCOSimulator(bonds, device=CPU), jr.TNCOSimulator(bonds)
    c, m = r.tnco_greedy(sim, 0, num_sims=4)
    m = _np(m)
    assert m.shape == (3, 2) and (m >= 0).all()
    assert {frozenset(p) for p in m[:2].tolist()} == {frozenset((0, 1)), frozenset((2, 3))}
    np.testing.assert_allclose(float(c), float(jr.tnco_greedy(jsim, KEY, num_sims=4)[0]),
                               atol=1e-4)
    c1, m1 = r.tnco_greedy(r.TNCOSimulator(np.zeros((1, 1), np.float32), device=CPU), 0,
                           num_sims=2)
    assert tuple(m1.shape) == (0, 2) and float(c1) == float(np.float32(-1e30))


@pytest.mark.parametrize('name', ['random_tn12', 'grid3x3'])
def test_anneal_on_jax_draws_gives_jax_best(name):
    sim, jsim = _nets()[name]
    S, T = 16, 16
    c, x = r.tnco_anneal(sim, 0, num_sims=S, num_steps=T,
                         draws=tnco_anneal_draws(KEY, S, sim.num_edges, T))
    jc, jx = jr.tnco_anneal(jsim, KEY, num_sims=S, num_steps=T)
    np.testing.assert_allclose(float(c), float(jc), rtol=0, atol=1e-4)
    np.testing.assert_allclose(_np(x), np.asarray(jx), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(sim.contraction_cost(x[None])[0]), float(c), atol=1e-4)


def test_matrix_chain_solvers_hit_dp_optimum():
    """The JAX package's quality check on the port's own draws."""
    dims = [32, 2, 64, 4, 128, 2]
    sim = r.matrix_chain(dims, device=CPU)
    opt = r.matrix_chain_dp(dims)
    assert opt == jr.matrix_chain_dp(dims)
    greedy_c, _ = r.tnco_greedy(sim, 0, num_sims=64)
    sa_c, sa_x = r.tnco_anneal(sim, 0, num_sims=256, num_steps=64)
    assert np.isclose(2.0 ** float(sa_c), opt, rtol=1e-4)
    assert 2.0 ** float(greedy_c) <= opt * 1.5
    assert np.isclose(float(sim.contraction_cost(sa_x[None])[0]), float(sa_c), atol=1e-4)


def test_anneal_finds_the_brute_force_optimum_on_a_small_net():
    sim = r.random_tn(5, degree=3, max_log2=3.0, seed=7, device=CPU)
    bonds, open_ = _np(sim.bonds), _np(sim.open)
    edges = list(zip(_np(sim.edges_u).tolist(), _np(sim.edges_v).tolist()))
    best = min(host_contract_cost(bonds, open_, perm) for perm in itertools.permutations(edges))
    sa_c, _ = r.tnco_anneal(sim, 1, num_sims=256, num_steps=64)
    assert np.isclose(2.0 ** float(sa_c), best, rtol=1e-4)


def test_registry_builds_both():
    inst = r.random_vrptw(10, seed=3)
    sim = r.make_simulator(r.Problem.vrp, instance=inst, device=CPU)
    assert isinstance(sim, r.VRPTWSimulator) and sim.device == CPU
    assert bool(sim.is_complete(sim.construct(1, 32)).any())
    g = r.grid_tn(2, 2, device=CPU)
    t = r.make_simulator(r.Problem.tnco, bonds_log2=_np(g.bonds), open_log2=np.ones(4),
                         device=CPU)
    assert isinstance(t, r.TNCOSimulator) and t.num_edges == 4
    assert np.array_equal(_np(t.open), np.ones(4, np.float32))


def test_solvers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default runs there')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        r.VRPTWSimulator(r.random_vrptw(4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        r.vrptw_solve(r.random_vrptw(4), 0, num_sims=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        r.grid_tn(2, 2)
