"""``elegantrl_tpu_torch/rlsolver``'s graph partitioning, set cover, BILP
and portfolio simulators and ``exact.py`` against ``elegantrl_tpu/rlsolver``
on the CPU: ``obj`` and the flip gains on the same ``x`` (rtol 1e-6, atol
1e-5: float32 products summed in another order; counts exactly), the
searches on the JAX draws (``tests/rlsolver_jax_draws.py``), the JAX
package's quality checks (``tests/test_rlsolver_problems2.py``) with the
port's own draws, the registry (``vrp`` and ``tnco`` build their module's
simulators) and the exact wrappers raising ``SolverUnavailable``."""
import jax
import numpy as np
import pytest
import torch

from elegantrl_tpu import rlsolver as jr
from elegantrl_tpu_torch import rlsolver as r
from rlsolver_jax_draws import bern, ga_draws, sa_draws, sweep_draws

CPU = 'cpu'


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bridge():
    edges = []
    for block in (range(4), range(4, 8)):
        block = list(block)
        edges += [(block[a], block[b], 1.0) for a in range(4) for b in range(a + 1, 4)]
    edges.append((0, 4, 1.0))
    return np.array(edges)


def _cover():
    m = np.zeros((5, 6))
    m[0, [0, 1, 2]] = 1
    m[1, [3, 4, 5]] = 1
    m[2, [0, 3]] = 1
    m[3, [1, 4]] = 1
    m[4, [2, 5]] = 1
    return m


def _bilp():
    rng = np.random.default_rng(7)
    n, m = 10, 4
    c = rng.uniform(1, 10, n)
    a = rng.uniform(0, 5, (m, n))
    return c, a, a.sum(1) * 0.4


def _portfolio():
    rng = np.random.default_rng(9)
    n = 10
    mu = rng.uniform(0, 1, n)
    q = rng.normal(size=(n, n)) * 0.1
    return mu, q @ q.T + np.eye(n) * 0.05, 3


def _pairs():
    """(port simulator, JAX simulator, rand_xs probability) of each problem."""
    c, a, b = _bilp()
    mu, sigma, k = _portfolio()
    ba = r.generate_graph('BA', 40, seed=2)
    return {
        'partition': (r.GraphPartitionSimulator(_bridge(), 8, device=CPU),
                      jr.GraphPartitionSimulator(_bridge(), 8), 0.5),
        'partition_ba40': (r.GraphPartitionSimulator(ba, 40, device=CPU),
                           jr.GraphPartitionSimulator(ba, 40), 0.5),
        'setcover': (r.SetCoverSimulator(_cover(), device=CPU), jr.SetCoverSimulator(_cover()),
                     0.5),
        'bilp': (r.BILPSimulator(c, a, b, device=CPU), jr.BILPSimulator(c, a, b), 0.25),
        'portfolio': (r.PortfolioSimulator(mu, sigma, k, device=CPU),
                      jr.PortfolioSimulator(mu, sigma, k), 0.3),
    }


@pytest.mark.parametrize('name', ['partition', 'partition_ba40', 'setcover', 'bilp',
                                  'portfolio'])
def test_obj_and_flip_gains_as_jax(name):
    sim, jsim, p = _pairs()[name]
    key = jax.random.key(1)
    jxs = jsim.rand_xs(key, 16)
    xs = sim.rand_xs(None, 16, draws={'rand_xs': [bern(key, p, (16, sim.num_nodes))]})
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    for f in ('obj', 'flip_gains'):
        np.testing.assert_allclose(getattr(sim, f)(xs).numpy(), np.asarray(getattr(jsim, f)(jxs)),
                                   rtol=1e-6, atol=1e-5, err_msg=f)
    extra = {'partition': ('cut', 'imbalance'), 'partition_ba40': ('cut', 'imbalance'),
             'setcover': ('num_uncovered',), 'bilp': ('violation',), 'portfolio': ()}[name]
    for f in extra:     # counts exactly, the cut and the violation as the objective
        got, want = getattr(sim, f)(xs).numpy(), np.asarray(getattr(jsim, f)(jxs))
        if f in ('num_uncovered', 'imbalance'):
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5, err_msg=f)
    # each flip gain is the objective's exact change
    gains, base = sim.flip_gains(xs).numpy(), sim.obj(xs).numpy()
    for s in range(3):
        for i in range(sim.num_nodes):
            x2 = xs.clone()
            x2[s, i] = 1 - x2[s, i]
            assert gains[s, i] == pytest.approx(float(sim.obj(x2)[s]) - base[s], abs=1e-3)
    val, x = sim.best(xs)
    jval, jx = jsim.best(jxs)
    assert float(val) == pytest.approx(float(jval), rel=1e-6)
    if np.isfinite(float(jval)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))


@pytest.mark.parametrize('name', ['partition_ba40', 'bilp'])
def test_local_search_and_annealing_as_jax(name):
    """The greedy sweep and simulated annealing on the JAX draws."""
    sim, jsim, p = _pairs()[name]
    n = sim.num_nodes
    key = jax.random.key(3)
    jxs = jsim.rand_xs(key, 32)
    xs = torch.tensor(np.asarray(jxs))
    k2 = jax.random.key(4)
    np.testing.assert_array_equal(
        sim.local_search_sweep(xs, None, 6, draws=sweep_draws(k2, (32, n), 6, 'tie')).numpy(),
        np.asarray(jsim.local_search_sweep(jxs, k2, num_sweeps=6)))
    key = jax.random.key(5)
    obj, x = r.simulated_annealing(sim, None, num_sims=32, num_steps=40,
                                   draws=sa_draws(key, 32, n, 40, p=p))
    jobj, jx = jr.simulated_annealing(jsim, key, num_sims=32, num_steps=40)
    assert float(obj) == pytest.approx(float(jobj), rel=1e-6)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))


def test_genetic_algorithm_on_set_cover_as_jax():
    sim, jsim, _ = _pairs()['setcover']
    key = jax.random.key(6)
    obj, x = r.genetic_algorithm(sim, None, pop_size=32, num_generations=4,
                                 draws=ga_draws(key, 32, sim.num_nodes, 4, 2, search='tie'))
    jobj, jx = jr.genetic_algorithm(jsim, key, pop_size=32, num_generations=4)
    assert float(obj) == float(jobj)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))


# ---- the JAX package's quality checks, on the port's own draws

def test_graph_partitioning_bridge_graph():
    sim = r.GraphPartitionSimulator(_bridge(), 8, device=CPU)
    _, x = r.genetic_algorithm(sim, 0, pop_size=128, num_generations=16)
    cut, xb = sim.best(x[None])
    assert float(cut) == 1.0 and float(sim.imbalance(xb[None])[0]) == 0.0


def test_set_cover_known_optimum():
    sim = r.SetCoverSimulator(_cover(), device=CPU)
    _, x = r.genetic_algorithm(sim, 0, pop_size=64, num_generations=16)
    size, cover = sim.best(x[None])
    assert float(size) == 2.0 and float(sim.num_uncovered(cover[None])[0]) == 0.0


def _brute(n, value, feasible):
    best = -np.inf
    for mask in range(1 << n):
        x = np.array([(mask >> i) & 1 for i in range(n)], float)
        if feasible(x):
            best = max(best, value(x))
    return best


def test_bilp_matches_bruteforce():
    c, a, b = _bilp()
    best = _brute(10, lambda x: float(c @ x), lambda x: (a @ x <= b + 1e-9).all())
    sim = r.BILPSimulator(c, a, b, device=CPU)
    xs = sim.local_search_sweep(sim.rand_xs(1, 1024), 2, num_sweeps=32)
    val, x = sim.best(xs)
    assert float(val) >= 0.99 * best, (float(val), best)
    xh = x.numpy().astype(np.float64)
    assert (a @ xh <= b + 1e-9).all() and float(c @ xh) == pytest.approx(float(val), rel=1e-6)


def test_portfolio_exact_k_and_bruteforce():
    mu, sigma, k = _portfolio()
    best = _brute(10, lambda x: float(mu @ x - x @ sigma @ x), lambda x: x.sum() == k)
    sim = r.PortfolioSimulator(mu, sigma, k, risk_lambda=1.0, device=CPU)
    _, x = r.simulated_annealing(sim, 0, num_sims=512, num_steps=512)
    val, xb = sim.best(x[None])
    assert float(xb.sum()) == k and float(val) >= best - 1e-3, (float(val), best)


def test_partition_penalty_scales_with_edge_weights():
    edges = np.array([(0, i, 10.0) for i in range(1, 8)])
    sim = r.GraphPartitionSimulator(edges, 8, device=CPU)
    assert sim.penalty == jr.GraphPartitionSimulator(edges, 8).penalty == 70.0
    xs = sim.local_search_sweep(sim.rand_xs(0, 64), 1)
    cut, x = sim.best(xs)
    assert np.isfinite(float(cut)) and float(sim.imbalance(x[None])[0]) == 0.0
    assert float(cut) in (30.0, 40.0)


# ---- the registry and the exact wrappers

def test_registry_builds_the_four_and_still_names_the_rest():
    assert r.supported_problems() == set(r.Problem)
    c, a, b = _bilp()
    mu, sigma, k = _portfolio()
    built = {
        'graph_partitioning': (dict(edges=_bridge(), num_nodes=8), r.GraphPartitionSimulator),
        'set_cover': (dict(membership=np.eye(4)), r.SetCoverSimulator),
        'bilp': (dict(c=c, a=a, b=b), r.BILPSimulator),
        'portfolio_allocation': (dict(mu=mu, sigma=sigma, k=k, risk_lambda=0.5),
                                 r.PortfolioSimulator),
    }
    for problem, (kw, cls) in built.items():
        sim = r.make_simulator(problem, device=CPU, **kw)
        jsim = jr.make_simulator(problem, **kw)
        assert isinstance(sim, cls) and sim.device.type == 'cpu'
        assert sim.num_nodes == jsim.num_nodes and sim.penalty == jsim.penalty
    assert r.make_simulator('portfolio_allocation', device=CPU, mu=mu, sigma=sigma,
                            k=k, risk_lambda=0.5).lam == 0.5
    for problem, kw, cls in (('vrp', {'instance': r.random_vrptw(5, seed=3)}, r.VRPTWSimulator),
                             ('tnco', {'bonds_log2': np.eye(3, k=1) + np.eye(3, k=-1)},
                              r.TNCOSimulator)):
        sim = r.make_simulator(problem, device=CPU, **kw)
        assert isinstance(sim, cls) and sim.device.type == 'cpu'
    with pytest.raises(TypeError, match='membership'):
        r.make_simulator('set_cover', device=CPU)


def test_exact_wrappers_raise_solver_unavailable():
    k4 = np.array([(0, 1, 1), (0, 2, 1), (0, 3, 1), (1, 2, 1), (1, 3, 1), (2, 3, 1)], float)
    assert issubclass(r.SolverUnavailable, ImportError)
    for fn, args in ((r.gurobi_solve_maxcut, (k4, 4)), (r.scip_solve_maxcut, (k4, 4)),
                     (r.gurobi_solve_knapsack, ([1.0, 2.0], [1.0, 1.0], 1.0))):
        try:
            val, _ = fn(*args)
        except r.SolverUnavailable as e:
            assert 'not installed' in str(e)
        else:   # the backend is there: the known optimum
            assert val in (4.0, 2.0)
