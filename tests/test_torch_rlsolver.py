"""``elegantrl_tpu_torch/rlsolver``'s MaxCut core against
``elegantrl_tpu/rlsolver`` on the CPU: the graph utilities, the simulator's
objective, gains and searches, each driver on the JAX package's draws
(``tests/rlsolver_jax_draws.py``, handed to the port as ``draws=``), and the
JAX package's quality tests (``tests/test_rlsolver.py``,
``tests/test_rlsolver_extra.py:187``) on the port.

Instances: the committed 64-node BA graph and small generated ones; tens
of sims.  Tolerances: integer cuts, spins and tours exact; float
objectives rtol 1e-5; MCPG's policy logits rtol 1e-4 / atol 1e-6 (their
gradient sums run in another order than XLA's), but for the few (at most 1
in 16) whose gradient sits at float32's noise floor, where Adam's
normalised step turns a last-bit difference into up to ``lr`` an epoch.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu import rlsolver as jr
from elegantrl_tpu_torch import rlsolver as r
from rlsolver_jax_draws import (greedy_ls_draws, isco_draws, mcpg_draws, metro_draws,
                                random_search_draws, random_walk_draws, sa_draws, split,
                                sweep_draws)

CPU = 'cpu'
TRIANGLE = np.array([[0, 1, 1.0], [1, 2, 1.0], [0, 2, 1.0]])
K33 = np.array([[i, 3 + j, 1.0] for i in range(3) for j in range(3)])


@pytest.fixture(autouse=True)
def _one_thread():
    """Small products: one intra-op thread (a loaded box's thread pool costs
    milliseconds a call)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ba64():
    return r.read_graph_txt(r.data_path('syn_BA_64.txt'))


def _sims(n, edges):
    return r.MaxCutSimulator(edges, n, device=CPU), jr.MaxCutSimulator(edges, n)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got.cpu() if torch.is_tensor(got) else got),
                                  np.asarray(want))


# ------------------------------------------------------------------ graphs

def test_graphs_as_jax(tmp_path):
    """The generators, the txt and TSPLIB round trips, the adjacency, the
    result files and their summary: the same values as the JAX module's."""
    for kind in ('BA', 'ER', 'PL'):
        _same(r.generate_graph(kind, 40, seed=3, avg_degree=6),
              jr.generate_graph(kind, 40, seed=3, avg_degree=6))
    edges = r.generate_graph('ER', 12, seed=4)
    p = str(tmp_path / 'g.txt')
    r.write_graph_txt(p, 12, edges)
    n, edges2 = r.read_graph_txt(p)
    assert n == 12 and len(edges2) == len(edges)
    np.testing.assert_allclose(edges2[:, :2], edges[:, :2])
    _same(r.edges_to_adjacency(edges, 12), jr.edges_to_adjacency(edges, 12))
    cities = np.array([[0.0, 0.0], [3.5, 0.0], [3.5, 2.0], [0.0, 2.0]])
    r.write_tsplib(str(tmp_path / 'sq.tsp'), cities, name='sq')
    assert np.allclose(r.read_tsplib(str(tmp_path / 'sq.tsp')), cities)
    sol = np.zeros(4, np.int64)
    for obj, alg in [(10.0, 'greedy'), (12.0, 'greedy'), (11.0, 'sa')]:
        r.write_graph_result(obj, 1.5, 4, alg, sol, str(tmp_path / 'res' / 'BA_16_ID0'))
    csv_path = str(tmp_path / 'summary.csv')
    summary = r.summarize_results(str(tmp_path / 'res'), output_csv=csv_path)
    assert summary == jr.summarize_results(str(tmp_path / 'res'))
    g = summary[('BA_16_ID0', 'greedy')]
    assert g['count'] == 2 and g['avg_obj'] == 11.0 and g['best_obj'] == 12.0
    with open(csv_path) as f:
        lines = f.read().strip().splitlines()
    assert len(lines) == 3 and lines[0].startswith('instance,alg')


def test_the_port_keeps_its_own_copy_of_the_instances():
    """``data_path`` points into the port's package, and each committed
    instance is the JAX package's, byte for byte, read the same."""
    assert r.data_path().endswith(os.path.join('elegantrl_tpu_torch', 'rlsolver', 'data'))
    names = sorted(f for f in os.listdir(jr.data_path()) if f != 'README.md')
    assert sorted(f for f in os.listdir(r.data_path()) if f != 'README.md') == names
    assert len(names) == 7 and os.path.isfile(r.data_path('README.md'))
    for name in names:
        with open(r.data_path(name), 'rb') as a, open(jr.data_path(name), 'rb') as b:
            assert a.read() == b.read(), name
    n, edges = r.read_graph_txt(r.data_path('syn_BA_64.txt'))
    assert n == 64 and len(edges) > 0 and edges.min() >= 0
    assert r.read_tsplib(r.data_path('rand48.tsp')).shape == (48, 2)
    for name, edges_want in (('syn_BA_800_dense.txt', 3143), ('syn_BA_800_sparse.txt', 1586)):
        n, edges = r.read_graph_txt(r.data_path(name))
        assert n == 800 and len(edges) == edges_want


# ------------------------------------------------------------- simulator

def test_maxcut_simulator_as_jax():
    """obj and flip_gains on the JAX draws, both searches on their draws:
    exact (integer cuts and gains, the same spins)."""
    n, edges = _ba64()
    sim, jsim = _sims(n, edges)
    key = jax.random.key(3)
    jxs = jsim.rand_xs(key, 16)
    xs = sim.rand_xs(None, 16, draws={'rand_xs': [np.asarray(jxs)]})
    _same(xs, jxs)
    _same(sim.obj(xs), jsim.obj(jxs))
    _same(sim.flip_gains(xs), jsim.flip_gains(jxs))
    k1, k2 = split(jax.random.key(4))
    _same(sim.local_search(xs, None, 6, draws=sweep_draws(k1, (16, n), 6, 'tie')),
          jsim.local_search(jxs, k1, 6))
    _same(sim.local_search_sweep(xs, None, 5, draws=sweep_draws(k2, (16, n), 5)),
          jsim.local_search_sweep(jxs, k2, 5))
    obj, x = sim.best(xs)
    jobj, jx = jsim.best(jxs)
    assert float(obj) == float(jobj)
    _same(x, jx)
    assert sim.total_weight == jsim.total_weight and sim.num_edges == jsim.num_edges


S = 32


@pytest.mark.parametrize('driver', ['random_search', 'random_walk', 'greedy_local_search',
                                    'simulated_annealing', 'isco_solve'])
def test_driver_as_jax(driver):
    """Each MaxCut driver on the 64-node BA instance given the JAX draws:
    the same best cut and the same solution, exactly."""
    n, edges = _ba64()
    sim, jsim = _sims(n, edges)
    key = jax.random.key(11)
    run = {
        'random_search': (lambda f, k, **d: f(sim if d else jsim, k, num_sims=S, num_rounds=3,
                                              **d), random_search_draws(key, S, n, 3)),
        'random_walk': (lambda f, k, **d: f(sim if d else jsim, k, num_sims=S, num_steps=40,
                                            **d), random_walk_draws(key, S, n, 40)),
        'greedy_local_search': (lambda f, k, **d: f(sim if d else jsim, k, num_sims=S,
                                                    num_iters=24, **d),
                                greedy_ls_draws(key, S, n, 24)),
        'simulated_annealing': (lambda f, k, **d: f(sim if d else jsim, k, num_sims=S,
                                                    num_steps=96, **d),
                                sa_draws(key, S, n, 96)),
        'isco_solve': (lambda f, k, **d: f(sim if d else jsim, k, num_sims=S, num_steps=24,
                                           path_length=3, **d), isco_draws(key, S, n, 24, 3)),
    }
    call, draws = run[driver]
    obj, x = call(getattr(r, driver), None, draws=draws)
    jobj, jx = call(getattr(jr, driver), key)
    assert float(obj) == float(jobj), (float(obj), float(jobj))
    _same(x, jx)
    assert float(sim.obj(x[None])[0]) == float(obj)


def test_metro_sampling_and_mcpg_as_jax():
    """The Metropolis transfers exactly; MCPG's best cut and solution
    exactly and its policy logits within rtol 1e-4 / atol 1e-6, on the JAX
    draws."""
    from elegantrl_tpu.rlsolver.mcpg import metro_sampling as jmetro
    from elegantrl_tpu_torch.rlsolver.mcpg import metro_sampling
    n, edges = _ba64()
    sim, jsim = _sims(n, edges)
    probs = np.random.default_rng(0).uniform(0.2, 0.8, n).astype(np.float32)
    jxs = jsim.rand_xs(jax.random.key(1), 24)
    key = jax.random.key(2)
    _same(metro_sampling(_t(probs), _t(jxs), None, 12, draws=metro_draws(key, 24, n, 12)),
          jmetro(jnp.asarray(probs), jxs, key, 12))
    key = jax.random.key(5)
    obj, x, info = r.mcpg_solve(sim, None, num_chains=24, num_epochs=5, num_transfers=8,
                                num_ls=4, draws=mcpg_draws(key, 24, n, 5, 8, 4))
    jobj, jx, jinfo = jr.mcpg_solve(jsim, key, num_chains=24, num_epochs=5, num_transfers=8,
                                    num_ls=4)
    assert obj == jobj
    _same(x, jx)
    theta, jtheta = info['theta'].numpy(), np.asarray(jinfo['theta'])
    off = ~np.isclose(theta, jtheta, rtol=1e-4, atol=1e-6)
    assert off.mean() <= 1 / 16, off.mean()
    np.testing.assert_allclose(theta, jtheta, rtol=0, atol=0.08 * 5)   # lr an epoch


def test_solvers_default_to_the_card():
    """Without ``device`` a simulator is made on the card: here, without a
    GPU, that raises and names ``device='cpu'``."""
    n, edges = _ba64()
    if torch.cuda.is_available():
        assert r.MaxCutSimulator(edges, n).adj.device.type == 'cuda'
        return
    for make in (lambda: r.MaxCutSimulator(edges, n), lambda: r.MISSimulator(edges, n),
                 lambda: r.sdp_maxcut(edges, n, 0), lambda: r.knapsack_dp([1.0], [1], 1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


# --------------------------------------- the JAX package's quality tests

def test_obj_values():
    sim = r.MaxCutSimulator(TRIANGLE, 3, device=CPU)
    xs = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1.0, 1.0, 0.0]])
    np.testing.assert_allclose(sim.obj(xs).numpy(), [0.0, 2.0, 2.0])


def test_flip_gains_match_objective_delta():
    rng = np.random.default_rng(0)
    sim = r.MaxCutSimulator(r.generate_graph('ER', 20, seed=1), 20, device=CPU)
    xs = sim.rand_xs(0, 5)
    gains, base = sim.flip_gains(xs).numpy(), sim.obj(xs).numpy()
    for s in range(5):
        for i in rng.choice(20, 5, replace=False):
            flipped = xs.clone()
            flipped[s, i] = 1 - flipped[s, i]
            np.testing.assert_allclose(gains[s, i], float(sim.obj(flipped)[s] - base[s]),
                                       atol=1e-4)


def test_bipartite_optimum_found():
    sim = r.MaxCutSimulator(K33, 6, device=CPU)   # optimum 9: the full bipartition
    obj, x = r.greedy_local_search(sim, 0, num_sims=64, num_iters=32)
    assert float(obj) == 9.0


def test_sa_beats_random():
    sim = r.MaxCutSimulator(r.generate_graph('BA', 60, seed=2, avg_degree=6), 60, device=CPU)
    r_obj, _ = r.random_search(sim, 0, num_sims=256, num_rounds=2)
    sa_obj, sa_x = r.simulated_annealing(sim, 1, num_sims=256, num_steps=256)
    assert float(sa_obj) >= float(r_obj)
    np.testing.assert_allclose(float(sim.obj(sa_x[None])[0]), float(sa_obj))


def test_mcpg_solves_small_graph():
    sim = r.MaxCutSimulator(r.generate_graph('ER', 30, seed=3), 30, device=CPU)
    ls_obj, _ = r.greedy_local_search(sim, 0, num_sims=512, num_iters=64)
    obj, x, _ = r.mcpg_solve(sim, 1, num_chains=128, num_epochs=8, num_transfers=16, num_ls=8)
    assert obj >= 0.9 * float(ls_obj)
    assert float(sim.obj(x[None])[0]) == obj


def test_isco_matches_or_beats_random_search():
    sim = r.MaxCutSimulator(r.generate_graph('BA', 60, seed=5, avg_degree=6), 60, device=CPU)
    r_obj, _ = r.random_search(sim, 0, num_sims=256, num_rounds=2)
    i_obj, i_x = r.isco_solve(sim, 1, num_sims=256, num_steps=128)
    assert float(i_obj) >= float(r_obj)
    np.testing.assert_allclose(float(sim.obj(i_x[None])[0]), float(i_obj))


def test_random_walk_tracks_best():
    sim = r.MaxCutSimulator(r.generate_graph('ER', 16, seed=3), 16, device=CPU)
    best_obj, best_x = r.random_walk(sim, 0, num_sims=128, num_steps=256)
    assert abs(float(sim.obj(best_x[None])[0]) - float(best_obj)) < 1e-5
    rs_obj, _ = r.random_search(sim, 1, num_sims=128, num_rounds=1)
    assert float(best_obj) >= float(rs_obj) * 0.95


# ------------------------------------------------------- PPO on node flips

def test_flip_env_as_jax():
    """The flip env's obs, reward (the cut's change) and truncation, on the
    same spins and actions as the JAX env: exact."""
    n, edges = 24, r.generate_graph('ER', 24, seed=5)
    sim, jsim = _sims(n, edges)
    env = r.maxcut_flip_env(sim, num_steps=3, continuing=False)
    jenv = jr.maxcut_flip_env(jsim, num_steps=3, continuing=False)
    assert env.spec == type(env.spec)(*jenv.spec)
    jstates = [jenv.init(k) for k in split(jax.random.key(0), 4)]
    state = type(env.init(torch.Generator(), 4, CPU))(
        x=torch.stack([_t(s.x) for s in jstates]), t=torch.zeros(4, dtype=torch.int32))
    for a in ([3, 7, 0, 23], [7, 7, 1, 5], [3, 0, 2, 2]):
        _same(env.obs(state), np.stack([jenv.obs(s) for s in jstates]))
        state, rew, term, trunc = env.step(state, torch.tensor(a, dtype=torch.int32))
        out = [jenv.step(s, jnp.asarray(ai), None) for s, ai in zip(jstates, a)]
        jstates = [o[0] for o in out]
        _same(rew, np.array([o[1] for o in out]))
        _same(term, np.array([o[2] for o in out]))
        _same(trunc, np.array([o[3] for o in out]))
        _same(state.x, np.stack([s.x for s in jstates]))


def test_greedy_flip_rollout_as_jax():
    """The evaluation rollout of ``ppo_maxcut_solve`` with the JAX agent's
    weights (``utils/jax_params.py``) from the JAX draws' spins: the same
    best cut and solution as the JAX rollout's."""
    from elegantrl_tpu.agents.ppo import make_ppo as jmake_ppo
    from elegantrl_tpu.config import Config as JConfig
    from elegantrl_tpu_torch.agents.ppo import make_ppo
    from elegantrl_tpu_torch.config import Config
    from elegantrl_tpu_torch.rlsolver.ppo_maxcut import greedy_flip_rollout
    from elegantrl_tpu_torch.utils.jax_params import ppo_state_from_numpy
    n, edges = 24, r.generate_graph('ER', 24, seed=5)
    sim, jsim = _sims(n, edges)
    jargs = JConfig()
    jargs.net_dims = (64,)
    jagent = jmake_ppo((64,), 2 * n, n, jargs, discrete=True)
    jstate = jagent.init(jax.random.key(7))
    args = Config()
    args.net_dims, args.device = (64,), CPU
    agent = make_ppo((64,), 2 * n, n, args, discrete=True)
    state = ppo_state_from_numpy(jax.tree.map(np.asarray, jstate), torch.device(CPU))
    jxs = jsim.rand_xs(jax.random.key(8), 16)

    def jrollout(xs):
        best_obj, best_xs = jsim.obj(xs), xs
        for _ in range(n):
            a = jagent.greedy_action(jstate, jnp.concatenate([xs, jsim.flip_gains(xs)], -1))
            xs = jnp.abs(xs - jax.nn.one_hot(a, n))
            objs = jsim.obj(xs)
            better = objs > best_obj
            best_obj = jnp.where(better, objs, best_obj)
            best_xs = jnp.where(better[:, None], xs, best_xs)
        i = jnp.argmax(best_obj)
        return best_obj[i], best_xs[i]

    with torch.no_grad():
        obj, x = greedy_flip_rollout(sim, agent.greedy_action, state, _t(jxs), n)
    jobj, jx = jrollout(jxs)
    assert float(obj) == float(jobj)
    _same(x, jx)


def test_ppo_maxcut_flip_env_and_solver(tmp_path):
    """``tests/test_rlsolver_extra.py:187`` on the port: PPO trained on the
    flip env comes within 10% of greedy local search on a 24-node ER graph,
    its x reproduces its cut, and each flip's reward is the cut's change."""
    n, edges = 24, r.generate_graph('ER', 24, seed=5)
    sim = r.MaxCutSimulator(edges, n, device=CPU)
    env = r.maxcut_flip_env(sim, num_steps=10)
    s = env.init(torch.Generator().manual_seed(0), 1, CPU)
    for a in (3, 7, 3):
        before = float(sim.obj(s.x)[0])
        s, rew, term, trunc = env.step(s, torch.tensor([a]))
        assert abs(float(rew[0]) - (float(sim.obj(s.x)[0]) - before)) < 1e-4
        assert not bool(term[0])
    ls_obj, _ = r.greedy_local_search(sim, 0, num_sims=256, num_iters=48)
    out = r.ppo_maxcut_solve(sim, seed=0, num_envs=64, break_step=400_000,
                             cwd=str(tmp_path / 'run'))
    assert out['best_cut'] >= 0.9 * float(ls_obj), (out['best_cut'], float(ls_obj))
    assert abs(float(sim.obj(torch.as_tensor(out['best_x'])[None])[0]) - out['best_cut']) < 1e-4
