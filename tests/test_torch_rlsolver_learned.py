"""``elegantrl_tpu_torch/rlsolver``'s learned solvers (PI-GNN, RUN-CSP,
S2V-DQN, L2A, GraphTRS, the attention-model TSP constructor) against
``elegantrl_tpu/rlsolver`` on the CPU, each on the JAX package's weights
(carried by ``utils/jax_params.py``) and the JAX draws (split as each JAX
function splits its key, handed to the port as ``draws=``): one forward
within 1e-5, one training step whose parameters agree within 1e-5 (float32
sums in another order; the same draws, so the same samples), and the JAX
package's quality tests (``tests/test_pignn.py``, ``tests/test_rlsolver.py``,
``tests/test_rlsolver_extra.py``) at their sizes on the port's own draws.
ECO-DQN is in ``test_torch_rlsolver_eco.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elegantrl_tpu import rlsolver as jr
from elegantrl_tpu.rlsolver import attention_tsp as jam
from elegantrl_tpu.rlsolver import graph_trs as jgt
from elegantrl_tpu.rlsolver import pignn as jpg
from elegantrl_tpu.rlsolver import runcsp as jrc
from elegantrl_tpu_torch import rlsolver as r
from elegantrl_tpu_torch.rlsolver import _learn
from elegantrl_tpu_torch.rlsolver import pignn as pg
from elegantrl_tpu_torch.rlsolver import runcsp as rc
from elegantrl_tpu_torch.utils import jax_params as jp
from elegantrl_tpu_torch.utils.checkpoint import tree_leaves
from rlsolver_jax_draws import (bern, bern_each, gumbel_each, pairs, randint_each, split,
                                uniform_each)

CPU = 'cpu'
TOL = dict(rtol=1e-5, atol=1e-5)
K33 = np.array([[i, 3 + j, 1.0] for i in range(3) for j in range(3)])


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().cpu() if torch.is_tensor(got) else got),
                               np.asarray(want), **(tol or TOL))


def _same_trees(got, want, **tol):
    g, w = tree_leaves(got), tree_leaves(jax.tree.map(np.asarray, want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        _close(a, b, **tol)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------------ PI-GNN

def _pignn_init_draws(key, R, N, E, H):
    ks = jax.vmap(lambda k: split(k, 3))(split(key, R))
    return {'embed': [_np(jax.vmap(lambda k: jax.random.normal(k, (N, E)))(ks[:, 0]))],
            'w0': [uniform_each(ks[:, 1], (E, H))], 'w1': [uniform_each(ks[:, 2], (H, 1))]}


def test_pignn_forward_step_and_minimize_as_jax():
    edges, n = jr.generate_graph('BA', 20, seed=5), 20
    jsim = jr.MaxCutSimulator(edges, n)
    adj = np.asarray(jsim.adj)
    q, jq = pg.maxcut_qubo(torch.tensor(adj)), jax.jit(jpg.maxcut_qubo)(jsim.adj)
    _close(q, jq, rtol=0, atol=0)
    _close(pg.mis_qubo(torch.tensor(adj), 3.0), jax.jit(lambda a: jpg.mis_qubo(a, 3.0))(jsim.adj),
           rtol=0, atol=0)
    a_hat = pg.normalized_adjacency(torch.tensor(adj))
    ja_hat = jax.jit(jpg.normalized_adjacency)(jsim.adj)
    _close(a_hat, ja_hat, rtol=1e-6, atol=1e-7)
    key, R, E, H = jax.random.key(3), 4, 8, 4
    jparams = jax.jit(jax.vmap(lambda k: jpg._init_params(k, n, E, H)))(split(key, R))
    params = pg._init_params(r._draws.Draws(given=_pignn_init_draws(key, R, n, E, H)),
                             R, n, E, H)
    _same_trees(params, jparams)
    params = jp.pignn_params_from_numpy(_numpy(jparams), CPU)
    _close(pg._forward(params, a_hat),
           jax.jit(jax.vmap(lambda p: jpg._forward(p, ja_hat)))(jparams))
    # one Adam step of every replica
    opt = optax.adam(1e-2)

    @jax.jit
    def jstep(p):
        g = jax.vmap(jax.grad(lambda pp: (lambda pr: pr @ (jq @ pr))(jpg._forward(pp, ja_hat))))(p)
        u, _ = jax.vmap(opt.update)(g, jax.vmap(opt.init)(p))
        return jax.vmap(optax.apply_updates)(p, u)
    new, _, _, _ = _learn.step(_learn.adam(1e-2), params, _learn.adam_init(params),
                               lambda p: torch.sum(pg._energy(q, pg._forward(p, a_hat))))
    _same_trees(new, jstep(jparams))
    # the whole minimization on the JAX draws
    e, x = pg.pignn_minimize(q, torch.tensor(adj), None, num_replicas=R, embed_dim=E,
                             hidden_dim=H, num_steps=30,
                             draws=_pignn_init_draws(key, R, n, E, H))
    je, jx = jpg.pignn_minimize(jq, jsim.adj, key, num_replicas=R, embed_dim=E, hidden_dim=H,
                                num_steps=30)
    assert float(e) == float(je)
    _close(x, jx, rtol=0, atol=0)


def test_pignn_maxcut_with_polish_as_jax():
    """``pignn_maxcut``: the minimization, then the sweeps on the JAX coins."""
    n = 16
    ring = np.array([(i, (i + 1) % n, 1.0) for i in range(n)])
    sim, jsim = r.MaxCutSimulator(ring, n, device=CPU), jr.MaxCutSimulator(ring, n)
    key = jax.random.key(4)
    k_train, k_ls = split(key)
    E = max(8, int(np.sqrt(n)))
    draws = _pignn_init_draws(k_train, 4, n, E, max(4, E // 2))
    draws['coin'] = list(bern_each(split(k_ls, 6), 0.5, (1, n)))
    cut, x = r.pignn_maxcut(sim, None, polish_sweeps=6, num_replicas=4, num_steps=20,
                            draws=draws)
    jcut, jx = jr.pignn_maxcut(jsim, key, polish_sweeps=6, num_replicas=4, num_steps=20)
    assert float(cut) == float(jcut)
    _close(x, jx, rtol=0, atol=0)


def test_pignn_quality_as_jax_tests():
    n = 16      # the even ring, recovered by the polish
    ring = np.array([(i, (i + 1) % n, 1.0) for i in range(n)])
    cut, x = r.pignn_maxcut(r.MaxCutSimulator(ring, n, device=CPU), 0, num_replicas=8,
                            num_steps=300, polish_sweeps=16)
    assert x.shape == (n,) and float(cut) >= 0.875 * n
    edges = r.generate_graph('ER', 32, seed=4)
    mis = r.MISSimulator(edges, 32, penalty=2.0, device=CPU)
    obj, x = r.pignn_mis(mis, 1, num_replicas=8, num_steps=300)
    assert float(mis.num_conflicts(x[None])[0]) == 0.0 and float(obj) >= 3.0
    edges = r.generate_graph('BA', 24, seed=1)
    sim = r.MaxCutSimulator(edges, 24, device=CPU)
    xs = sim.rand_xs(2, 16)
    e_cut = torch.einsum('si,ij,sj->s', xs, r.maxcut_qubo(sim.adj), xs)
    _close(e_cut, -sim.obj(xs).numpy(), rtol=1e-5, atol=1e-4)
    eig = np.linalg.eigvalsh(pg.normalized_adjacency(sim.adj).numpy())
    assert eig.max() <= 1.0 + 1e-5


# ----------------------------------------------------------------- RUN-CSP

def test_runcsp_forward_step_and_solve_as_jax():
    pool = np.stack([r.edges_to_adjacency(r.generate_graph('BA', 12, seed=s), 12)
                     for s in range(3)]).astype(np.float32)
    jinit, jtrain = jrc.make_runcsp(pool, dim=8, steps=5)
    jstate = jax.jit(jinit)(jax.random.key(0))
    params = jp.runcsp_params_from_numpy(_numpy(jstate[0]), CPU)
    h0 = jax.random.normal(jax.random.key(1), (3, 12, 8)) * 0.5
    ps, h = rc._unroll(params, torch.tensor(pool), torch.tensor(_np(h0)), 5)
    jps, jh = jax.jit(lambda p, a, h: jrc._unroll(p, a, h, 5))(jstate[0], jnp.asarray(pool), h0)
    _close(ps, jps)
    _close(h, jh)
    _close(rc._uncut_prob(torch.tensor(pool), ps), jax.jit(jrc._uncut_prob)(jnp.asarray(pool), jps))
    # one training step on the JAX draw
    key = jax.random.key(2)
    jnew, jloss = jtrain(jstate, key, 1)
    _, train = r.make_runcsp(pool, dim=8, steps=5, device=CPU)
    (new, _), loss = train((params, _learn.adam_init(params)), None, 1,
                           draws={'h0': [_np(jax.random.normal(split(key, 1)[0], (3, 12, 8)))]})
    _same_trees(new, jnew[0])
    _close(loss, jloss)
    # inference on an unseen graph, the JAX draw
    adj = r.edges_to_adjacency(r.generate_graph('BA', 12, seed=77), 12)
    key = jax.random.key(3)
    best, x = r.runcsp_solve(new, adj, None, num_runs=6, steps=7,
                             draws={'h0': [_np(jax.random.normal(key, (6, 12, 8)))]})
    jbest, jx = jr.runcsp_solve(jnew[0], adj, key=key, num_runs=6, steps=7)
    assert best == jbest
    _close(x, jx, rtol=0, atol=0)


def test_runcsp_amortized_maxcut():
    pool = np.stack([r.edges_to_adjacency(r.generate_graph('BA', 24, seed=s), 24)
                     for s in range(16)])
    init_fn, train_fn = r.make_runcsp(pool, dim=32, steps=24, device=CPU)
    state, loss = train_fn(init_fn(0), 1, 300)
    assert np.isfinite(float(loss))
    edges = r.generate_graph('BA', 24, seed=77)
    sim = r.MaxCutSimulator(edges, 24, device=CPU)
    best, x = r.runcsp_solve(state[0], r.edges_to_adjacency(edges, 24), 2)
    ls_obj, _ = r.greedy_local_search(sim, 3, num_sims=256, num_iters=48)
    assert float(sim.obj(torch.tensor(x)[None])[0]) == best
    assert best >= 0.92 * float(ls_obj), (best, float(ls_obj))


# ----------------------------------------------------------------- S2V-DQN

def test_s2v_forward_round_and_solve_as_jax():
    edges, n = r.generate_graph('BA', 14, seed=3), 14
    sim, jsim = r.MaxCutSimulator(edges, n, device=CPU), jr.MaxCutSimulator(edges, n)
    jinit, jq, jround, jsolve = jr.make_s2v_dqn(jsim, embed_dim=8)
    init, q_values, train_round, solve = r.make_s2v_dqn(sim, embed_dim=8)
    jstate = jax.jit(jinit)(jax.random.key(0))
    state = init(0)
    state = state._replace(params=jp.s2v_params_from_numpy(_numpy(jstate.params), CPU),
                           target=jp.s2v_params_from_numpy(_numpy(jstate.target), CPU))
    jxs = jnp.asarray(bern(jax.random.key(1), 0.5, (5, n)))
    _close(q_values(state.params, torch.tensor(_np(jxs))), jax.jit(jq)(jstate.params, jxs))
    # one round: fresh states, the horizon, one TD step, the target's move
    key, S, H = jax.random.key(2), 6, 5
    k_init, k_roll, _ = split(key, 3)
    k_eps, k_rand = pairs(split(k_roll, H))
    draws = {'rand_xs': [bern(k_init, 0.5, (S, n))], 'node': list(randint_each(k_rand, n, (S,))),
             'explore': list(uniform_each(k_eps, (S,)))}
    jnew, jloss = jround(jstate, key, 0.5, S, H)
    new, loss = train_round(state, None, 0.5, S, H, draws=draws)
    _close(loss, jloss)
    _same_trees(new.params, jnew.params)
    _same_trees(new.target, jnew.target)
    key = jax.random.key(3)
    obj, x = solve(new, None, 7, 6, draws={'rand_xs': [bern(key, 0.5, (7, n))]})
    jobj, jx = jsolve(jnew, key, 7, 6)
    assert float(obj) == float(jobj)
    _close(x, jx, rtol=0, atol=0)


def test_s2v_dqn_learns_to_cut():
    sim = r.MaxCutSimulator(K33, 6, device=CPU)   # optimum 9
    obj, x = r.s2v_dqn_solve(sim, 0, num_epochs=25, embed_dim=16, num_sims=32, horizon=12)
    assert obj >= 8.0, obj
    assert float(sim.obj(x[None])[0]) == obj


# --------------------------------------------------------------------- L2A

def _l2a_epoch_draws(key, C, N, T, num_ls):
    k_init, k_samp, k_ls = split(key, 3)
    k_node, k_acc = pairs(split(k_samp, T))
    return {'rand_xs': [bern(k_init, 0.5, (C, N))], 'node': list(gumbel_each(k_node, (C, N))),
            'accept': list(uniform_each(k_acc, (C,))),
            'coin': list(bern_each(split(k_ls, num_ls), 0.5, (C, N)))}


@pytest.mark.parametrize('with_embed', [False, True], ids=['plain', 'node_embed'])
def test_l2a_forward_and_epoch_as_jax(with_embed):
    edges, n = r.generate_graph('ER', 16, seed=3), 16
    emb = np.random.default_rng(0).normal(size=(n, 4)).astype(np.float32) if with_embed else None
    sim, jsim = r.MaxCutSimulator(edges, n, device=CPU), jr.MaxCutSimulator(edges, n)
    jinit, jepoch = jr.make_l2a(jsim, embed_dim=8, node_embed=emb)
    init, epoch = r.make_l2a(sim, embed_dim=8, node_embed=emb)
    jparams, jopt = jax.jit(jinit)(jax.random.key(0))
    params = jp.l2a_params_from_numpy(_numpy(jparams), CPU)
    _, opt = init(0)
    key, C, T, L = jax.random.key(1), 8, 4, 3
    new, _, obj, x = epoch(params, opt, None, C, T, L, draws=_l2a_epoch_draws(key, C, n, T, L))
    jnew, _, jobj, jx = jepoch(jparams, jopt, key, C, T, L)
    assert float(obj) == float(jobj)
    _close(x, jx, rtol=0, atol=0)
    _same_trees(new, jnew)


def test_l2a_solves_small_graph():
    edges = r.generate_graph('ER', 30, seed=3)
    sim = r.MaxCutSimulator(edges, 30, device=CPU)
    ls_obj, _ = r.greedy_local_search(sim, 0, num_sims=512, num_iters=64)
    obj, x = r.l2a_solve(sim, 1, num_chains=128, num_epochs=8, num_transfers=16, num_ls=8)
    assert obj >= 0.9 * float(ls_obj)
    assert float(sim.obj(x[None])[0]) == obj


# ---------------------------------------------------------------- GraphTRS

def test_graph_trs_forward_and_step_as_jax():
    N, B = 10, 3
    adj = np.stack([r.edges_to_adjacency(r.generate_graph('ER', N, seed=s), N)
                    for s in range(B)]).astype(np.float32)
    jinit, jembed, jstep = jgt.make_graph_trs(N, embed_dim=8, num_heads=2, ff_dim=16)
    init, embed, step = r.make_graph_trs(N, embed_dim=8, num_heads=2, ff_dim=16, device=CPU)
    jparams, jopt = jax.jit(jinit)(jax.random.key(0))
    params = jp.graph_trs_params_from_numpy(_numpy(jparams), CPU)
    _close(embed(params, torch.tensor(adj)), jax.jit(jembed)(jparams, jnp.asarray(adj)))
    _, opt = init(0)
    new, _, loss, acc = step(params, opt, adj)
    jnew, _, jloss, jacc = jstep(jparams, jopt, jnp.asarray(adj))
    _close(loss, jloss)
    assert float(acc) == float(jacc)
    _same_trees(new, jnew)


def test_graph_trs_pretrains_and_transfers_to_l2a():
    params, embed, hist = r.pretrain_graph_trs(24, 'ER', num_graphs=32, num_steps=250,
                                               batch_size=16, embed_dim=32, device=CPU)
    losses, accs = [h[0] for h in hist], [h[1] for h in hist]
    assert losses[-1] < 0.4 * losses[0], hist
    assert accs[-1] > 0.8, hist
    edges = r.generate_graph('ER', 24, seed=777)
    with torch.no_grad():
        emb = embed(params, torch.tensor(r.edges_to_adjacency(edges, 24)[None],
                                         dtype=torch.float32))[0]
    assert bool(torch.isfinite(emb).all())
    sim = r.MaxCutSimulator(edges, 24, device=CPU)
    ls, _ = r.greedy_local_search(sim, 0, num_sims=256, num_iters=48)
    obj, x = r.l2a_solve(sim, 1, num_chains=128, num_epochs=6, num_transfers=16, num_ls=8,
                         node_embed=emb)
    assert obj >= 0.9 * float(ls), (obj, float(ls))
    assert float(sim.obj(x[None])[0]) == obj


# ------------------------------------------------------- attention-model TSP

def test_attention_tsp_forward_and_step_as_jax():
    N, B = 6, 4
    jinit, jtrain, jsolve = jam.make_attention_tsp(N, embed_dim=16, num_heads=4)
    init, train_step, solve = r.make_attention_tsp(N, embed_dim=16, num_heads=4, device=CPU)
    jparams, jopt = jax.jit(jinit)(jax.random.key(0))
    params = jp.am_params_from_numpy(_numpy(jparams), CPU)
    _, opt = init(0)
    key = jax.random.key(1)
    k1, k2 = split(key)
    coords = jax.random.uniform(k1, (B, N, 2))
    jnew, _, jcost, jbase = jtrain(jparams, jopt, coords, k2, B)
    new, _, cost, base = train_step(params, opt, np.array(coords), None, B,
                                    draws={'node': list(gumbel_each(split(k2, N), (B, N)))})
    _close(base, jbase)
    _close(cost, jcost)
    _same_trees(new, jnew)
    key = jax.random.key(2)
    city = jax.random.uniform(key, (N, 2))
    length, tour = solve(new, np.array(city), None, 5,
                         draws={'node': list(gumbel_each(split(key, N), (5, N)))})
    jlength, jtour = jsolve(jnew, city, key, 5)
    _close(length, jlength)
    _close(tour, jtour, rtol=0, atol=0)


def test_attention_tsp_learns():
    params, _, solve = r.train_attention_tsp(num_cities=10, num_steps=40, num_sims=64,
                                             verbose=False, device=CPU)
    cities = r.random_cities(10, seed=11)
    length, tour = solve(params, cities, 0)
    sim = r.TSPSimulator(cities, device=CPU)
    rnd = float(sim.tour_length(sim.rand_tours(2, 256)).min())
    assert float(length) < rnd
    assert sorted(tour.tolist()) == list(range(10))
