"""``elegantrl_tpu_torch/rlsolver/eco_dqn.py`` against
``elegantrl_tpu/rlsolver/eco_dqn.py`` on the CPU: the pool, the Zobrist
hash bitwise (revisit detection depends on it), reset, step and the
observation over a few flips (counts, hashes and rings exactly, floats
within 1e-6), the learning-rate schedule at its corners (exactly: both in
float32), the MPNN on the JAX weights within 1e-5 on both edge paths,
training rounds on the JAX weights and draws (parameters within 1e-5),
greedy inference on the JAX draws, a dp = 2 mesh round against the
unsharded round on the same transitions (the averaged update, within 1e-5;
the parameters identical on both shards), the divisibility guard, and the
JAX package's quality tests (``tests/test_eco_dqn.py``) at their sizes."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elegantrl_tpu.rlsolver import eco_dqn as je
from elegantrl_tpu_torch import rlsolver as r
from elegantrl_tpu_torch.parallel import make_mesh
from elegantrl_tpu_torch.rlsolver import eco_dqn as e
from elegantrl_tpu_torch.utils import jax_params as jp
from elegantrl_tpu_torch.utils.checkpoint import tree_leaves
from rlsolver_jax_draws import bern, pairs, split

CPU = 'cpu'


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ba_adjs(g, n, seed=0):
    return np.stack([r.edges_to_adjacency(r.generate_graph('BA', n, seed=seed + i), n)
                     for i in range(g)])


def _np(x):
    return np.asarray(x)


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(got.detach().cpu().numpy() if torch.is_tensor(got) else got,
                               _np(want), rtol=rtol, atol=atol)


def _same(got, want):
    np.testing.assert_array_equal(got.cpu().numpy(), _np(want).astype(got.cpu().numpy().dtype))


def _env_as_jax(env, jenv, floats=1e-6):
    for f in ('spins', 'best_spins', 'step', 'gidx', 'zhash', 'ring'):
        _same(getattr(env, f), getattr(jenv, f))
    for f in ('score', 'best_score', 'tsf'):
        _close(getattr(env, f), getattr(jenv, f), floats, floats)


def _reset_draws(key, batch, n, num_graphs=None):
    kg, ks, _ = split(key, 3)
    d = {'spins': [bern(ks, 0.5, (batch, n))]}
    if num_graphs is not None:
        d['gidx'] = [_np(jax.random.randint(kg, (batch,), 0, num_graphs))]
    return d


def test_pool_and_zobrist_bitwise():
    for n in (24, 23):            # an odd count pads the pairwise halving
        adjs = _ba_adjs(3, n)
        pool, jpool = e.build_pool(adjs, device=CPU), je.build_pool(adjs)
        _same(pool.zkeys, jpool.zkeys)
        _same(pool.max_local, jpool.max_local)
        assert pool.pm_one is jpool.pm_one is True
        jspins = jnp.where(jax.random.bernoulli(jax.random.key(n), 0.5, (64, n)), 1.0, -1.0)
        h = e._zobrist(pool.zkeys, torch.tensor(_np(jspins)))
        jh = jax.jit(je._zobrist)(jpool.zkeys, jspins)
        assert h.dtype == torch.int64 and int(h.max()) < 2 ** 32
        _same(h, jh)
    assert e.build_pool(adjs * 0.5, device=CPU).pm_one is False


def test_reset_step_and_observe_as_jax():
    """Flips from a reset, one of them undone (a revisit: no basin reward,
    the ring holds the hash), on the JAX reset draws."""
    n, B = 24, 8
    adjs = _ba_adjs(4, n)
    pool, jpool = e.build_pool(adjs, device=CPU), je.build_pool(adjs)
    key = jax.random.key(0)
    jenv = jax.jit(lambda k: je.eco_reset(jpool, k, B, 2 * n))(key)
    env = e.eco_reset(pool, None, B, 2 * n, draws=_reset_draws(key, B, n, 4))
    _env_as_jax(env, jenv)
    jobs, jstep = jax.jit(lambda s: je.eco_observe(jpool, s)), jax.jit(
        lambda s, a: je.eco_step(jpool, s, a, 1.0 / n))
    rng = np.random.default_rng(1)
    actions = [rng.integers(0, n, B) for _ in range(6)]
    actions.insert(3, actions[2])           # flip the same nodes back
    for a in actions:
        _close(e.eco_observe(pool, env), jobs(jenv), 1e-6, 1e-6)
        env, rew, done = e.eco_step(pool, env, torch.tensor(a), 1.0 / n)
        jenv, jrew, jdone = jstep(jenv, jnp.asarray(a, jnp.int32))
        _env_as_jax(env, jenv)
        _close(rew, jrew, 1e-6, 1e-6)
        _same(done, jdone)
    _close(e._cut_value(pool.adj[env.gidx], env.spins), env.score, 1e-6, 1e-4)


def test_lr_schedule_at_its_corners():
    final, peak, ramp, decay = 1e-4, 1e-3, 300, 6000
    sched = e.eco_lr_schedule(final, peak, ramp, decay)
    jsched = optax.join_schedules([optax.linear_schedule(final, peak, ramp),
                                   optax.linear_schedule(peak, final, decay)], [ramp])
    for count in (0, 1, 150, ramp - 1, ramp, ramp + 1, ramp + decay // 2, ramp + decay - 1,
                  ramp + decay, ramp + decay + 7):
        assert sched(count) == float(jsched(count)), count


@pytest.mark.parametrize('weights', ['pm_one', 'general'])
def test_mpnn_as_jax(weights):
    n, B = 20, 5
    adjs = _ba_adjs(2, n, seed=4)
    if weights == 'general':
        adjs = adjs * np.where(np.arange(n)[:, None] < n // 2, 0.5, -2.0).astype(np.float32)
        adjs = np.triu(adjs, 1) + np.triu(adjs, 1).transpose(0, 2, 1)
    pool, jpool = e.build_pool(adjs, device=CPU), je.build_pool(adjs)
    jparams = jax.jit(lambda k: je.init_mpnn(k, 16, 2))(jax.random.key(0))
    params = jp.mpnn_params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    key = jax.random.key(1)
    jenv = jax.jit(lambda k: je.eco_reset(jpool, k, B, 2 * n))(key)
    env = e.eco_reset(pool, None, B, 2 * n, draws=_reset_draws(key, B, n, 2))
    obs, adj = e.eco_observe(pool, env), pool.adj[env.gidx]
    q = e.mpnn_q(params, obs, adj, pool.pm_one)
    jq = jax.jit(lambda p, s: je.mpnn_q(p, je.eco_observe(jpool, s), jpool.adj[s.gidx],
                                        jpool.pm_one))(jparams, jenv)
    _close(q, jq)
    if weights == 'pm_one':     # the two-product path equals the chunked sum
        _close(q, e.mpnn_q(params, obs, adj, False), 1e-5, 1e-6)


def _round_draws(key, kk, B, n, steps, mb, cap, eps_final, decay):
    """The JAX round's draws, step by step (no episode ends: the per-env
    keys and so the reset spins stay as at reset)."""
    _, _, ke = split(split(key, 3)[1], 3)
    env_keys = split(ke, B)
    reset = _np(jax.vmap(lambda k: jax.random.bernoulli(split(k)[0], 0.5, (n,)))(env_keys))
    d = {k: [] for k in ('rand_action', 'use_rand', 'rows', 'reset_spins')}
    for t in range(steps):
        kk, k_eps, k_act, k_smp = split(kk, 4)
        eps = jnp.maximum(eps_final, 1.0 - (1.0 - eps_final) * jnp.float32(t) / decay)
        d['rand_action'].append(_np(jax.random.randint(k_eps, (B,), 0, n)))
        d['use_rand'].append(_np(jax.random.bernoulli(k_act, eps, (B,))).astype(np.float32))
        d['rows'].append(_np(jax.random.randint(k_smp, (mb,), 0, min((t + 1) * B, cap))))
        d['reset_spins'].append(reset.astype(np.float32))
    return d


def test_training_round_as_jax():
    """Rounds from the JAX weights on the JAX draws: the epsilon-greedy
    steps, the pushes, the minibatch updates (zeroed until warm, Adam on
    the schedule) and a target sync."""
    n, B, mb, cap, steps = 16, 8, 8, 256, 6
    cfg = dict(batch=B, features=16, layers=2, replay_cap=cap, minibatch=mb,
               eps_decay_steps=5, target_freq=4, lr_peak=5e-3, lr_final=1e-3, lr_ramp=3,
               lr_decay=10)
    adjs = _ba_adjs(4, n, seed=7)
    pool, jpool = e.build_pool(adjs, device=CPU), je.build_pool(adjs)
    jinit, jround = je.make_eco_dqn(jpool, **cfg)
    init, round_fn = e.make_eco_dqn(pool, **cfg)
    key = jax.random.PRNGKey(0)       # raw keys, as the JAX trainer's per-env keys are
    jts = jax.jit(jinit)(key)
    kp, ke, kk = split(key, 3)
    ts = init(None, draws=_reset_draws(ke, B, n, 4))
    params = jp.mpnn_params_from_numpy(jax.tree.map(np.asarray, jts.params), CPU)
    ts = ts._replace(params=params, target=params, shard_params=(params,))
    _env_as_jax(ts.env, jts.env)
    ts, ms = round_fn(ts, steps, draws=_round_draws(key, kk, B, n, steps, mb, cap, 0.05, 5))
    jts, jms = jround(jts, steps)
    _env_as_jax(ts.env, jts.env)
    assert ts.tick == int(jts.tick) == steps and ts.opt.count == steps
    for a, b in zip(tree_leaves(ts.params), tree_leaves(jax.tree.map(np.asarray, jts.params))):
        _close(a, b)
    for a, b in zip(tree_leaves(ts.target), tree_leaves(jax.tree.map(np.asarray, jts.target))):
        _close(a, b)
    _close(ms['loss'], jms['loss'])
    assert float(ms['best']) == float(jms['best']) and float(ms['eps']) == float(jms['eps'])
    _same(ts.rb.action[:steps * B], jts.rb.action[:steps * B])


@pytest.mark.parametrize('eps', [0.0, 0.1], ids=['greedy', 'exploratory'])
def test_greedy_solve_as_jax(eps):
    n, R, steps = 16, 6, 20
    adj = _ba_adjs(1, n, seed=11)[0]
    jparams = jax.jit(lambda k: je.init_mpnn(k, 16, 2))(jax.random.key(2))
    params = jp.mpnn_params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    key = jax.random.key(3)
    k_run, k_env = split(key)
    draws = _reset_draws(k_env, R, n)
    if eps > 0:
        k_u, k_a = pairs(split(k_run, steps))
        draws['rand_action'] = list(jax.vmap(lambda k: jax.random.randint(k, (R,), 0, n))(k_a))
        draws['explore'] = list(jax.vmap(lambda k: jax.random.uniform(k, (R,)))(k_u))
    cut, spins = e.eco_greedy_solve(params, adj, num_restarts=R, steps=steps, eps=eps,
                                    draws=draws)
    jcut, jspins = je.eco_greedy_solve(jparams, adj, num_restarts=R, steps=steps, key=key,
                                       eps=eps)
    assert cut == jcut
    np.testing.assert_array_equal(spins, jspins)


def test_mesh_round_matches_the_unsharded_averaged_update():
    """dp = 2 on two CPU shards against the unsharded round on the same
    transitions: each shard's env half and its rows of its own ring are the
    unsharded round's, so the mean of the shards' gradients is the
    unsharded minibatch's; the update is copied to both shards."""
    n, B, mb, cap, steps = 16, 8, 8, 64, 5
    cfg = dict(batch=B, features=16, layers=2, replay_cap=cap, minibatch=mb,
               eps_decay_steps=4, target_freq=3, lr_peak=5e-3, lr_final=1e-3, lr_ramp=2,
               lr_decay=10)
    pool = e.build_pool(_ba_adjs(4, n, seed=7), device=CPU)
    mesh = make_mesh({'dp': 2}, devices=[CPU, CPU])
    rng = np.random.default_rng(0)
    init_d = {'gidx': [rng.integers(0, 4, B)],
              'spins': [(rng.random((B, n)) < 0.5).astype(np.float32)]}
    flat = {k: [] for k in ('rand_action', 'use_rand', 'rows', 'reset_spins')}
    shard = [{k: [] for k in flat} for _ in range(2)]
    half, mb_l = B // 2, mb // 2
    for t in range(steps):
        ra, ur = rng.integers(0, n, B), (rng.random(B) < 0.5).astype(np.float32)
        rs = (rng.random((B, n)) < 0.5).astype(np.float32)
        local = [rng.integers(0, (t + 1) * half, mb_l) for _ in range(2)]
        # a shard's ring row j holds step j // half, env r * half + j % half
        flat['rows'].append(np.concatenate([(j // half) * B + rr * half + j % half
                                            for rr, j in enumerate(local)]))
        for k, v in (('rand_action', ra), ('use_rand', ur), ('reset_spins', rs)):
            flat[k].append(v)
            for rr in range(2):
                shard[rr][k].append(v[rr * half:(rr + 1) * half])
        for rr in range(2):
            shard[rr]['rows'].append(local[rr])
    init1, round1 = e.make_eco_dqn(pool, **cfg)
    init2, round2 = e.make_eco_dqn(pool, mesh=mesh, **cfg)
    ts1 = init1(0, draws=init_d)
    ts2 = init2(0, draws=init_d)
    ts2 = ts2._replace(params=ts1.params, target=ts1.params,
                       shard_params=(ts1.params, ts1.params))
    ts1, m1 = round1(ts1, steps, draws=flat)
    ts2, m2 = round2(ts2, steps, draws=shard)
    for a, b in zip(tree_leaves(ts2.params), tree_leaves(ts1.params)):
        _close(a, b)
    for a, b in zip(tree_leaves(ts2.target), tree_leaves(ts1.target)):
        _close(a, b)
    for a, b in zip(tree_leaves(ts2.shard_params[0]), tree_leaves(ts2.shard_params[1])):
        assert torch.equal(a, b)
    _close(m2['loss'], m1['loss'])
    assert float(m2['best']) == float(m1['best'])
    for rr in range(2):
        _same(ts2.env[rr].spins, ts1.env.spins[rr * half:(rr + 1) * half].numpy())


def test_mesh_divisibility_guard():
    pool = e.build_pool(_ba_adjs(2, 12, seed=3), device=CPU)
    mesh = make_mesh({'dp': 4}, devices=[CPU] * 4)
    with pytest.raises(ValueError, match='divisible'):
        e.make_eco_dqn(pool, batch=6, mesh=mesh)


def test_eco_learns_and_beats_untrained():
    adjs = _ba_adjs(4, 16, seed=7)
    pool = e.build_pool(adjs, device=CPU)
    init_fn, round_fn = e.make_eco_dqn(
        pool, batch=16, features=32, layers=2, replay_cap=2048, eps_decay_steps=300,
        target_freq=25, lr_peak=5e-3, lr_final=1e-3, lr_ramp=50, lr_decay=500)
    ts = init_fn(0)
    params0 = ts.params
    ts, ms = round_fn(ts, 600)
    assert np.isfinite(float(ms['loss']))
    cut0, _ = e.eco_greedy_solve(params0, adjs[0], num_restarts=8, gen=5)
    cut1, spins = e.eco_greedy_solve(ts.params, adjs[0], num_restarts=8, gen=5)
    assert cut1 >= cut0, (cut1, cut0)
    sim = r.MaxCutSimulator(r.generate_graph('BA', 16, seed=7), 16, device=CPU)
    xs = sim.local_search_sweep(sim.rand_xs(6, 8), 7, num_sweeps=16)
    ls_best = float(sim.obj(xs).max())
    assert cut1 >= ls_best - 1.0, (cut1, ls_best)
    spins64 = spins.astype(np.float64)
    assert (adjs[0].sum() - spins64 @ adjs[0] @ spins64) / 4.0 == cut1
    cut_e, spins_e = e.eco_greedy_solve(ts.params, adjs[0], num_restarts=8, gen=3, eps=0.1)
    spins64 = spins_e.astype(np.float64)
    assert cut_e > 0 and (adjs[0].sum() - spins64 @ adjs[0] @ spins64) / 4.0 == cut_e
