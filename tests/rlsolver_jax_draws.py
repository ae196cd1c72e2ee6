"""The JAX draws of ``elegantrl_tpu/rlsolver``'s stochastic functions, the
keys split as each JAX function splits them, named as the port's
``draws=`` takes them (``elegantrl_tpu_torch/rlsolver/_draws.py``): shared
by ``test_torch_rlsolver.py`` and ``test_torch_rlsolver_problems.py``."""
import jax
import numpy as np

split = jax.random.split


def _np(x, dtype=None):
    return np.asarray(x, dtype)


def bern(key, p, shape):
    return _np(jax.random.bernoulli(key, p, shape), np.float32)


def bern_each(keys, p, shape):
    return _np(jax.vmap(lambda k: jax.random.bernoulli(k, p, shape))(keys), np.float32)


def uniform_each(keys, shape):
    return _np(jax.vmap(lambda k: jax.random.uniform(k, shape))(keys))


def randint_each(keys, high, shape):
    return _np(jax.vmap(lambda k: jax.random.randint(k, shape, 0, high))(keys))


def gumbel_each(keys, shape):
    return _np(jax.vmap(lambda k: jax.random.gumbel(k, shape))(keys))


def pairs(keys):
    """Each key split in two (the JAX drivers' ``k_a, k_b = split(key_t)``)."""
    both = jax.vmap(split)(keys)
    return both[:, 0], both[:, 1]


def add(d, extra):
    """``d`` with the lists of ``extra`` appended to its own, name by name."""
    out = {k: list(v) for k, v in d.items()}
    for k, v in extra.items():
        out.setdefault(k, []).extend(list(v))
    return out


# the drivers of maxcut.py / methods.py (``p``: rand_xs's probability)

def sweep_draws(key, shape, num, name='coin'):
    """``local_search_sweep`` (coins) or the one-flip searches (``'tie'``
    uniforms): one draw per key of ``split(key, num)``."""
    keys = split(key, num)
    return {name: bern_each(keys, 0.5, shape) if name == 'coin' else uniform_each(keys, shape)}


def random_search_draws(key, S, N, rounds, p=0.5):
    return {'rand_xs': bern_each(split(key, rounds), p, (S, N))}


def random_walk_draws(key, S, N, steps):
    k_init, k_run = split(key)
    return {'rand_xs': [bern(k_init, 0.5, (S, N))],
            'node': randint_each(split(k_run, steps), N, (S,))}


def greedy_ls_draws(key, S, N, iters, p=0.5, search='coin'):
    k1, k2 = split(key)
    return add({'rand_xs': [bern(k1, p, (S, N))]}, sweep_draws(k2, (S, N), iters, search))


def sa_draws(key, S, N, steps, p=0.5):
    k_init, k_run = split(key)
    k_node, k_acc = pairs(split(k_run, steps))
    return {'rand_xs': [bern(k_init, p, (S, N))], 'node': randint_each(k_node, N, (S,)),
            'accept': uniform_each(k_acc, (S,))}


def isco_draws(key, S, N, steps, path, p=0.5):
    k_init, k_run = split(key)
    moves = jax.vmap(lambda k: split(k, path))(split(k_run, steps)).reshape(-1)
    k_sel, k_acc = pairs(moves)
    return {'rand_xs': [bern(k_init, p, (S, N))], 'select': gumbel_each(k_sel, (S, N)),
            'accept': uniform_each(k_acc, (S,))}


def metro_draws(key, C, N, transfers):
    k_node, k_acc = pairs(split(key, transfers))
    return {'node': randint_each(k_node, N, (C,)), 'accept': uniform_each(k_acc, (C,))}


def mcpg_draws(key, C, N, epochs, transfers, num_ls):
    k_init, key = split(key)
    d = {'rand_xs': [bern(k_init, 0.5, (C, N))]}
    for _ in range(epochs):
        k_metro, k_ls, key = split(key, 3)
        d = add(d, metro_draws(k_metro, C, N, transfers))
        d = add(d, sweep_draws(k_ls, (C, N), num_ls))
    return d


# the other problems' simulators and drivers

def permutations_each(keys, n):
    return _np(jax.vmap(lambda k: jax.random.permutation(k, n))(keys))


def coloring_ls_draws(key, S, N, K, sweeps):
    k_tie, k_coin = pairs(split(key, sweeps))
    return {'tie': uniform_each(k_tie, (S, N, K)), 'coin': bern_each(k_coin, 0.5, (S, N))}


def color_graph_draws(key, S, N, K, sweeps):
    k1, k2 = split(key)
    return add({'rand_xs': [_np(jax.random.randint(k1, (S, N), 0, K))]},
               coloring_ls_draws(k2, S, N, K, sweeps))


def isco_tsp_draws(key, S, n, steps):
    k_init, k_run = split(key)
    k_sel, k_acc = pairs(split(k_run, steps))
    return {'rand_tours': [permutations_each(split(k_init, S), n)],
            'select': gumbel_each(k_sel, (S, n * n)), 'accept': uniform_each(k_acc, (S,))}


def ga_draws(key, P, N, generations, sweeps, search='coin', p=0.5, mutate_p=0.02, k=2):
    """``genetic_algorithm``: the population and its search, then per
    generation two tournaments, the crossover, the mutation and the
    children's search (``search``: the simulator's draw)."""
    k_init, k_ls0, k_run = split(key, 3)
    d = add({'rand_xs': [bern(k_init, p, (P, N))]}, sweep_draws(k_ls0, (P, N), sweeps, search))
    for kt in split(k_run, generations):
        k_pa, k_pb, k_cx, k_mut, k_ls = split(kt, 5)
        d = add(d, {'tournament': [_np(jax.random.randint(k_pa, (P, k), 0, P)),
                                   _np(jax.random.randint(k_pb, (P, k), 0, P))],
                    'crossover': [bern(k_cx, 0.5, (P, N))],
                    'mutate': [bern(k_mut, mutate_p, (P, N))]})
        d = add(d, sweep_draws(k_ls, (P, N), sweeps, search))
    return d


def sdp_draws(key, n, k, roundings):
    k_init, k_round = split(key)
    return {'v0': [_np(jax.random.normal(k_init, (n, k)))],
            'round': [_np(jax.random.normal(k_round, (k, roundings)))]}


# vrp.py and tnco.py

def normal_each(keys, shape):
    return _np(jax.vmap(lambda k: jax.random.normal(k, shape))(keys))


def vrptw_draws(key, S, n):
    """``VRPTWSimulator.construct``: one ``(S, n)`` uniform a step of
    ``split(key, 2 n)``."""
    return {'jitter': uniform_each(split(key, 2 * n), (S, n))}


def tnco_greedy_draws(key, S, n):
    """``tnco_greedy``: replica ``s`` splits ``split(key, S)[s]`` into its
    ``n - 1`` step keys; the port takes one ``(S, n, n)`` Gumbel a step."""
    steps = jax.vmap(lambda k: split(k, n - 1))(split(key, S))
    g = jax.vmap(jax.vmap(lambda k: jax.random.gumbel(k, (n, n))))(steps)   # (S, n - 1, n, n)
    return {'gumbel': np.swapaxes(_np(g), 0, 1)}


def tnco_anneal_draws(key, S, E, steps):
    k0, k1 = split(key)
    k_a, k_b = pairs(split(k1, steps))
    return {'rand_xs': [_np(jax.random.normal(k0, (S, E)))],
            'prop': normal_each(k_a, (S, E)), 'accept': uniform_each(k_b, (S,))}
