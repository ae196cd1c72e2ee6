"""``helloworld_torch``'s four self-contained PyTorch files against
``helloworld``'s JAX files on the CPU.

The JAX file's parameters are carried into the torch file's modules
through numpy (``load_state_dict``; a JAX ``(in, out)`` weight is a torch
``Linear``'s transpose) and its draws are replayed: the env step and the
net forwards agree within atol 1e-6 (the SAC log-probability within 2e-6:
a float32 ``softplus`` and ``log`` of another library); one update, from
the same minibatch and noise, gives the same losses and parameters within
rtol 1e-4.  That tolerance also covers the clip: ``clip_grad_norm_``
scales by ``3 / (norm + 1e-6)`` where optax's ``clip_by_global_norm``
scales by ``3 / norm``, a relative 1e-6 / norm.  Then one round of each
file's training loop and one evaluation run on the CPU, and ``main``
refuses to run on the CPU unless asked."""
import importlib.util
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ('DQN', 'PPO', 'REINFORCE', 'SAC')
UPD = dict(rtol=1e-4, atol=1e-6)


def _load(tree, algo):
    name = f'helloworld_{algo}_single_file'
    spec = importlib.util.spec_from_file_location(f'{tree}_{name}',
                                                  os.path.join(ROOT, tree, name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def mods():
    return {a: (_load('helloworld', a), _load('helloworld_torch', a)) for a in NAMES}


def load_mlp(seq: nn.Sequential, params) -> None:
    """The JAX file's ``[(w, b), ...]`` into the torch file's MLP."""
    lins = [i for i, m in enumerate(seq) if isinstance(m, nn.Linear)]
    state = {}
    for i, (w, b) in zip(lins, params):
        state[f'{i}.weight'] = torch.from_numpy(np.asarray(w).T.copy())
        state[f'{i}.bias'] = torch.from_numpy(np.asarray(b).copy())
    seq.load_state_dict(state)


def mlp_params(seq: nn.Sequential):
    return [(m.weight.detach().numpy().T, m.bias.detach().numpy())
            for m in seq if isinstance(m, nn.Linear)]


def close_params(seq, params, **tol):
    for (w, b), (jw, jb) in zip(mlp_params(seq), params):
        np.testing.assert_allclose(w, np.asarray(jw), **tol)
        np.testing.assert_allclose(b, np.asarray(jb), **tol)


def t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)


def cartpole_states(rng, n=64):
    s = rng.uniform(-0.3, 0.3, (n, 4)).astype(np.float32)
    steps = rng.integers(0, 500, n).astype(np.int32)
    steps[:4] = 499
    return s, steps


def pendulum_states(rng, n=64):
    th = rng.uniform(-8, 8, n).astype(np.float32)
    thd = rng.uniform(-8, 8, n).astype(np.float32)
    steps = rng.integers(0, 200, n).astype(np.int32)
    steps[:4] = 199
    return th, thd, steps


# ---------------------------------------------------------------- env steps

@pytest.mark.parametrize('algo', ['DQN', 'REINFORCE'])
def test_cartpole_step_matches_jax(mods, algo):
    jm, tm = mods[algo]
    s, steps = cartpole_states(np.random.default_rng(0))
    act = np.random.default_rng(1).integers(0, 2, len(s)).astype(np.int32)
    js = jm.EnvState(*[jnp.asarray(s[:, i]) for i in range(4)], jnp.asarray(steps))
    ts = tm.EnvState(*[t(s[:, i]) for i in range(4)], t(steps, torch.int32))
    jn, jr, jd = jax.vmap(jm.env_step)(js, jnp.asarray(act))
    tn, tr, td = tm.env_step(ts, t(act, torch.int64))
    for a, b in zip(tn, jn):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    assert np.array_equal(td.numpy(), np.asarray(jd)) and td.any()
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(tm.env_obs(tn).numpy(), np.asarray(jax.vmap(jm.env_obs)(jn)),
                               atol=1e-6)


@pytest.mark.parametrize('algo', ['PPO', 'SAC'])
def test_pendulum_step_matches_jax(mods, algo):
    jm, tm = mods[algo]
    th, thd, steps = pendulum_states(np.random.default_rng(2))
    act = np.random.default_rng(3).uniform(-1.2, 1.2, (len(th), 1)).astype(np.float32)
    js = jm.EnvState(jnp.asarray(th), jnp.asarray(thd), jnp.asarray(steps))
    ts = tm.EnvState(t(th), t(thd), t(steps, torch.int32))
    jn, jr, jd = jax.vmap(jm.env_step)(js, jnp.asarray(act))
    tn, tr, td = tm.env_step(ts, t(act))
    for a, b in zip(tn, jn):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6, atol=1e-6)
    assert np.array_equal(td.numpy(), np.asarray(jd)) and td.any()
    np.testing.assert_allclose(tm.env_obs(tn).numpy(), np.asarray(jax.vmap(jm.env_obs)(jn)),
                               atol=1e-6)


def test_ppo_vec_step_resets_done_envs(mods):
    _, tm = mods['PPO']
    th, thd, steps = pendulum_states(np.random.default_rng(4), 8)
    st = tm.EnvState(t(th), t(thd), t(steps, torch.int32))
    new, obs, r, done = tm.vec_step(st, torch.zeros(8, 1), torch.Generator().manual_seed(0))
    assert done[:4].all() and not done[4:].any()
    assert (new.t[:4] == 0).all() and (new.t[4:] == t(steps[4:] + 1, torch.int32)).all()
    assert (new.theta[:4].abs() <= math.pi).all() and obs.shape == (8, 3)


# ---------------------------------------------------------------- forwards

def _init(jm, key, dims, **kw):
    return jm.mlp_init(jax.random.PRNGKey(key), dims, **kw)


@pytest.mark.parametrize('algo,dims', [('DQN', (4, 128, 128, 2)), ('PPO', (3, 64, 64, 1)),
                                       ('REINFORCE', (4, 64, 64, 2)), ('SAC', (4, 64, 64, 2))])
def test_mlp_forward_matches_jax(mods, algo, dims):
    jm, tm = mods[algo]
    params = _init(jm, 7, dims)
    seq = tm.mlp(dims, torch.Generator().manual_seed(0))
    load_mlp(seq, params)
    x = np.random.default_rng(5).normal(size=(33, dims[0])).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(seq(t(x)).numpy(), np.asarray(jm.mlp(params, x)),
                                   rtol=0, atol=1e-6)


def test_ppo_init_shapes_and_output_layer_match_jax(mods):
    jm, tm = mods['PPO']
    seq = tm.mlp((3, 64, 64, 1), torch.Generator().manual_seed(0), out_std=0.1)
    jp = _init(jm, 0, (3, 64, 64, 1), out_std=0.1)
    assert [p.shape for p in mlp_params(seq)[0]] == [np.asarray(x).shape for x in jp[0]]
    w, b = mlp_params(seq)[-1]
    # orthogonal columns of norm 0.1, biases 1e-6, as jax's orthogonal(0.1)
    np.testing.assert_allclose(np.linalg.norm(w), 0.1, rtol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(jp[-1][0])), 0.1, rtol=1e-5)
    assert np.all(b == np.float32(1e-6))


def test_sac_sample_action_matches_jax(mods):
    jm, tm = mods['SAC']
    params = _init(jm, 8, (3, 64, 64, 2))
    actor = tm.mlp((3, 64, 64, 2), torch.Generator().manual_seed(0))
    load_mlp(actor, params)
    obs = np.random.default_rng(6).normal(size=(40, 3)).astype(np.float32) * 3
    key = jax.random.PRNGKey(9)
    ja, jlp = jm.sample_action(params, obs, key)
    noise = np.asarray(jax.random.normal(key, (40, 1)))
    with torch.no_grad():
        ta, tlp = tm.sample_action(actor, t(obs), t(noise))
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=0, atol=2e-6)
        mean, log_std = tm.actor_dist(actor, t(obs))
        jmean, jls = jm.actor_dist(params, obs)
        np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-6)
        np.testing.assert_allclose(log_std.numpy(), np.asarray(jls), atol=1e-6)


# ---------------------------------------------------------------- one update

@pytest.mark.parametrize('reward_scale', [1.0, 100.0])    # 100: the clip binds
def test_dqn_update_matches_jax(mods, reward_scale):
    jm, tm = mods['DQN']
    q, q_tgt = _init(jm, 1, (4, 128, 128, 2)), _init(jm, 2, (4, 128, 128, 2))
    agent = tm.agent_init(torch.Generator().manual_seed(0), 'cpu')
    load_mlp(agent.q, q)
    load_mlp(agent.q_tgt, q_tgt)
    rng = np.random.default_rng(7)
    B = jm.HP['batch']
    s, ns = (rng.normal(size=(B, 4)).astype(np.float32) for _ in range(2))
    a = rng.integers(0, 2, B).astype(np.int32)
    r = (rng.normal(size=B) * reward_scale).astype(np.float32)
    u = (rng.uniform(size=B) > 0.1).astype(np.float32)

    target = r + jm.HP['gamma'] * u * jnp.max(jm.mlp(q_tgt, ns), -1)

    def loss(qp):
        qv = jnp.take_along_axis(jm.mlp(qp, s), a[:, None], -1)[:, 0]
        return jnp.mean((qv - target) ** 2)

    jl, g = jax.value_and_grad(loss)(q)
    assert (float(optax.global_norm(g)) > 3.0) == (reward_scale > 1.0)
    up, _ = jm.OPT.update(g, jm.OPT.init(q), q)
    q2 = optax.apply_updates(q, up)
    tau = jm.HP['tau']
    tgt2 = jax.tree.map(lambda x, o: x * (1 - tau) + o * tau, q_tgt, q2)

    tl = tm.update(agent, t(s), t(a, torch.int64), t(r), t(u), t(ns))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    close_params(agent.q, q2, **UPD)
    close_params(agent.q_tgt, tgt2, **UPD)


def test_ppo_update_matches_jax(mods):
    jm, tm = mods['PPO']
    HP = jm.HP
    actor = _init(jm, 3, (3, 64, 64, 1), out_std=0.1)
    critic = _init(jm, 4, (3, 64, 64, 1), out_std=0.5)
    std_log = jnp.full((1, 1), -0.3)
    agent = tm.agent_init(torch.Generator().manual_seed(0), 'cpu')
    load_mlp(agent.actor, actor)
    load_mlp(agent.critic, critic)
    with torch.no_grad():
        agent.std_log.copy_(t(std_log))
    rng = np.random.default_rng(8)
    B = HP['batch']
    s = rng.normal(size=(B, 3)).astype(np.float32)
    a = rng.normal(size=(B, 1)).astype(np.float32)
    lp = np.asarray(jm.logprob_fn(jm.mlp(actor, s), jnp.exp(std_log), a)) + \
        rng.normal(size=B).astype(np.float32) * 0.3
    adv = rng.normal(size=B).astype(np.float32)
    tgt = rng.normal(size=B).astype(np.float32) * 10

    def critic_loss(cp):
        return jnp.mean((jm.mlp(cp, s)[:, 0] - tgt) ** 2)

    jcl, gc = jax.value_and_grad(critic_loss)(critic)
    up, _ = jm.OPT.update(gc, jm.OPT.init(critic), critic)
    critic2 = optax.apply_updates(critic, up)

    def actor_loss(ap_sl):
        ap, sl = ap_sl
        mean, std = jm.mlp(ap, s), jnp.exp(sl)
        ratio = jnp.exp(jm.logprob_fn(mean, std, a) - lp)
        surr = jnp.minimum(adv * ratio, adv * jnp.clip(ratio, 1 - HP['clip'], 1 + HP['clip']))
        ent = jnp.sum(0.5 + 0.5 * jnp.log(2 * jnp.pi) + jnp.log(std), -1)
        return -(surr.mean() - HP['lambda_entropy'] * ent.mean())

    jal, ga = jax.value_and_grad(actor_loss)((actor, std_log))
    up, _ = jm.OPT.update(ga, jm.OPT.init((actor, std_log)), (actor, std_log))
    actor2, std_log2 = optax.apply_updates((actor, std_log), up)

    tcl, tal = tm.update(agent, t(s), t(a), t(lp), t(adv), t(tgt))
    np.testing.assert_allclose(float(tcl), float(jcl), rtol=1e-4)
    np.testing.assert_allclose(float(tal), float(jal), rtol=1e-4)
    close_params(agent.critic, critic2, **UPD)
    close_params(agent.actor, actor2, **UPD)
    np.testing.assert_allclose(agent.std_log.detach().numpy(), np.asarray(std_log2), **UPD)


def test_ppo_advantages_match_jax(mods):
    jm, tm = mods['PPO']
    rng = np.random.default_rng(9)
    H, N = 16, 5
    R, V = (rng.normal(size=(H, N)).astype(np.float32) for _ in range(2))
    U = (rng.uniform(size=(H, N)) > 0.2).astype(np.float32)
    nv = rng.normal(size=N).astype(np.float32)
    g, lam = jm.HP['gamma'], jm.HP['lam']

    def gae_body(c, x):         # the JAX file's GAE step
        nxt, adv = c
        r, u, v = x
        delta = r + g * u * nxt - v
        adv = delta + g * lam * u * adv
        return (v, adv), adv

    ADV, TGT = tm.advantages(t(R), t(U), t(V), t(nv))
    _, JADV = jax.lax.scan(gae_body, (nv, np.zeros(N, np.float32)), (R, U, V), reverse=True)
    np.testing.assert_allclose(ADV.numpy(), np.asarray(JADV), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(TGT.numpy(), np.asarray(JADV) + V, rtol=1e-5, atol=1e-5)


def test_reinforce_update_matches_jax(mods):
    jm, tm = mods['REINFORCE']
    params = _init(jm, 5, (4, 64, 64, 2))
    policy = tm.mlp((4, 64, 64, 2), torch.Generator().manual_seed(0))
    load_mlp(policy, params)
    opt = torch.optim.Adam(policy.parameters(), lr=jm.HP['lr'])
    rng = np.random.default_rng(10)
    H, N = 12, 6
    S = rng.normal(size=(H, N, 4)).astype(np.float32)
    A = rng.integers(0, 2, (H, N)).astype(np.int32)
    R = np.ones((H, N), np.float32)
    U = (rng.uniform(size=(H, N)) > 0.1).astype(np.float32)

    def ret_body(nxt, x):
        r, u = x
        ret = r + jm.HP['gamma'] * u * nxt
        return ret, ret

    _, G = jax.lax.scan(ret_body, jnp.zeros(N), (R, U), reverse=True)
    G = (G - G.mean()) / (G.std() + 1e-6)
    np.testing.assert_allclose(tm.returns(t(R), t(U)).numpy(), np.asarray(G),
                               rtol=1e-5, atol=1e-5)

    def loss_fn(p):
        logp = jnp.take_along_axis(jax.nn.log_softmax(jm.mlp(p, S)), A[..., None], -1)[..., 0]
        return -jnp.mean(logp * G)

    jl, g = jax.value_and_grad(loss_fn)(params)
    up, _ = jm.OPT.update(g, jm.OPT.init(params), params)
    params2 = optax.apply_updates(params, up)
    tl = tm.update(policy, opt, t(S), t(A, torch.int64), t(G))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4, atol=1e-7)
    close_params(policy, params2, **UPD)


def test_sac_update_matches_jax(mods):
    jm, tm = mods['SAC']
    HP = jm.HP
    actor = _init(jm, 11, (3, 64, 64, 2))
    critic = _init(jm, 12, (4, 64, 64, 2))
    critic_tgt = _init(jm, 13, (4, 64, 64, 2))
    alpha_log = jnp.asarray(-1.0)
    ag = tm.agent_init(torch.Generator().manual_seed(0), 'cpu')
    load_mlp(ag.actor, actor)
    load_mlp(ag.critic, critic)
    load_mlp(ag.critic_tgt, critic_tgt)
    rng = np.random.default_rng(11)
    B = HP['batch']
    s, ns = (rng.normal(size=(B, 3)).astype(np.float32) for _ in range(2))
    a = rng.uniform(-1, 1, (B, 1)).astype(np.float32)
    r = rng.normal(size=B).astype(np.float32) * 5
    u = (rng.uniform(size=B) > 0.05).astype(np.float32)
    k_n, k_pg = jax.random.split(jax.random.PRNGKey(3))

    # the JAX file's sgd_body, one step from fresh optimizer states
    na, nlp = jm.sample_action(actor, ns, k_n)
    target = r + HP['gamma'] * u * (jnp.min(jm.q_twin(critic_tgt, ns, na), -1)
                                    - jnp.exp(alpha_log) * nlp)

    def c_loss(cp):
        return jnp.mean(jnp.square(jm.q_twin(cp, s, a) - target[:, None]))

    jcl, gc = jax.value_and_grad(c_loss)(critic)
    up, _ = jm.OPT.update(gc, jm.OPT.init(critic), critic)
    critic2 = optax.apply_updates(critic, up)
    tgt2 = jax.tree.map(lambda x, o: x * (1 - HP['tau']) + o * HP['tau'], critic_tgt, critic2)
    _, lp_now = jm.sample_action(actor, s, k_pg)
    jall, g_al = jax.value_and_grad(
        lambda al: jnp.mean(al * (HP['target_entropy'] - lp_now)))(alpha_log)
    up, _ = jm.A_OPT.update(g_al, jm.A_OPT.init(alpha_log), alpha_log)
    alpha_log2 = jnp.clip(optax.apply_updates(alpha_log, up), -16, 2)

    def a_loss(ap):
        act_pg, lp = jm.sample_action(ap, s, k_pg)
        return -jnp.mean(jnp.min(jm.q_twin(critic2, s, act_pg), -1) - jnp.exp(alpha_log2) * lp)

    jal, ga = jax.value_and_grad(a_loss)(actor)
    up, _ = jm.OPT.update(ga, jm.OPT.init(actor), actor)
    actor2 = optax.apply_updates(actor, up)

    noise_n = np.asarray(jax.random.normal(k_n, (B, 1)))
    noise_pg = np.asarray(jax.random.normal(k_pg, (B, 1)))
    tcl, tall, tal = tm.update(ag, t(s), t(a), t(r), t(u), t(ns), t(noise_n), t(noise_pg))
    np.testing.assert_allclose(float(tcl), float(jcl), rtol=1e-4)
    np.testing.assert_allclose(float(tall), float(jall), rtol=1e-4)
    np.testing.assert_allclose(float(tal), float(jal), rtol=1e-4)
    close_params(ag.critic, critic2, **UPD)
    close_params(ag.critic_tgt, tgt2, **UPD)
    close_params(ag.actor, actor2, **UPD)
    np.testing.assert_allclose(float(ag.alpha_log.detach()), float(alpha_log2), **UPD)


# ---------------------------------------------------------------- the loop

@pytest.mark.parametrize('algo', NAMES)
def test_one_round_of_main_loop_on_the_cpu(mods, algo):
    _, tm = mods[algo]
    torch.set_num_threads(2)
    carry = tm.init_carry(torch.device('cpu'))
    carry, exp_r = tm.train_round(carry)
    assert math.isfinite(float(exp_r))
    net = {'DQN': lambda c: c.agent.q, 'PPO': lambda c: c.agent,
           'REINFORCE': lambda c: c.policy, 'SAC': lambda c: c.agent.actor}[algo](carry)
    avg_r = tm.evaluate(net, torch.Generator().manual_seed(100))
    assert math.isfinite(avg_r)
    assert carry.obs.shape == (tm.HP['num_envs'], 3 if algo in ('PPO', 'SAC') else 4)


def test_ppo_seed_sets_the_training_draws(mods):
    _, tm = mods['PPO']
    cpu = torch.device('cpu')
    base, same, other = tm.init_carry(cpu), tm.init_carry(cpu, 0), tm.init_carry(cpu, 1)
    for a, b in zip(base.agent.actor.parameters(), same.agent.actor.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(base.obs, same.obs)
    assert not torch.equal(base.obs, other.obs)
    assert not all(torch.equal(a, b) for a, b in zip(base.agent.actor.parameters(),
                                                     other.agent.actor.parameters()))


def test_sac_updater_keeps_the_updates_losses(mods):
    """``Updater.losses`` are the losses ``update`` returns for the same
    minibatch (on the card the graph's outputs, which ``chip_smoke.py``'s
    ``helloworld_sac_graph`` holds against the eager update)."""
    _, tm = mods['SAC']
    cpu = torch.device('cpu')
    ring = tm.Ring(cpu)
    gen = torch.Generator().manual_seed(0)
    n = tm.HP['num_envs']
    ring.add(torch.randn((20, n, 3), generator=gen), torch.rand((20, n, 1), generator=gen),
             torch.randn((20, n), generator=gen), torch.ones((20, n)))
    eager = tm.agent_init(torch.Generator().manual_seed(0), cpu)
    updater = tm.Updater(tm.agent_init(torch.Generator().manual_seed(0), cpu), ring)
    for rows in (19, 12):
        ids = torch.randint(0, rows * n, (32,), generator=gen)
        noise = torch.randn((2, 32, 1), generator=gen)
        want = tm.update(eager, *ring.gather(ids, rows), noise[0], noise[1])
        updater(ids, rows, noise)
        assert all(torch.equal(g, w) for g, w in zip(updater.losses, want))


@pytest.mark.parametrize('algo', NAMES)
def test_main_runs_on_the_card_unless_asked(mods, algo):
    _, tm = mods[algo]
    assert tm.pick_device('cpu') == torch.device('cpu')
    if torch.cuda.is_available():
        assert tm.pick_device(None).type == 'cuda'
        return
    with pytest.raises(RuntimeError, match='--device cpu'):
        tm.main()


@pytest.mark.parametrize('algo', NAMES)
def test_single_file_imports_torch_and_numpy_only(algo):
    src = open(os.path.join(ROOT, 'helloworld_torch', f'helloworld_{algo}_single_file.py')).read()
    mods_ = {a or b for a, b in re.findall(r'^\s*(?:import (\w+)|from (\w+)[\w.]* import )',
                                           src, re.M)}
    assert mods_ <= {'argparse', 'math', 'time', 'typing', 'numpy', 'torch'}, mods_
    assert not re.search(r'\b(jax|optax)\b|elegantrl_tpu', src)
