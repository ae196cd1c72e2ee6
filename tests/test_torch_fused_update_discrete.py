"""Parity of the discrete head of the port's fused-update plain version
(``ops/fused_update.py:ppo_update_reference(discrete=True)``) with the JAX
package's Pallas update kernel in interpret mode
(``make_ppo_fused_update(discrete=True, interpret=True)``) on the same
one-hot ``(U, A, B)`` block, params and Adam moments; of the port's discrete
PPO ``update`` and its A2C ``update`` (continuous and discrete) with the JAX
scan-path ``update`` on the same rollout and the same minibatch ids; and the
gradients of the plain losses, including the backward formulas that the
CUDA kernel writes out by hand.

Tolerances, as the JAX package's own update tests: parameter UPDATES
(new - old) and Adam moments to rtol 5e-3, metrics to rtol 1e-4 (atol 1e-5
for objectives that are sums of near-cancelling terms).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu.agents.base import collect_rollout as jcollect_rollout
from elegantrl_tpu.agents.ppo import make_ppo as jmake_ppo
from elegantrl_tpu.config import Config as JConfig
from elegantrl_tpu.envs.cartpole import make_cartpole as jmake_cartpole
from elegantrl_tpu.envs.pendulum import make_pendulum as jmake_pendulum
from elegantrl_tpu.ops.pallas_update import (_adam_parts, _with_adam_parts,
                                             make_ppo_fused_update as jmake_fused)
from elegantrl_tpu_torch.agents.base import Rollout
from elegantrl_tpu_torch.agents.ppo import make_ppo
from elegantrl_tpu_torch.config import Config
from elegantrl_tpu_torch.ops.fused_update import (a2c_actor_loss, actor_loss,
                                                  discrete_head_backward, logprob_entropy,
                                                  ppo_update, ppo_update_reference)
from elegantrl_tpu_torch.ops.nets import ppo_param_shapes, split_flat
from elegantrl_tpu_torch.utils.checkpoint import tree_leaves
from elegantrl_tpu_torch.utils.jax_params import ppo_state_from_numpy, ppo_state_to_numpy

torch.set_num_threads(1)
NET_DIMS = (16, 16)
H, N, B, U = 32, 16, 128, 2          # update_times = H * 8 / B = 2
HP = dict(ratio_clip=0.25, lambda_entropy=0.01, lr=6e-5, clip_grad=3.0)


def _jax_state(S, A, warm: bool, discrete=True, a2c=False):
    args = JConfig()
    args.net_dims = NET_DIMS
    s = jmake_ppo(NET_DIMS, S, A, args, discrete=discrete, a2c=a2c).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(S)
    s = s._replace(norm_avg=jnp.asarray(rng.uniform(-0.2, 0.2, S), jnp.float32),
                   norm_std=jnp.asarray(rng.uniform(0.8, 1.5, S), jnp.float32))
    if warm:   # a later step: count 7 and non-zero moments
        key = iter(jax.random.split(jax.random.PRNGKey(5), 64))

        def warm_opt(opt):
            _, mu, nu = _adam_parts(opt)
            mu = jax.tree.map(lambda x: 1e-3 * jax.random.normal(next(key), x.shape), mu)
            nu = jax.tree.map(lambda x: 1e-6 * jax.random.uniform(next(key), x.shape), nu)
            return _with_adam_parts(opt, jnp.asarray(7, jnp.int32), mu, nu)
        s = s._replace(act_opt=warm_opt(s.act_opt), cri_opt=warm_opt(s.cri_opt))
    return s


def _block(S, A, seed=0):
    rng = np.random.default_rng(seed)
    sb = rng.standard_normal((U, S, B)).astype(np.float32)
    index = rng.integers(0, A, (U, B))
    ab = np.moveaxis(np.eye(A, dtype=np.float32)[index], -1, 1).copy()       # (U, A, B)
    lp = (rng.standard_normal((U, B)) * 0.3 - np.log(A)).astype(np.float32)
    adv = rng.standard_normal((U, B)).astype(np.float32)
    rs = rng.standard_normal((U, B)).astype(np.float32)
    um = (rng.uniform(size=(U, B)) > 0.05).astype(np.float32)
    return sb, ab, lp, adv, rs, um


def _deltas(new, old):
    return [np.asarray(a) - np.asarray(b) for a, b in zip(tree_leaves(new), tree_leaves(old))]


@pytest.mark.parametrize('S,A,warm,single_sided', [(4, 2, False, False), (8, 9, True, False),
                                                   (4, 2, True, True)])
def test_discrete_plain_version_matches_pallas_kernel(S, A, warm, single_sided):
    s = _jax_state(S, A, warm)
    assert 'std_log' not in s.act
    block = _block(S, A, S + int(warm) + 2 * int(single_sided))
    fused = jmake_fused(S, A, B, U, single_sided=single_sided, discrete=True, interpret=True,
                        **HP)
    act, cri, act_opt, cri_opt, jm = fused(s.act, s.cri, s.act_opt, s.cri_opt,
                                           s.norm_avg, s.norm_std, *map(jnp.asarray, block))
    js_new = s._replace(act=act, cri=cri, act_opt=act_opt, cri_opt=cri_opt)

    st = ppo_state_from_numpy(jax.tree.map(np.asarray, s), 'cpu')
    assert st.act.std_log is None
    old = ppo_state_to_numpy(st)
    objs = ppo_update_reference(
        st.act_flat, st.cri_flat, st.act_opt.mu, st.act_opt.nu, st.cri_opt.mu,
        st.cri_opt.nu, st.act_opt.count, st.cri_opt.count, st.norm_avg, st.norm_std,
        *map(torch.from_numpy, block), net_dims=NET_DIMS, single_sided=single_sided,
        discrete=True, **HP)
    st = st._replace(act_opt=st.act_opt._replace(count=st.act_opt.count + U),
                     cri_opt=st.cri_opt._replace(count=st.cri_opt.count + U))
    new = ppo_state_to_numpy(st)
    jnew = jax.tree.map(np.asarray, js_new)
    jold = jax.tree.map(np.asarray, s)
    assert len(tree_leaves(new)) == len(jax.tree.leaves(jnew))
    # parameters: where a gradient is within rounding of Adam's eps (1e-8) the
    # first steps' g / (|g| + eps) is ill-conditioned, so allow 0.5% of the
    # largest possible update (lr per step) absolutely; moments and counts 1e-8
    for part, atol in (('act', 5e-3 * HP['lr'] * U), ('cri', 5e-3 * HP['lr'] * U),
                       ('act_opt', 1e-8), ('cri_opt', 1e-8)):
        for got, want in zip(_deltas(getattr(new, part), getattr(old, part)),
                             _deltas(getattr(jnew, part), getattr(jold, part))):
            np.testing.assert_allclose(got, want, rtol=5e-3, atol=atol)
    for k, key in enumerate(('obj_critic', 'obj_actor', 'obj_entropy')):
        np.testing.assert_allclose(float(objs[:, k].mean()), float(jm[key]),
                                   rtol=1e-4, atol=1e-5)


def test_discrete_wrapper_on_cpu_runs_the_plain_version():
    s = jax.tree.map(np.asarray, _jax_state(4, 2, True))
    block = [torch.from_numpy(b) for b in _block(4, 2, 5)]
    outs = []
    before = dict(ppo_update.launches_by_head), ppo_update.launches
    for fn in (ppo_update_reference, ppo_update):
        st = ppo_state_from_numpy(s, 'cpu')
        objs = fn(st.act_flat, st.cri_flat, st.act_opt.mu, st.act_opt.nu, st.cri_opt.mu,
                  st.cri_opt.nu, 7, 7, st.norm_avg, st.norm_std, *block,
                  net_dims=NET_DIMS, discrete=True, **HP)
        outs.append((objs, st.act_flat, st.cri_flat, st.act_opt.nu))
    assert (dict(ppo_update.launches_by_head), ppo_update.launches) == before
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_param_shapes_drop_std_log_when_discrete():
    cont, cri = ppo_param_shapes(4, NET_DIMS, 2)
    disc, cri_d = ppo_param_shapes(4, NET_DIMS, 2, discrete=True)
    assert cont[:-1] == disc and cont[-1] == (1, 2) and cri == cri_d
    # the default entropy weight follows the head, as in the JAX package
    for discrete, want in ((True, 0.01), (False, 0.001)):
        seen = {}
        args = Config()
        args.device, args.batch_size = 'cpu', 128   # a batch the fused update takes
        import elegantrl_tpu_torch.agents.ppo as ppo_mod
        orig = ppo_mod.make_ppo_fused_update
        ppo_mod.make_ppo_fused_update = lambda *a, **k: seen.update(k) or (lambda *x: (x[0], {}))
        try:
            agent = make_ppo(NET_DIMS, 4, 2, args, discrete=discrete)
            st = agent.init(0, 'cpu')
            acts = (torch.zeros((4, 3), dtype=torch.int32) if discrete else torch.zeros(4, 3, 2))
            ro = Rollout(states=torch.zeros(4, 3, 4), actions=acts,
                         logprobs=torch.zeros(4, 3), rewards=torch.ones(4, 3),
                         undones=torch.ones(4, 3), unmasks=torch.ones(4, 3))
            agent.update(st, ro, torch.zeros(3, 4), torch.Generator().manual_seed(0))
        finally:
            ppo_mod.make_ppo_fused_update = orig
        assert seen['lambda_entropy'] == want and seen['discrete'] == discrete


# ----------------------------------------------------- against the scan path

def _rollout_to_torch(jro):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return Rollout(states=t(jro.states), actions=t(jro.actions), logprobs=t(jro.logprobs),
                   rewards=t(jro.rewards), undones=t(jro.undones), unmasks=t(jro.unmasks),
                   extras={'values': t(jro.extras['values'])})


CASES = {   # name -> (env, S, A, discrete, a2c, batch, state_value_tau)
    'discrete_ppo': (jmake_cartpole, 4, 2, True, False, B, 0.1),
    'a2c': (jmake_pendulum, 3, 1, False, True, 8, 0.0),
    'discrete_a2c': (jmake_cartpole, 4, 2, True, True, 8, 0.0),
}


@pytest.fixture(scope='module', params=list(CASES))
def scan_setup(request):
    """One JAX scan-path update on a rollout collected by the JAX package,
    its minibatch ids, and the port's update on the same inputs."""
    jmake_env, S, A, discrete, a2c, batch, tau = CASES[request.param]
    updates = int(H * 8 / batch)
    jargs = JConfig()
    jargs.net_dims, jargs.batch_size, jargs.repeat_times = NET_DIMS, batch, 8.0
    jargs.use_pallas_update = False
    jargs.state_value_tau = tau
    jagent = jmake_ppo(NET_DIMS, S, A, jargs, discrete=discrete, a2c=a2c)
    s = _jax_state(S, A, False, discrete=discrete, a2c=a2c)
    env = jmake_env()
    env_state = jax.vmap(env.init)(jax.random.split(jax.random.PRNGKey(7), N))
    env_state = env_state._replace(t=(jnp.arange(N) * 23 % 200).astype(jnp.int32))
    jro, _, last_obs = jcollect_rollout(
        env, s, jagent.explore_action, jagent.env_action, env_state,
        jax.vmap(env.obs)(env_state), jax.random.PRNGKey(3), H, reward_scale=1.0,
        extras_fn=jagent.rollout_extras)
    k_upd = jax.random.PRNGKey(11)
    js_new, jm = jax.jit(jagent.update)(s, jro, last_obs, k_upd)
    keys = jax.random.split(k_upd, updates)      # as agents/ppo.py:update splits it
    high = H if a2c else H * N                   # time-slice ids, or flat (t, env) ids
    ids = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (batch,), 0, high))(keys))

    args = Config()
    args.device, args.net_dims, args.batch_size, args.repeat_times = 'cpu', NET_DIMS, batch, 8.0
    args.state_value_tau = tau
    agent = make_ppo(NET_DIMS, S, A, args, discrete=discrete, a2c=a2c)
    st = ppo_state_from_numpy(jax.tree.map(np.asarray, s), 'cpu')
    old = ppo_state_to_numpy(st)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    st_new, m = agent.update(st, _rollout_to_torch(jro), t(last_obs), None,
                             ids=torch.from_numpy(ids.copy()).long())
    return dict(jold=jax.tree.map(np.asarray, s), jnew=jax.tree.map(np.asarray, js_new),
                jm=jm, old=old, new=ppo_state_to_numpy(st_new), m=m, updates=updates,
                agent=agent, jagent=jagent, jro=jro)


def test_update_matches_scan_path_params(scan_setup):
    c = scan_setup
    for got, want in zip(_deltas(c['new'].act, c['old'].act) + _deltas(c['new'].cri, c['old'].cri),
                         _deltas(c['jnew'].act, c['jold'].act)
                         + _deltas(c['jnew'].cri, c['jold'].cri)):
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-8)


def test_update_matches_scan_path_adam_state(scan_setup):
    new, jnew = scan_setup['new'], scan_setup['jnew']
    for opt, jopt in ((new.act_opt, jnew.act_opt), (new.cri_opt, jnew.cri_opt)):
        assert int(opt[1][0].count) == int(_adam_parts(jopt)[0]) == scan_setup['updates']
        for got, want in zip(tree_leaves(opt[1][0].mu), tree_leaves(_adam_parts(jopt)[1])):
            np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-9)
        for got, want in zip(tree_leaves(opt[1][0].nu), tree_leaves(_adam_parts(jopt)[2])):
            np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-12)


def test_update_matches_scan_path_metrics_and_norm(scan_setup):
    m, jm = scan_setup['m'], scan_setup['jm']
    for k in ('obj_critic', 'obj_actor', 'obj_entropy'):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-5)
    new, jnew = scan_setup['new'], scan_setup['jnew']
    np.testing.assert_allclose(new.norm_avg, np.asarray(jnew.norm_avg), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(new.norm_std, np.asarray(jnew.norm_std), rtol=1e-5, atol=1e-6)


def test_agent_names_and_action_types(scan_setup):
    agent, jagent, jro = scan_setup['agent'], scan_setup['jagent'], scan_setup['jro']
    assert agent.name == jagent.name and agent.if_discrete == jagent.if_discrete
    st = agent.init(0, 'cpu')
    obs = torch.from_numpy(np.array(jro.states[0]))
    action, logprob = agent.explore_action(st, obs, torch.Generator().manual_seed(0))
    greedy = agent.greedy_action(st, obs)
    assert logprob.shape == (N,)
    if agent.if_discrete:
        assert action.dtype == greedy.dtype == torch.int32 and action.shape == greedy.shape == (N,)
        assert agent.env_action(action) is action
    else:
        assert action.shape == greedy.shape == (N, 1) and float(greedy.abs().max()) <= 1.0


# ----------------------------------------------------------------- gradients

def _tiny(discrete, seed=1):
    S, A, b = 3, 3, 6
    rng = np.random.default_rng(seed)
    act_shapes, _ = ppo_param_shapes(S, (4, 4), A, discrete)
    n_act = sum(int(np.prod(s)) for s in act_shapes)
    d = lambda *shape: torch.tensor(rng.standard_normal(shape))  # noqa: E731
    xn, adv = d(b, S), d(b)
    a = (torch.eye(A, dtype=torch.float64)[torch.tensor(rng.integers(0, A, b))] if discrete
         else d(b, A))
    um = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0, 1.0], dtype=torch.float64)
    act0 = (0.3 * d(n_act)).requires_grad_(True)
    return act_shapes, xn, a, adv, um, act0


@pytest.mark.parametrize('single_sided', [False, True])
def test_discrete_loss_gradients_gradcheck(single_sided):
    """Autograd on the plain discrete loss against finite differences in
    float64, with ratios kept away from the clip's kinks."""
    act_shapes, xn, a, adv, um, act0 = _tiny(True)
    with torch.no_grad():
        lp_new, _ = logprob_entropy(split_flat(act0, act_shapes), xn, a, True)
        # ratios exp(lp_new - lp) of 0.5, 0.9, 1.1, 1.6, 0.95, 1.05
        lp = lp_new - torch.log(torch.tensor([0.5, 0.9, 1.1, 1.6, 0.95, 1.05],
                                             dtype=torch.float64))
    assert torch.autograd.gradcheck(
        lambda p: actor_loss(split_flat(p, act_shapes), xn, a, lp, adv, um,
                             0.25, 0.01, single_sided, True)[0], (act0,))


@pytest.mark.parametrize('discrete', [False, True])
def test_a2c_loss_gradients_gradcheck(discrete):
    act_shapes, xn, a, adv, um, act0 = _tiny(discrete, seed=2)
    assert torch.autograd.gradcheck(
        lambda p: a2c_actor_loss(split_flat(p, act_shapes), xn, a, adv, um, 0.01,
                                 discrete)[0], (act0,))
    # the entropy enters as a bonus: loss = -(surrogate + lambda * entropy)
    leaves = split_flat(act0.detach(), act_shapes)
    lo = a2c_actor_loss(leaves, xn, a, adv, um, 0.0, discrete)
    hi = a2c_actor_loss(leaves, xn, a, adv, um, 0.5, discrete)
    assert float(hi[2]) == float(lo[2]) and float(hi[0] - lo[0]) == pytest.approx(
        -0.5 * float(lo[2]))


def test_hand_written_discrete_backward_matches_autograd():
    """``d loss / d logits`` by the formulas that ``csrc/ppo_update.cu``
    applies, against autograd through ``log_softmax`` on the plain version,
    for arbitrary upstream gradients; rows that are not one-hot included."""
    rng = np.random.default_rng(3)
    logits = torch.tensor(rng.standard_normal((7, 5)) * 2.0, requires_grad=True)
    onehot = torch.eye(5, dtype=torch.float64)[torch.tensor(rng.integers(0, 5, 7))]
    onehot[0] = torch.tensor([0.5, 0.5, 0.0, 0.0, 0.0], dtype=torch.float64)
    g_lp, g_ent = torch.tensor(rng.standard_normal(7)), torch.tensor(rng.standard_normal(7))
    logp = torch.log_softmax(logits, dim=-1)
    new_lp = torch.sum(logp * onehot, dim=-1)
    entropy = -torch.sum(torch.exp(logp) * logp, dim=-1)
    want, = torch.autograd.grad(torch.sum(g_lp * new_lp + g_ent * entropy), logits)
    got = discrete_head_backward(logits.detach(), onehot, g_lp, g_ent)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10, atol=1e-12)
