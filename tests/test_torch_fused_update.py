"""Parity of the port's fused-update plain version
(``elegantrl_tpu_torch/ops/fused_update.py:ppo_update_reference``) with the
JAX package's Pallas update kernel in interpret mode
(``make_ppo_fused_update(..., interpret=True)``) on the same ``(U, ., B)``
block, params and Adam moments; and of the port's PPO ``update`` with the
JAX scan-path ``update`` (``use_pallas_update=False``) on the same rollout
and the same minibatch ids.

Tolerances, as the JAX package's own update tests: parameter UPDATES
(new - old) to rtol 5e-3, metrics to rtol 1e-4 — parameters barely move in
one step, so comparing them directly would hide any error in the step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu.agents.base import collect_rollout as jcollect_rollout
from elegantrl_tpu.agents.ppo import make_ppo as jmake_ppo
from elegantrl_tpu.config import Config as JConfig
from elegantrl_tpu.envs.pendulum import make_pendulum as jmake_pendulum
from elegantrl_tpu.ops.pallas_update import (_adam_parts, _with_adam_parts,
                                             make_ppo_fused_update as jmake_fused)
from elegantrl_tpu_torch.agents.base import Rollout
from elegantrl_tpu_torch.agents.ppo import make_ppo
from elegantrl_tpu_torch.config import Config
from elegantrl_tpu_torch.ops.fused_update import (actor_loss, critic_loss, ppo_update,
                                                  ppo_update_reference)
from elegantrl_tpu_torch.ops.nets import ppo_param_shapes, split_flat
from elegantrl_tpu_torch.utils.checkpoint import tree_leaves
from elegantrl_tpu_torch.utils.jax_params import ppo_state_from_numpy, ppo_state_to_numpy

torch.set_num_threads(1)
NET_DIMS = (16, 16)
H, N, B, U = 32, 16, 128, 2          # update_times = H * 8 / B = 2
HP = dict(ratio_clip=0.25, lambda_entropy=0.001, lr=6e-5, clip_grad=3.0)


def _jax_state(warm: bool):
    args = JConfig()
    args.net_dims = NET_DIMS
    s = jmake_ppo(NET_DIMS, 3, 1, args).init(jax.random.PRNGKey(0))
    s = s._replace(norm_avg=jnp.array([0.1, -0.2, 0.3]), norm_std=jnp.array([0.9, 1.1, 2.0]))
    if warm:   # a later step: count 7 and non-zero moments
        key = iter(jax.random.split(jax.random.PRNGKey(5), 64))

        def warm_opt(opt):
            _, mu, nu = _adam_parts(opt)
            mu = jax.tree.map(lambda x: 1e-3 * jax.random.normal(next(key), x.shape), mu)
            nu = jax.tree.map(lambda x: 1e-6 * jax.random.uniform(next(key), x.shape), nu)
            return _with_adam_parts(opt, jnp.asarray(7, jnp.int32), mu, nu)
        s = s._replace(act_opt=warm_opt(s.act_opt), cri_opt=warm_opt(s.cri_opt))
    return s


def _block(seed=0):
    rng = np.random.default_rng(seed)
    sb = rng.standard_normal((U, 3, B)).astype(np.float32)
    ab = rng.standard_normal((U, 1, B)).astype(np.float32)
    lp = (rng.standard_normal((U, B)) * 0.3 - 1.2).astype(np.float32)
    adv = rng.standard_normal((U, B)).astype(np.float32)
    rs = rng.standard_normal((U, B)).astype(np.float32)
    um = (rng.uniform(size=(U, B)) > 0.05).astype(np.float32)
    return sb, ab, lp, adv, rs, um


def _deltas(new, old):
    return [np.asarray(a) - np.asarray(b) for a, b in zip(tree_leaves(new), tree_leaves(old))]


@pytest.mark.parametrize('warm', [False, True])
@pytest.mark.parametrize('single_sided', [False, True])
def test_plain_version_matches_pallas_kernel(warm, single_sided):
    s = _jax_state(warm)
    block = _block(int(warm) + 2 * int(single_sided))
    fused = jmake_fused(3, 1, B, U, single_sided=single_sided, interpret=True, **HP)
    act, cri, act_opt, cri_opt, jm = fused(s.act, s.cri, s.act_opt, s.cri_opt,
                                           s.norm_avg, s.norm_std, *map(jnp.asarray, block))
    js_new = s._replace(act=act, cri=cri, act_opt=act_opt, cri_opt=cri_opt)

    st = ppo_state_from_numpy(jax.tree.map(np.asarray, s), 'cpu')
    old = ppo_state_to_numpy(st)
    objs = ppo_update_reference(
        st.act_flat, st.cri_flat, st.act_opt.mu, st.act_opt.nu, st.cri_opt.mu,
        st.cri_opt.nu, st.act_opt.count, st.cri_opt.count, st.norm_avg, st.norm_std,
        *map(torch.from_numpy, block), net_dims=NET_DIMS, single_sided=single_sided, **HP)
    st = st._replace(act_opt=st.act_opt._replace(count=st.act_opt.count + U),
                     cri_opt=st.cri_opt._replace(count=st.cri_opt.count + U))
    new = ppo_state_to_numpy(st)
    jnew = jax.tree.map(np.asarray, js_new)
    jold = jax.tree.map(np.asarray, s)
    for got, want in zip(_deltas(new, old), _deltas(jnew, jold)):
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-8)
    for k, key in enumerate(('obj_critic', 'obj_actor', 'obj_entropy')):
        np.testing.assert_allclose(float(objs[:, k].mean()), float(jm[key]),
                                   rtol=1e-4, atol=1e-6)
    assert int(_adam_parts(js_new.act_opt)[0]) == st.act_opt.count


def test_wrapper_on_cpu_runs_the_plain_version():
    s = jax.tree.map(np.asarray, _jax_state(True))
    block = [torch.from_numpy(b) for b in _block(5)]
    outs = []
    before = ppo_update.launches
    for fn in (ppo_update_reference, ppo_update):
        st = ppo_state_from_numpy(s, 'cpu')
        objs = fn(st.act_flat, st.cri_flat, st.act_opt.mu, st.act_opt.nu, st.cri_opt.mu,
                  st.cri_opt.nu, 7, 7, st.norm_avg, st.norm_std, *block,
                  net_dims=NET_DIMS, **HP)
        outs.append((objs, st.act_flat, st.cri_flat, st.act_opt.nu))
    assert ppo_update.launches == before
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.fixture(scope='module', params=[0.0, 0.1], ids=['tau0', 'tau0.1'])
def scan_setup(request):
    """One JAX scan-path update on a collected rollout, its minibatch ids,
    and the port's update on the same inputs; with and without the running
    state normalisation (``state_value_tau``)."""
    jargs = JConfig()
    jargs.net_dims, jargs.batch_size, jargs.repeat_times = NET_DIMS, B, 8.0
    jargs.use_pallas_update = False
    jargs.state_value_tau = request.param
    jagent = jmake_ppo(NET_DIMS, 3, 1, jargs)
    s = _jax_state(False)
    env = jmake_pendulum()
    env_state = jax.vmap(env.init)(jax.random.split(jax.random.PRNGKey(7), N))
    env_state = env_state._replace(t=(jnp.arange(N) * 23 % 200).astype(jnp.int32))
    jro, _, last_obs = jcollect_rollout(
        env, s, jagent.explore_action, jagent.env_action, env_state,
        jax.vmap(env.obs)(env_state), jax.random.PRNGKey(3), H, reward_scale=1.0,
        extras_fn=jagent.rollout_extras)
    k_upd = jax.random.PRNGKey(11)
    js_new, jm = jax.jit(jagent.update)(s, jro, last_obs, k_upd)
    keys = jax.random.split(k_upd, U)          # as agents/ppo.py:update splits it
    ids = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (B,), 0, H * N))(keys))

    args = Config()
    args.device, args.net_dims, args.batch_size, args.repeat_times = 'cpu', NET_DIMS, B, 8.0
    args.state_value_tau = request.param
    agent = make_ppo(NET_DIMS, 3, 1, args)
    st = ppo_state_from_numpy(jax.tree.map(np.asarray, s), 'cpu')
    old = ppo_state_to_numpy(st)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    ro = Rollout(states=t(jro.states), actions=t(jro.actions), logprobs=t(jro.logprobs),
                 rewards=t(jro.rewards), undones=t(jro.undones), unmasks=t(jro.unmasks),
                 extras={'values': t(jro.extras['values'])})
    st_new, m = agent.update(st, ro, t(last_obs), None, ids=torch.from_numpy(ids.copy()).long())
    return (jax.tree.map(np.asarray, s), jax.tree.map(np.asarray, js_new), jm,
            old, ppo_state_to_numpy(st_new), m)


def test_update_matches_scan_path_params(scan_setup):
    jold, jnew, _, old, new, _ = scan_setup
    for got, want in zip(_deltas(new.act, old.act) + _deltas(new.cri, old.cri),
                         _deltas(jnew.act, jold.act) + _deltas(jnew.cri, jold.cri)):
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-8)


def test_update_matches_scan_path_adam_state(scan_setup):
    _, jnew, _, _, new, _ = scan_setup
    for opt, jopt in ((new.act_opt, jnew.act_opt), (new.cri_opt, jnew.cri_opt)):
        assert int(opt[1][0].count) == int(_adam_parts(jopt)[0]) == U
        for got, want in zip(tree_leaves(opt[1][0].mu), tree_leaves(_adam_parts(jopt)[1])):
            np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-9)
        for got, want in zip(tree_leaves(opt[1][0].nu), tree_leaves(_adam_parts(jopt)[2])):
            np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-12)


def test_update_matches_scan_path_metrics(scan_setup):
    _, _, jm, _, _, m = scan_setup
    for k in ('obj_critic', 'obj_actor', 'obj_entropy'):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-6)


def test_update_matches_scan_path_state_norm(scan_setup):
    _, jnew, _, _, new, _ = scan_setup
    np.testing.assert_allclose(new.norm_avg, np.asarray(jnew.norm_avg), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(new.norm_std, np.asarray(jnew.norm_std), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('single_sided', [False, True])
def test_loss_gradients_gradcheck(single_sided):
    """The plain version's losses have the gradients their closed forms
    give: autograd against finite differences in float64 at a tiny size,
    with ratios kept away from the clip's kinks."""
    S, A, b = 3, 1, 6
    rng = np.random.default_rng(1)
    act_shapes, cri_shapes = ppo_param_shapes(S, (4, 4), A)
    n_act = sum(int(np.prod(s)) for s in act_shapes)
    n_cri = sum(int(np.prod(s)) for s in cri_shapes)
    d = lambda *shape: torch.tensor(rng.standard_normal(shape))  # noqa: E731
    xn, a, adv, rs = d(b, S), d(b, A), d(b), d(b)
    um = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0, 1.0], dtype=torch.float64)
    act0 = (0.3 * d(n_act)).requires_grad_(True)
    cri0 = (0.3 * d(n_cri)).requires_grad_(True)
    with torch.no_grad():
        leaves = split_flat(act0, act_shapes)
        from elegantrl_tpu_torch.ops.nets import mlp_apply_leaves
        mean = mlp_apply_leaves(leaves[:-1], xn)
        lp_new = (-0.5 * ((a - mean) / torch.exp(leaves[-1])) ** 2 - leaves[-1]
                  - 0.5 * np.log(2 * np.pi)).sum(-1)
        # ratios exp(lp_new - lp) of 0.5, 0.9, 1.1, 1.6, 0.95, 1.05
        lp = lp_new - torch.log(torch.tensor([0.5, 0.9, 1.1, 1.6, 0.95, 1.05],
                                             dtype=torch.float64))
    assert torch.autograd.gradcheck(
        lambda p: actor_loss(split_flat(p, act_shapes), xn, a, lp, adv, um,
                              0.25, 0.01, single_sided)[0], (act0,))
    assert torch.autograd.gradcheck(
        lambda p: critic_loss(split_flat(p, cri_shapes), xn, rs, um), (cri0,))
