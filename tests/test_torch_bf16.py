"""bfloat16 compute and storage in the port against the JAX package, on the
CPU (the plain versions; the kernels' bf16 variants are held against these
on the card by ``chip_smoke.py``).

- ``ops/nets.py:mlp_apply_leaves(dtype=bf16)`` against
  ``elegantrl_tpu.ops.nets.mlp_apply(dtype=jnp.bfloat16)``, forward and
  gradient;
- the on-policy rollout's plain version (K1 on Pendulum, K3 on CartPole)
  and the off-policy one (K6 ddpg, dqn, dqn_enc, dqn_duel; K6' sac, modsac)
  against the JAX kernels in interpret mode with ``compute_dtype='bfloat16'``,
  with and without ``store_dtype=bfloat16``, on the same weights and
  injected noise: one teacher-forced step, then a short horizon;
- ``collect_rollout``'s quantise-before-act;
- the bf16 PPO update (autograd) against the JAX scan update;
- the bf16 replay ring and its npz, in both directions;
- a whole ``ppo_pendulum_bf16``-shaped round against the JAX round;
- the kernel selection under bf16 (no K2, no K11b; K4 raises on a card).

Tolerances.  Both packages sum float32 products of bf16 operands, in
another order, so two sums can differ in their last float32 bit; where
such a sum lies within that bit of a bf16 rounding boundary, the next
layer's operand differs by one bf16 step (2^-8 relative).  So a forward is
held to 1e-5 on at least 99% of its entries and to 2e-2 relative (one bf16
step through a layer) on all; a gradient, whose cotangents are rounded to
bf16 too, the same.  Over a horizon, where the dynamics carry those
differences: 2e-2.  Discrete actions, flags and step counters exactly.
Parameter updates: rtol 2e-2 and atol 1e-6 (Adam's step of a bf16-rounded
gradient; 1e-6 is under 2% of the 6e-5 learning rate).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu.agents import AgentPPO as JAgentPPO
from elegantrl_tpu.agents.base import collect_rollout as jcollect_rollout
from elegantrl_tpu.agents.ddpg_td3 import _make as jmake_ddpg_td3
from elegantrl_tpu.agents.dqn import make_dqn as jmake_dqn
from elegantrl_tpu.agents.ppo import make_ppo as jmake_ppo
from elegantrl_tpu.agents.sac import make_sac as jmake_sac
from elegantrl_tpu.config import Config as JConfig
from elegantrl_tpu.envs import PendulumEnv as JPendulumEnv
from elegantrl_tpu.envs.cartpole import make_cartpole as jmake_cartpole
from elegantrl_tpu.envs.hopper import make_hopper as jmake_hopper
from elegantrl_tpu.envs.pendulum import make_pendulum as jmake_pendulum
from elegantrl_tpu.ops import pallas_rollout as jpr
from elegantrl_tpu.ops.nets import mlp_apply as jmlp_apply, mlp_init as jmlp_init
from elegantrl_tpu.train.replay_buffer import ReplayBuffer as JReplayBuffer
from elegantrl_tpu.train.runner import build_training as jbuild_training
from elegantrl_tpu_torch import Config, build_training
from elegantrl_tpu_torch.agents import AgentDDPG, AgentPPO
from elegantrl_tpu_torch.agents.base import Rollout, collect_rollout
from elegantrl_tpu_torch.agents.ppo import make_ppo, norm_state
from elegantrl_tpu_torch.envs import (CartPoleState, HopperState, PendulumEnv, PendulumState,
                                      StockTradingVecEnv)
from elegantrl_tpu_torch.envs.base import vec_reset
from elegantrl_tpu_torch.ops import dists
from elegantrl_tpu_torch.ops import fused_rollout as fr
from elegantrl_tpu_torch.ops.nets import mlp_apply_leaves, split_flat
from elegantrl_tpu_torch.train.replay_buffer import ReplayBuffer
from elegantrl_tpu_torch.utils.checkpoint import tree_leaves
from elegantrl_tpu_torch.utils.jax_params import (ddpg_state_from_numpy, dqn_state_from_numpy,
                                                  env_state_from_numpy, ppo_state_from_numpy,
                                                  ppo_state_to_numpy, sac_state_from_numpy)

torch.set_num_threads(1)
BF = torch.bfloat16
NET_DIMS = (16, 16)
H, N = 8, 16
REWARD_SCALE = 0.5
ENV_ARGS = {'env_name': 'Pendulum-v1', 'num_envs': N, 'max_step': 200, 'state_dim': 3,
            'action_dim': 1, 'if_discrete': False}


def _close(got, want, what=''):
    """The bf16 tolerance of the module's docstring: 99% of the entries
    within 1e-5, every entry within 2e-2 relative (and 2e-3 absolute)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    near = np.abs(got - want) <= 1e-5 + 1e-5 * np.abs(want)
    assert near.mean() >= 0.99, (what, near.mean())
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-3, err_msg=what)


# ------------------------------------------------------------------- nets

def test_mlp_apply_bf16_forward_and_gradient_match_jax():
    rng = np.random.default_rng(0)
    params = jmlp_init(jax.random.PRNGKey(0), (5, 48, 40, 3), out_std=0.5)
    x = rng.standard_normal((256, 5)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jnp.sin(jmlp_apply(p, xx, dtype=jnp.bfloat16)))

    jout = np.asarray(jax.jit(lambda p, xx: jmlp_apply(p, xx, dtype=jnp.bfloat16))(params, x))
    jgrad = jax.jit(jax.grad(jloss))(params, x)
    leaves = []
    for w, b in params:   # the port keeps W as (out, in)
        leaves += [torch.tensor(np.asarray(w).T.copy(), requires_grad=True),
                   torch.tensor(np.asarray(b), requires_grad=True)]
    out = mlp_apply_leaves(leaves, torch.from_numpy(x), BF)
    assert out.dtype == torch.float32
    _close(out.detach().numpy(), jout, 'forward')
    # the cast is live: the f32 forward differs
    assert not np.allclose(mlp_apply_leaves([t.detach() for t in leaves],
                                            torch.from_numpy(x)).numpy(), jout, atol=1e-5)
    torch.sum(torch.sin(out)).backward()
    for i, (gw, gb) in enumerate(jgrad):
        _close(leaves[2 * i].grad.numpy().T, np.asarray(gw), f'dW{i}')
        _close(leaves[2 * i + 1].grad.numpy(), np.asarray(gb), f'db{i}')


# ------------------------------------------------ on-policy rollout (K1, K3)

def _stagger(name, s):
    """Move some lanes next to a terminal or a truncation."""
    lanes = jnp.arange(N)
    if name == 'cartpole':
        return s._replace(x=jnp.where(lanes < 3, 2.35, s.x), x_dot=jnp.where(lanes < 3, 1.5, s.x_dot),
                          t=jnp.where(lanes >= 13, 497, lanes * 31).astype(jnp.int32))
    if name == 'hopper':
        return s._replace(z=jnp.where(lanes < 3, 0.27, s.z), vz=jnp.where(lanes < 3, -3.0, s.vz),
                          t=jnp.where(lanes >= 13, 996, lanes * 61).astype(jnp.int32))
    return s._replace(t=jnp.where(lanes >= 13, 197, lanes * 11).astype(jnp.int32))


ONPOLICY = {'pendulum': (jmake_pendulum, jpr.PENDULUM_BODY, fr.PENDULUM_BODY, PendulumState),
            'cartpole': (jmake_cartpole, jpr.CARTPOLE_BODY, fr.CARTPOLE_BODY, CartPoleState)}


def _onpolicy_noise(body, key):
    n_env = body.n_step + body.n_reset
    if body.discrete:
        return jax.random.uniform(key, (H, body.action_dim + n_env, N), jnp.float32)
    kz, ku = jax.random.split(key)
    return jnp.concatenate([jax.random.normal(kz, (H, body.action_dim, N), jnp.float32),
                            jax.random.uniform(ku, (H, n_env, N), jnp.float32)], axis=1)


@pytest.fixture(scope='module', params=[('pendulum', False), ('pendulum', True),
                                        ('cartpole', False), ('cartpole', True)],
                ids=lambda p: f'{p[0]}-store_{"bf16" if p[1] else "f32"}')
def onpolicy(request):
    name, store = request.param
    make_env, jbody, body, state_class = ONPOLICY[name]
    S, A = body.state_dim, body.action_dim
    js = jmake_ppo(NET_DIMS, S, A, JConfig(), discrete=body.discrete).init(
        jax.random.PRNGKey(len(name)))
    js = js._replace(norm_avg=jnp.linspace(-0.2, 0.3, S), norm_std=jnp.linspace(0.8, 1.6, S))
    env = make_env()
    env_state = _stagger(name, jax.vmap(env.init)(jax.random.split(jax.random.PRNGKey(7), N)))
    key = jax.random.PRNGKey(3)
    fast = jpr.make_fused_rollout(jbody, NET_DIMS, H, N, REWARD_SCALE, discrete=body.discrete,
                                  store_dtype=jnp.bfloat16 if store else None, block=8,
                                  interpret=True, compute_dtype='bfloat16')
    jro, jenv2, _ = fast(js, env_state, jax.vmap(env.obs)(env_state), key)
    st = ppo_state_from_numpy(jax.tree.map(np.asarray, js), 'cpu')
    f0, i0 = body.pack(env_state_from_numpy(state_class, jax.tree.map(np.asarray, env_state),
                                            'cpu'))
    noise = torch.tensor(np.asarray(_onpolicy_noise(body, key)))
    out = fr.rollout(st.act_flat, st.cri_flat, st.norm_avg, st.norm_std, f0, i0,
                     net_dims=NET_DIMS, horizon_len=H, reward_scale=REWARD_SCALE, noise=noise,
                     body=body, compute_dtype=BF, store_dtype=BF if store else None)
    return dict(jro=jro, jf=np.asarray(jbody.pack(jenv2)[0]), st=st, out=out, body=body,
                store=store)


def test_onpolicy_teacher_forced_step(onpolicy):
    """The port's bf16 nets and head on the JAX rollout's stored states and
    actions give the JAX rollout's values and logprobs."""
    jro, st, body = onpolicy['jro'], onpolicy['st'], onpolicy['body']
    states = torch.from_numpy(np.moveaxis(np.asarray(jro.states, np.float32), 1, 2).copy())
    S, A = body.state_dim, body.action_dim
    act = split_flat(st.act_flat, fr.ppo_param_shapes(S, NET_DIMS, A, body.discrete)[0])
    cri = split_flat(st.cri_flat, fr.ppo_param_shapes(S, NET_DIMS, A, body.discrete)[1])
    x = norm_state(states, st.norm_avg, st.norm_std)
    v = mlp_apply_leaves(cri, x, BF)[..., 0]
    if body.discrete:
        logits = mlp_apply_leaves(act, x, BF)
        a = torch.from_numpy(np.asarray(jro.actions)).long()
        lp = torch.gather(torch.log_softmax(logits, -1), -1, a[..., None])[..., 0]
    else:
        mean = mlp_apply_leaves(act[:-1], x, BF)
        a = torch.from_numpy(np.moveaxis(np.asarray(jro.actions), 1, 2).copy())
        lp = dists.normal_logprob(a, mean, torch.exp(act[-1])).sum(-1)
    _close(v.numpy(), np.asarray(jro.extras['values']), 'values')
    _close(lp.numpy(), np.asarray(jro.logprobs), 'logprobs')


def test_onpolicy_horizon(onpolicy):
    jro, out, store = onpolicy['jro'], onpolicy['out'], onpolicy['store']
    assert out.states.dtype == (BF if store else torch.float32)
    assert np.asarray(jro.states).dtype == (jnp.bfloat16 if store else np.float32)
    np.testing.assert_allclose(out.states.float().numpy(), np.asarray(jro.states, np.float32),
                               rtol=2e-2, atol=2e-2)
    if onpolicy['body'].discrete:
        np.testing.assert_array_equal(out.actions.numpy(), np.asarray(jro.actions))
    else:
        np.testing.assert_allclose(out.actions.numpy(), np.asarray(jro.actions), rtol=2e-2,
                                   atol=2e-2)
    for f, jf in (('logprobs', jro.logprobs), ('rewards', jro.rewards),
                  ('values', jro.extras['values'])):
        np.testing.assert_allclose(getattr(out, f).numpy(), np.asarray(jf), rtol=2e-2,
                                   atol=2e-2, err_msg=f)
    np.testing.assert_array_equal(1.0 - out.terminals.numpy(), np.asarray(jro.undones))
    np.testing.assert_array_equal(1.0 - out.truncates.numpy(), np.asarray(jro.unmasks))
    np.testing.assert_allclose(out.env_f.numpy(), onpolicy['jf'], rtol=2e-2, atol=2e-2)


def test_onpolicy_quantises_before_acting(onpolicy):
    """The stored state is the one the policy acted on (under bf16 storage
    the rounded obs): the stored states' values are the rollout's values."""
    out, st, body = onpolicy['out'], onpolicy['st'], onpolicy['body']
    assert out.states.dtype == (BF if onpolicy['store'] else torch.float32)
    cri = split_flat(st.cri_flat, fr.ppo_param_shapes(body.state_dim, NET_DIMS,
                                                      body.action_dim, body.discrete)[1])
    x = norm_state(out.states.transpose(1, 2).float(), st.norm_avg, st.norm_std)
    torch.testing.assert_close(mlp_apply_leaves(cri, x, BF)[..., 0], out.values,
                               rtol=0, atol=1e-6)


# ---------------------------------------------- off-policy rollout (K6, K6')

OFFPOLICY = {
    'ddpg_pendulum': ('pendulum', jpr.PENDULUM_BODY, fr.PENDULUM_BODY, PendulumState, 'ddpg',
                      'ddpg'),
    'sac_hopper': ('hopper', jpr.HOPPER_BODY, fr.HOPPER_BODY, HopperState, 'sac', 'sac'),
    'modsac_pendulum': ('pendulum', jpr.PENDULUM_BODY, fr.PENDULUM_BODY, PendulumState,
                        'modsac', 'modsac'),
    'dqn_cartpole': ('cartpole', jpr.CARTPOLE_BODY, fr.CARTPOLE_BODY, CartPoleState, 'dqn',
                     (False, False)),
    'doubledqn_cartpole': ('cartpole', jpr.CARTPOLE_BODY, fr.CARTPOLE_BODY, CartPoleState,
                           'dqn_enc', (True, False)),
    'duelingdqn_cartpole': ('cartpole', jpr.CARTPOLE_BODY, fr.CARTPOLE_BODY, CartPoleState,
                            'dqn_duel', (False, True)),
}
ENVS = {'pendulum': jmake_pendulum, 'hopper': jmake_hopper, 'cartpole': jmake_cartpole}


def _std_clip(head):
    return (-20.0, 2.0) if head == 'modsac' else (-16.0, 2.0)


def _offpolicy_agent(body, kind, seed):
    args, S, A = JConfig(), body.state_dim, body.action_dim
    key = jax.random.PRNGKey(seed)
    if kind == 'ddpg':
        s = jmake_ddpg_td3(NET_DIMS, S, A, args, None, td3=False).init(key)
        return s, ddpg_state_from_numpy(jax.tree.map(np.asarray, s), 'cpu').act
    if kind in ('sac', 'modsac'):
        s = jmake_sac(NET_DIMS, S, A, args, None, modsac=kind == 'modsac').init(key)
        return s, sac_state_from_numpy(jax.tree.map(np.asarray, s), 'cpu', kind == 'modsac').act
    twin, duel = kind
    s = jmake_dqn(NET_DIMS, S, A, args, twin=twin, duel=duel).init(key)
    return s, dqn_state_from_numpy(jax.tree.map(np.asarray, s), 'cpu', twin, duel).q


@pytest.fixture(scope='module', params=[(c, s) for c in OFFPOLICY for s in (False, True)
                                        if s == (c in ('ddpg_pendulum', 'sac_hopper',
                                                       'dqn_cartpole', 'duelingdqn_cartpole'))
                                        or c in ('ddpg_pendulum', 'dqn_cartpole')],
                ids=lambda p: f'{p[0]}-store_{"bf16" if p[1] else "f32"}')
def offpolicy(request):
    case, store = request.param
    env_name, jbody, body, state_class, head, kind = OFFPOLICY[case]
    js, flat = _offpolicy_agent(jbody, kind, seed=len(case))
    env = ENVS[env_name]()
    env_state = _stagger(env_name, jax.vmap(env.init)(jax.random.split(jax.random.PRNGKey(9),
                                                                         N)))
    cfg = {'noise_std': 0.1, 'explore_rate': 0.25, 'std_clip': _std_clip(head)}
    fast = jpr.make_fused_offpolicy_rollout(
        jbody, NET_DIMS, H, N, REWARD_SCALE, head=head, head_cfg=cfg,
        store_dtype=jnp.bfloat16 if store else None, block=8, interpret=True,
        compute_dtype='bfloat16')
    key = jax.random.PRNGKey(3)
    jro, jenv2, _ = fast(js, env_state, jax.vmap(env.obs)(env_state), key)
    n_env = body.n_step + body.n_reset
    if head in fr.CONTINUOUS_HEADS:
        kz, ku = jax.random.split(key)
        noise = jnp.concatenate([jax.random.normal(kz, (H, body.action_dim, N), jnp.float32),
                                 jax.random.uniform(ku, (H, n_env, N), jnp.float32)], axis=1)
    else:
        noise = jax.random.uniform(key, (H, 2 + n_env, N), jnp.float32)
    f0, i0 = body.pack(env_state_from_numpy(state_class, jax.tree.map(np.asarray, env_state),
                                            'cpu'))
    got = fr.offpolicy_rollout(flat, f0, i0, body=body, head=head, net_dims=NET_DIMS,
                               horizon_len=H, reward_scale=REWARD_SCALE, noise_std=0.1,
                               explore_rate=0.25, std_clip=_std_clip(head),
                               noise=torch.tensor(np.asarray(noise)), compute_dtype=BF,
                               store_dtype=BF if store else None)
    return dict(jro=jro, jf=np.asarray(jbody.pack(jenv2)[0]), got=got, head=head,
                store=store, flat=flat, body=body, noise=noise)


def test_offpolicy_teacher_forced_step(offpolicy):
    """The first step's action from the same obs and noise: continuous
    actions to the bf16 tolerance, discrete ones exactly."""
    jro, got, head = offpolicy['jro'], offpolicy['got'], offpolicy['head']
    ja = np.asarray(jro.actions[0], np.float32)
    if head in fr.CONTINUOUS_HEADS:
        _close(got.actions[0].float().numpy(), ja, 'step-0 actions')
    else:
        np.testing.assert_array_equal(got.actions[0].numpy(), ja)
    np.testing.assert_allclose(got.states[0].float().numpy(),
                               np.asarray(jro.states[0], np.float32), rtol=0, atol=1e-6)


def test_offpolicy_horizon(offpolicy):
    jro, got, head, store = (offpolicy[k] for k in ('jro', 'got', 'head', 'store'))
    assert got.states.dtype == (BF if store else torch.float32)
    if head in fr.CONTINUOUS_HEADS:
        assert got.actions.dtype == (BF if store else torch.float32)
        np.testing.assert_allclose(got.actions.float().numpy(),
                                   np.asarray(jro.actions, np.float32), rtol=2e-2, atol=2e-2)
    else:
        np.testing.assert_array_equal(got.actions.numpy(), np.asarray(jro.actions))
    np.testing.assert_allclose(got.states.float().numpy(), np.asarray(jro.states, np.float32),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.rewards.numpy(), np.asarray(jro.rewards), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_array_equal(1.0 - got.terminals.numpy(), np.asarray(jro.undones))
    np.testing.assert_array_equal(1.0 - got.truncates.numpy(), np.asarray(jro.unmasks))
    np.testing.assert_allclose(got.env_f.numpy(), offpolicy['jf'], rtol=2e-2, atol=2e-2)


# --------------------------------------------------------- collect_rollout

def test_collect_rollout_quantises_before_acting():
    """``store_dtype=bf16``: PPO stores bf16 states and f32 raw actions,
    and re-evaluating the stored states reproduces the stored logprobs
    (the ratio is 1 on fresh data); DDPG, which keeps no logprob, stores its
    actions in bf16 too; as the JAX package's collect_rollout."""
    args = Config(AgentPPO, PendulumEnv, dict(ENV_ARGS))
    args.device, args.net_dims, args.compute_dtype = 'cpu', NET_DIMS, 'bfloat16'
    agent = make_ppo(NET_DIMS, 3, 1, args)
    st = agent.init(0, 'cpu')
    env = PendulumEnv(num_envs=N, device='cpu')._def
    gen = torch.Generator().manual_seed(1)
    env_state, obs = vec_reset(env, gen, N, 'cpu')
    ro, _, _ = collect_rollout(env, st, agent.explore_action, agent.env_action, env_state, obs,
                               gen, H, 1.0, extras_fn=agent.rollout_extras, store_dtype=BF)
    assert ro.states.dtype == BF and ro.actions.dtype == torch.float32
    out = mlp_apply_leaves(st.act.mlp.leaves(),
                           norm_state(ro.states.float(), st.norm_avg, st.norm_std), BF)
    lp = dists.normal_logprob(ro.actions, out, torch.exp(st.act.std_log)).sum(-1)
    torch.testing.assert_close(lp, ro.logprobs, rtol=0, atol=1e-5)
    torch.testing.assert_close(agent.rollout_extras(st, ro.states.float())['values'],
                               ro.extras['values'], rtol=0, atol=0)
    # the JAX package's rollout under the same contract, teacher-forced
    jargs = JConfig()
    jargs.net_dims, jargs.compute_dtype = NET_DIMS, 'bfloat16'
    jagent = jmake_ppo(NET_DIMS, 3, 1, jargs)
    js = jagent.init(jax.random.PRNGKey(0))
    jenv = jmake_pendulum()
    jes = jax.vmap(jenv.init)(jax.random.split(jax.random.PRNGKey(7), N))
    jro, _, _ = jcollect_rollout(jenv, js, jagent.explore_action, jagent.env_action, jes,
                                 jax.vmap(jenv.obs)(jes), jax.random.PRNGKey(3), H, 1.0,
                                 extras_fn=jagent.rollout_extras, store_dtype=jnp.bfloat16)
    pst = ppo_state_from_numpy(jax.tree.map(np.asarray, js), 'cpu')
    pagent = make_ppo(NET_DIMS, 3, 1, args)
    x = torch.from_numpy(np.asarray(jro.states, np.float32))
    mean = mlp_apply_leaves(pst.act.mlp.leaves(), norm_state(x, pst.norm_avg, pst.norm_std), BF)
    lp = dists.normal_logprob(torch.from_numpy(np.asarray(jro.actions)), mean,
                              torch.exp(pst.act.std_log)).sum(-1)
    _close(lp.numpy(), np.asarray(jro.logprobs), 'JAX logprobs')
    _close(pagent.rollout_extras(pst, x)['values'].numpy(), np.asarray(jro.extras['values']),
           'JAX values')
    # off-policy: the float actions are stored in bf16 as well
    dargs = Config(AgentDDPG, PendulumEnv, dict(ENV_ARGS))
    dargs.device, dargs.net_dims = 'cpu', NET_DIMS
    dagent = AgentDDPG.make(NET_DIMS, 3, 1, dargs, buffer=None)
    dro, _, _ = collect_rollout(env, dagent.init(0, 'cpu'), dagent.explore_action,
                                dagent.env_action, env_state, obs, gen, H, 1.0, store_dtype=BF)
    assert dro.states.dtype == BF and dro.actions.dtype == BF and dro.logprobs is None


# -------------------------------------------------------- the PPO update

B = 128
U = int(H * 4 * 8 / B)


@pytest.fixture(scope='module')
def bf16_update():
    """One JAX scan update under compute_dtype='bfloat16' (the JAX package
    takes no fused kernel there) on a bf16-stored rollout, and the port's
    update on the same inputs and minibatch ids."""
    h = 4 * H
    jargs = JConfig()
    jargs.net_dims, jargs.batch_size, jargs.repeat_times = NET_DIMS, B, 8.0
    jargs.compute_dtype = jargs.storage_dtype = 'bfloat16'
    jagent = jmake_ppo(NET_DIMS, 3, 1, jargs)
    s = jagent.init(jax.random.PRNGKey(5))
    env = jmake_pendulum()
    env_state = jax.vmap(env.init)(jax.random.split(jax.random.PRNGKey(7), N))
    env_state = env_state._replace(t=(jnp.arange(N) * 23 % 200).astype(jnp.int32))
    jro, _, last_obs = jcollect_rollout(
        env, s, jagent.explore_action, jagent.env_action, env_state,
        jax.vmap(env.obs)(env_state), jax.random.PRNGKey(3), h, reward_scale=1.0,
        extras_fn=jagent.rollout_extras, store_dtype=jnp.bfloat16)
    k_upd = jax.random.PRNGKey(11)
    js_new, jm = jax.jit(jagent.update)(s, jro, last_obs, k_upd)
    ids = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (B,), 0, h * N))(
        jax.random.split(k_upd, U)))

    args = Config()
    args.device, args.net_dims, args.batch_size, args.repeat_times = 'cpu', NET_DIMS, B, 8.0
    args.compute_dtype = args.storage_dtype = 'bfloat16'
    args.horizon_len = h
    agent = make_ppo(NET_DIMS, 3, 1, args)
    st = ppo_state_from_numpy(jax.tree.map(np.asarray, s), 'cpu')
    old = ppo_state_to_numpy(st)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    ro = Rollout(states=t(jro.states).to(BF), actions=t(jro.actions), logprobs=t(jro.logprobs),
                 rewards=t(jro.rewards), undones=t(jro.undones), unmasks=t(jro.unmasks),
                 extras={'values': t(jro.extras['values'])})
    st_new, m = agent.update(st, ro, t(last_obs), None, ids=torch.from_numpy(ids.copy()).long())
    return (jax.tree.map(np.asarray, s), jax.tree.map(np.asarray, js_new), jm, old,
            ppo_state_to_numpy(st_new), m)


def test_bf16_update_params_match_jax_scan(bf16_update):
    jold, jnew, _, old, new, _ = bf16_update
    for part in ('act', 'cri'):
        for a, b, ja, jb in zip(tree_leaves(getattr(new, part)), tree_leaves(getattr(old, part)),
                                tree_leaves(getattr(jnew, part)), tree_leaves(getattr(jold, part))):
            np.testing.assert_allclose(a - b, ja - jb, rtol=2e-2, atol=1e-7, err_msg=part)


def test_bf16_update_metrics_match_jax_scan(bf16_update):
    _, _, jm, _, _, m = bf16_update
    for k in ('obj_critic', 'obj_actor', 'obj_entropy'):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-3, atol=1e-6, err_msg=k)


# ------------------------------------------------------------ replay ring

def test_bf16_replay_ring_and_npz_both_ways(tmp_path):
    """bf16 states and float actions in the ring (scalars float32); the npz
    widens them to float32 and each package reads the other's file."""
    args = Config()
    args.storage_dtype = 'bfloat16'
    rb = ReplayBuffer(max_size=12, state_dim=3, action_dim=2, num_seqs=4, args=args,
                      device='cpu')
    buf = rb.init()
    assert buf.states.dtype == BF and buf.actions.dtype == BF and buf.rewards.dtype == torch.float32
    rng = np.random.default_rng(0)
    items = (torch.from_numpy(rng.standard_normal((5, 4, 3)).astype(np.float32)),
             torch.from_numpy(rng.uniform(-1, 1, (5, 4, 2)).astype(np.float32)),
             *[torch.from_numpy(rng.random((5, 4)).astype(np.float32)) for _ in range(3)])
    buf = rb.update(buf, items)
    torch.testing.assert_close(buf.states[:5], items[0].to(BF), rtol=0, atol=0)
    s, a, r, *_ = rb.sample(buf, 8, ids=torch.arange(8))
    assert s.dtype == BF and a.dtype == BF and r.dtype == torch.float32
    d = str(tmp_path / 'port')
    os.makedirs(d)
    rb.save_or_load_history(buf, d, if_save=True)
    with np.load(os.path.join(d, 'replay_buffer.npz')) as f:
        assert f['states'].dtype == np.float32
        np.testing.assert_array_equal(f['states'], buf.states.float().numpy())
    # the JAX package loads the port's file into its bf16 ring
    jargs = JConfig()
    jargs.storage_dtype = 'bfloat16'
    jrb = JReplayBuffer(max_size=12, state_dim=3, action_dim=2, num_seqs=4, args=jargs)
    jbuf = jrb.save_or_load_history(jrb.init(), d, if_save=False)
    assert jbuf.states.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jbuf.states, np.float32), buf.states.float().numpy())
    np.testing.assert_array_equal(np.asarray(jbuf.actions, np.float32),
                                  buf.actions.float().numpy())
    # and the port loads the JAX package's file back into its bf16 ring
    d2 = str(tmp_path / 'jax')
    os.makedirs(d2)
    jrb.save_or_load_history(jbuf, d2, if_save=True)
    back = rb.save_or_load_history(rb.init(), d2, if_save=False)
    assert back.states.dtype == BF and back.actions.dtype == BF
    for f in ('states', 'actions', 'rewards', 'undones', 'unmasks'):
        torch.testing.assert_close(getattr(back, f), getattr(buf, f), rtol=0, atol=0)
    assert (back.ptr, back.size) == (buf.ptr, buf.size)


# ---------------------------------------------------------- a whole round

RH, RB = 32, 128
RU = int(RH * 8 / RB)


def _configure(args):
    """``ppo_pendulum_bf16``'s recipe (scripts/verify_learning.py:155-160:
    bf16 compute, a (128, 64) net) cut to CPU size."""
    args.horizon_len, args.net_dims, args.batch_size = RH, (32, 16), RB
    args.repeat_times, args.random_seed, args.reward_scale = 8.0, 0, 0.5
    args.compute_dtype = 'bfloat16'
    return args


@pytest.fixture(scope='module')
def bf16_round():
    jargs = _configure(JConfig(JAgentPPO, JPendulumEnv, dict(ENV_ARGS)))
    jargs.use_pallas_rollout = 'interpret'
    jctx = jbuild_training(jargs)
    jc = jctx.carry
    _, k_roll, k_upd = jax.random.split(jc.key, 3)
    kz, ku = jax.random.split(k_roll)
    noise = np.asarray(jnp.concatenate([jax.random.normal(kz, (RH, 1, N), jnp.float32),
                                        jax.random.uniform(ku, (RH, 2, N), jnp.float32)], 1))
    ids = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (RB,), 0, RH * N))(
        jax.random.split(k_upd, RU)))
    jc2, jm = jax.jit(jctx.round_fn)(jc, None)

    args = _configure(Config(AgentPPO, PendulumEnv, dict(ENV_ARGS)))
    args.device = 'cpu'
    ctx = build_training(args)
    assert ctx.fused_rollout
    state = ppo_state_from_numpy(jax.tree.map(np.asarray, jc.agent_state), 'cpu')
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    env_state = PendulumState(t(jc.env_state.theta), t(jc.env_state.theta_dot),
                              t(jc.env_state.t))
    carry = ctx.carry._replace(agent_state=state, env_state=env_state, obs=t(jc.obs))
    old = ppo_state_to_numpy(state)
    c2, m = ctx.round_fn(carry, noise=t(noise), ids=t(ids).long())
    return dict(jc=jc, jc2=jc2, jm=jm, old=old, c2=c2, m=m)


def test_bf16_round_matches_jax_round(bf16_round):
    r = bf16_round
    for k in ('obj_critic', 'obj_actor', 'obj_entropy', 'exp_r'):
        np.testing.assert_allclose(float(r['m'][k]), float(r['jm'][k]), rtol=2e-2, atol=1e-5,
                                   err_msg=k)
    jold = jax.tree.map(np.asarray, r['jc'].agent_state)
    jnew = jax.tree.map(np.asarray, r['jc2'].agent_state)
    new = ppo_state_to_numpy(r['c2'].agent_state)
    # over a rollout and two minibatches the bf16 rounding differences
    # accumulate: an Adam step whose gradient element is small and changes
    # sign between the minibatches moves further; every step within a sixth
    # of the learning rate, 99% to the update tolerance
    for part in ('act', 'cri'):
        for a, b, ja, jb in zip(tree_leaves(getattr(new, part)), tree_leaves(getattr(r['old'], part)),
                                tree_leaves(getattr(jnew, part)), tree_leaves(getattr(jold, part))):
            got, want = a - b, ja - jb
            assert np.mean(np.abs(got - want) <= 1e-6 + 2e-2 * np.abs(want)) >= 0.99, part
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=part)
    np.testing.assert_array_equal(r['c2'].env_state.t.numpy(), np.asarray(r['jc2'].env_state.t))
    np.testing.assert_allclose(r['c2'].obs.numpy(), np.asarray(r['jc2'].obs), atol=2e-2)


# ---------------------------------------------------------- the selection

def test_wide_auto_takes_bf16_and_the_autograd_update(capsys):
    """``net_dims=(512, 512)`` with the default 'auto' resolves to bf16 in
    both packages: the port builds a trainer (no raise), runs the fused
    rollout's plain version on the CPU and the autograd update (the JAX
    package takes no fused update under bf16), and declines K11b."""
    args = Config(AgentPPO, PendulumEnv, dict(ENV_ARGS))
    args.device, args.net_dims, args.horizon_len, args.batch_size = 'cpu', (512, 512), 8, 128
    assert args.compute_dtype == 'auto'
    ctx = build_training(args)
    out = capsys.readouterr().out
    assert ctx.fused_rollout
    assert '| use_fused_update: PyTorch path' in out
    assert '| use_mlp3_kernel: PyTorch path' in out
    c2, m = ctx.round_fn(ctx.carry)
    assert all(np.isfinite(float(v)) for k, v in m.items() if k != 'action_hist')
    assert c2.agent_state.act_opt.count == 1
    # the JAX package's own choice at these widths
    jargs = JConfig()
    jargs.net_dims, jargs.batch_size = (512, 512), 128
    from elegantrl_tpu.agents.base import resolve_compute_dtype as jresolve
    assert jresolve(jargs, (512, 512)) == jnp.bfloat16


def test_card_takes_the_bf16_rollout_kernels_and_raises_for_k4(monkeypatch):
    """On a simulated card bf16 compute takes K1's bf16 variant at (512,
    512), where the float32 one's resident design could not; past the bf16
    resident limit the streamed design takes it, in 16-lane groups to 2624 on
    Pendulum and in narrower ones past that, and past its narrowest groups
    (8224) the card raises naming that width; the stock body takes K4's bf16
    variant, its resident designs to 576 (the critic pass's tile), the
    streamed ones past it (past 1408 the critic pass on 16-sample tiles),
    and raises past 2624, naming it."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    from elegantrl_tpu_torch.train import runner
    made = {}
    monkeypatch.setattr(fr, 'make_fused_rollout', lambda *a, **k: made.update(k) or 'fused')
    args = Config(AgentPPO, PendulumEnv, dict(ENV_ARGS))
    args.device, args.net_dims = 'cuda', (512, 512)
    env = runner._resolve_env_def(args)
    args.state_dim, args.action_dim, args.if_discrete = 3, 1, False
    agent = runner._make_agent(args, None)
    assert runner._maybe_fused_rollout(args, env, agent, torch.device('cuda'), 4096, 64,
                                       1.0) == 'fused'
    assert made['compute_dtype'] == BF and made['store_dtype'] is None
    assert fr.rollout_fits_resident(fr.PENDULUM_BODY, (512, 512), bf16=True)
    assert not fr.rollout_fits_resident(fr.PENDULUM_BODY, (512, 512))
    assert not fr.rollout_fits_resident(fr.PENDULUM_BODY, (516, 516), bf16=True)
    args.net_dims = (516, 516)
    agent = runner._make_agent(args, None)
    made.clear()
    assert runner._maybe_fused_rollout(args, env, agent, torch.device('cuda'), 4096, 64,
                                       1.0) == 'fused'
    assert made['compute_dtype'] == BF
    args.net_dims = (2628, 2628)
    agent = runner._make_agent(args, None)
    made.clear()
    assert runner._maybe_fused_rollout(args, env, agent, torch.device('cuda'), 4096, 64,
                                       1.0) == 'fused'
    assert fr.rollout_group_lanes(fr.PENDULUM_BODY, (2628, 2628), bf16=True) == 8
    assert fr.rollout_width_limit(fr.PENDULUM_BODY, bf16=True) == 8224
    args.net_dims = (8228, 8228)
    agent = runner._make_agent(args, None)
    with pytest.raises(ValueError, match='up to 8224 on Pendulum-v1 in bf16'):
        runner._maybe_fused_rollout(args, env, agent, torch.device('cuda'), 4096, 64, 1.0)
    sargs = Config(AgentPPO, StockTradingVecEnv,
                   {'env_name': 'StockTradingEnv-v2', 'num_envs': 256, 'max_step': 9,
                    'state_dim': 151, 'action_dim': 15, 'if_discrete': False, 'end_idx': 10})
    sargs.device, sargs.net_dims, sargs.compute_dtype = 'cuda', (128, 128), 'bfloat16'
    senv = runner._resolve_env_def(sargs)
    sargs.state_dim, sargs.action_dim, sargs.if_discrete = (senv.spec.state_dim,
                                                            senv.spec.action_dim, False)
    sagent = runner._make_agent(sargs, None)
    made.clear()
    assert runner._maybe_fused_rollout(sargs, senv, sagent, torch.device('cuda'), 256, 128,
                                       1.0) == 'fused'
    assert made['compute_dtype'] == BF and made['store_dtype'] is None
    sargs.net_dims = (580, 580)
    sagent = runner._make_agent(sargs, None)
    made.clear()
    assert runner._maybe_fused_rollout(sargs, senv, sagent, torch.device('cuda'), 256, 128,
                                       1.0) == 'fused'
    sargs.net_dims = (1412, 1412)
    sagent = runner._make_agent(sargs, None)
    made.clear()
    assert runner._maybe_fused_rollout(sargs, senv, sagent, torch.device('cuda'), 256, 128,
                                       1.0) == 'fused'
    assert fr.critic_tile((1412, 1412)) == 16
    sargs.net_dims = (2628, 2628)
    sagent = runner._make_agent(sargs, None)
    with pytest.raises(ValueError, match='2624 on StockTradingEnv-v2'):
        runner._maybe_fused_rollout(sargs, senv, sagent, torch.device('cuda'), 256, 128, 1.0)
