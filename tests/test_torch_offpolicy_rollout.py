"""Parity of the port's off-policy fused-rollout plain version
(``elegantrl_tpu_torch/ops/fused_rollout.py:offpolicy_rollout_reference``)
with the JAX package's off-policy Pallas rollout in interpret mode
(``make_fused_offpolicy_rollout(..., interpret=True)``) for every head the
port has: ``ddpg`` on Pendulum (TD3) and HopperSlip (DDPG), ``sac`` on
HopperSlip (SAC), ``modsac`` on Pendulum (ModSAC), ``dqn``, ``dqn_enc``
(DoubleDQN) and ``dqn_duel`` (DuelingDQN, D3QN) on CartPole; 16 envs x 8
steps, net (16, 16), the same weights (carried through numpy) and the same
injected noise.

The JAX wrapper draws its noise from the key: uniforms ``(H, 2 + n_env,
N)`` for the DQN heads (the coin, the random-action uniform, then the
env's uniforms); ``kz, ku = split(key)``, normals ``(H, A, N)`` then the
env's uniforms for the continuous heads (ddpg, sac, modsac).  The tests recompute it and hand it to
the port in injected-noise mode.

Tolerances: states, continuous actions, rewards and final env rows 1e-5
over 8 steps (f32 sums in another order); discrete actions, flags and step
counters exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu.agents.ddpg_td3 import _make as jmake_ddpg_td3
from elegantrl_tpu.agents.dqn import make_dqn as jmake_dqn
from elegantrl_tpu.agents.sac import make_sac as jmake_sac
from elegantrl_tpu.config import Config as JConfig
from elegantrl_tpu.envs.cartpole import make_cartpole as jmake_cartpole
from elegantrl_tpu.envs.hopper import make_hopper as jmake_hopper
from elegantrl_tpu.envs.pendulum import make_pendulum as jmake_pendulum
from elegantrl_tpu.ops import pallas_rollout as jpr
from elegantrl_tpu_torch.envs import CartPoleState, HopperState, PendulumState
from elegantrl_tpu_torch.ops import fused_rollout as fr
from elegantrl_tpu_torch.utils.jax_params import (ddpg_state_from_numpy, dqn_state_from_numpy,
                                                  env_state_from_numpy, sac_state_from_numpy)

torch.set_num_threads(1)
NET_DIMS = (16, 16)
H, N = 8, 16
REWARD_SCALE = 0.5
NOISE_STD, EXPLORE_RATE = 0.1, 0.25


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


# name: (env, JAX body, port body, port env state, head, agent kind, twin, duel)
CASES = {
    'td3_pendulum': ('pendulum', jpr.PENDULUM_BODY, fr.PENDULUM_BODY, PendulumState, 'ddpg', 'td3'),
    'ddpg_hopper': ('hopper', jpr.HOPPER_BODY, fr.HOPPER_BODY, HopperState, 'ddpg', 'ddpg'),
    'sac_hopper': ('hopper', jpr.HOPPER_BODY, fr.HOPPER_BODY, HopperState, 'sac', 'sac'),
    'modsac_pendulum': ('pendulum', jpr.PENDULUM_BODY, fr.PENDULUM_BODY, PendulumState, 'modsac',
                        'modsac'),
    'dqn_cartpole': ('cartpole', jpr.CARTPOLE_BODY, fr.CARTPOLE_BODY, CartPoleState, 'dqn',
                     (False, False)),
    'doubledqn_cartpole': ('cartpole', jpr.CARTPOLE_BODY, fr.CARTPOLE_BODY, CartPoleState,
                           'dqn_enc', (True, False)),
    'duelingdqn_cartpole': ('cartpole', jpr.CARTPOLE_BODY, fr.CARTPOLE_BODY, CartPoleState,
                            'dqn_duel', (False, True)),
    'd3qn_cartpole': ('cartpole', jpr.CARTPOLE_BODY, fr.CARTPOLE_BODY, CartPoleState,
                      'dqn_duel', (True, True)),
}
ENVS = {'pendulum': jmake_pendulum, 'hopper': jmake_hopper, 'cartpole': jmake_cartpole}


def _std_clip(head):
    """The runners' head_cfg: ModSAC's clip, else SAC's (unused by the rest)."""
    return (-20.0, 2.0) if head == 'modsac' else (-16.0, 2.0)


def _agent_state(body, kind, seed, net_dims=NET_DIMS):
    """The JAX agent's initial state and the port's flat buffer of it."""
    args = JConfig()
    S, A = body.state_dim, body.action_dim
    if kind in ('td3', 'ddpg'):
        s = jmake_ddpg_td3(net_dims, S, A, args, None, td3=kind == 'td3').init(
            jax.random.PRNGKey(seed))
        return s, ddpg_state_from_numpy(jax.tree.map(np.asarray, s), 'cpu').act
    if kind in ('sac', 'modsac'):
        s = jmake_sac(net_dims, S, A, args, None, modsac=kind == 'modsac').init(
            jax.random.PRNGKey(seed))
        return s, sac_state_from_numpy(jax.tree.map(np.asarray, s), 'cpu', kind == 'modsac').act
    twin, duel = kind
    s = jmake_dqn(net_dims, S, A, args, twin=twin, duel=duel).init(jax.random.PRNGKey(seed))
    return s, dqn_state_from_numpy(jax.tree.map(np.asarray, s), 'cpu', twin, duel).q


def _noise(body, head, key, h=H):
    n_env = body.n_step + body.n_reset
    if head not in fr.CONTINUOUS_HEADS:
        return jax.random.uniform(key, (h, 2 + n_env, N), jnp.float32)
    kz, ku = jax.random.split(key)
    return jnp.concatenate([jax.random.normal(kz, (h, body.action_dim, N), jnp.float32),
                            jax.random.uniform(ku, (h, n_env, N), jnp.float32)], axis=1)


@pytest.fixture(scope='module', params=list(CASES))
def pair(request):
    env_name, jbody, body, state_class, head, kind = CASES[request.param]
    js, flat = _agent_state(jbody, kind, seed=len(request.param))
    env = ENVS[env_name]()
    env_state = jax.vmap(env.init)(jax.random.split(jax.random.PRNGKey(9), N))
    env_state = _stagger(env_name, env_state)
    obs = jax.vmap(env.obs)(env_state)
    fast = jpr.make_fused_offpolicy_rollout(
        jbody, NET_DIMS, H, N, REWARD_SCALE, head=head,
        head_cfg={'noise_std': NOISE_STD, 'explore_rate': EXPLORE_RATE,
                  'std_clip': _std_clip(head)}, block=8, interpret=True)
    key = jax.random.PRNGKey(3)
    jro, jenv2, _ = fast(js, env_state, obs, key)
    f0, i0 = body.pack(env_state_from_numpy(state_class, jax.tree.map(np.asarray, env_state),
                                            'cpu'))
    noise = torch.tensor(np.asarray(_noise(jbody, head, key)))
    got = fr.offpolicy_rollout(flat, f0, i0, body=body, head=head, net_dims=NET_DIMS,
                               horizon_len=H, reward_scale=REWARD_SCALE, noise_std=NOISE_STD,
                               explore_rate=EXPLORE_RATE, std_clip=_std_clip(head), noise=noise)
    jf, ji = jbody.pack(jenv2)
    return (request.param, jax.tree.map(np.asarray, jro), np.asarray(jf), np.asarray(ji), got,
            body, head, flat, f0, i0)


def test_states_and_rewards(pair):
    _, jro, _, _, got, *_ = pair
    np.testing.assert_allclose(got.states.numpy(), jro.states, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.rewards.numpy(), jro.rewards, rtol=0, atol=1e-5)


def test_actions(pair):
    _, jro, _, _, got, _, head, *_ = pair
    if head in fr.CONTINUOUS_HEADS:
        np.testing.assert_allclose(got.actions.numpy(), jro.actions, rtol=0, atol=1e-5)
    else:
        assert got.actions.dtype == torch.int32 and got.actions.shape == (H, N)
        np.testing.assert_array_equal(got.actions.numpy(), jro.actions)


def test_flags_and_final_env_rows(pair):
    name, jro, jf, ji, got, *_ = pair
    np.testing.assert_array_equal(1.0 - got.terminals.numpy(), jro.undones)
    np.testing.assert_array_equal(1.0 - got.truncates.numpy(), jro.unmasks)
    np.testing.assert_allclose(got.env_f.numpy(), jf, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.env_i.numpy(), ji.reshape(got.env_i.shape))
    if not name.endswith('pendulum'):   # the staggered lanes end an episode within 8 steps
        assert float((got.terminals + got.truncates).sum()) > 0


@pytest.mark.parametrize('case', ['td3_pendulum', 'dqn_cartpole', 'sac_hopper',
                                  'modsac_pendulum'])
def test_philox_mode_is_injected_mode_on_its_draws(case):
    """Internal mode draws ``philox_uniforms(seed, H, N, count)``: the DQN
    heads take them as their injected rows; the continuous heads turn their
    first 2A into A normals by Box-Muller."""
    _, jbody, body, _, head, kind = CASES[case]
    _, flat = _agent_state(jbody, kind, seed=1)
    gen = torch.Generator().manual_seed(0)
    env_f = torch.rand((body.n_f32, N), generator=gen) * 0.1
    env_i = torch.zeros((1, N), dtype=torch.int32)
    seed = torch.tensor([12, -5], dtype=torch.int32)
    u = fr.philox_uniforms(seed, H, N, fr.offpolicy_uniforms_per_step(body, head))
    A = body.action_dim
    if head in fr.CONTINUOUS_HEADS:
        z = torch.sqrt(-2.0 * torch.log(1.0 - u[:, :A])) * torch.cos(2 * np.pi * u[:, A:2 * A])
        noise = torch.cat([z, u[:, 2 * A:]], dim=1)
    else:
        noise = u
    kw = dict(body=body, head=head, net_dims=NET_DIMS, horizon_len=H, reward_scale=1.0,
              noise_std=NOISE_STD, explore_rate=EXPLORE_RATE, std_clip=_std_clip(head))
    a = fr.offpolicy_rollout(flat, env_f, env_i, seed=seed, **kw)
    b = fr.offpolicy_rollout(flat, env_f, env_i, noise=noise, **kw)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)


@pytest.mark.parametrize('body,head,fits', [
    (fr.PENDULUM_BODY, 'ddpg', True), (fr.HOPPER_BODY, 'ddpg', True),
    (fr.CHASING_BODY, 'ddpg', True), (fr.CARTPOLE_BODY, 'dqn_duel', True),
    (fr.CHASING_DISCRETE_BODY, 'dqn_enc', True), (fr.CARTPOLE_BODY, 'ddpg', False),
    (fr.PENDULUM_BODY, 'dqn', False), (fr.CARTPOLE_BODY, 'sac', False),
    (fr.HOPPER_BODY, 'sac', True), (fr.CHASING_BODY, 'sac', True),
    (fr.PENDULUM_BODY, 'modsac', True), (fr.HOPPER_BODY, 'modsac', True),
    (fr.CHASING_DISCRETE_BODY, 'modsac', False),
    # on a simulated card: TD3 and SAC on HopperSlip and DQN on CartPole take
    # the kernel at (256, 256); one width past the limit raises, naming it
    (fr.HOPPER_BODY, 'sac', 'takes (256, 256) on a card'),
    (fr.HOPPER_BODY, 'ddpg', 'raises past the limit on a card')])
def test_kernel_pairs(body, head, fits):
    """The kernel has the fifteen (body, head) pairs whose action spaces
    match, at every width the JAX runner sends its kernel up to what a
    cluster of blocks holds (576 on HopperSlip and CartPole)."""
    assert fr.offpolicy_pair_fits(body, head) == bool(fits)
    if isinstance(fits, bool):
        return
    from elegantrl_tpu_torch import Config
    from elegantrl_tpu_torch.agents import AgentDQN, AgentSAC, AgentTD3
    from elegantrl_tpu_torch.envs import CartPoleEnv, HopperEnv
    from elegantrl_tpu_torch.train import runner
    hopper = (HopperEnv, {'env_name': 'HopperSlip-v0', 'max_step': 1000, 'state_dim': 6,
                          'action_dim': 2, 'if_discrete': False})
    cartpole = (CartPoleEnv, {'env_name': 'CartPole-v1', 'max_step': 500, 'state_dim': 4,
                              'action_dim': 2, 'if_discrete': True})

    def on_a_card(agent_class, env, net_dims, num_envs, horizon):
        args = Config(agent_class, env[0], dict(env[1], num_envs=num_envs))
        args.net_dims, args.horizon_len, args.device = net_dims, horizon, 'cuda'
        args.compute_dtype = 'float32'   # 'auto' takes bf16 from 512, which the port refuses
        env_def = runner._resolve_env_def(args)
        agent = runner._make_agent(args, None)
        return runner._maybe_fused_rollout(args, env_def, agent, torch.device('cuda'), num_envs,
                                           horizon, 1.0)
    if fits == 'takes (256, 256) on a card':
        for agent_class, env, n, h in ((AgentTD3, hopper, 1024, 32), (AgentSAC, hopper, 1024, 32),
                                       (AgentDQN, cartpole, 64, 64)):
            assert on_a_card(agent_class, env, (256, 256), n, h) is not None, agent_class
        return
    # the resident design to (576, 576), the streamed one past it (16-lane
    # groups to 2592 on HopperSlip in float32, then groups of 8 and 4 lanes
    # to 8160), then the card raises naming that width
    assert (fr.offpolicy_fits_resident(body, head, (576, 576))
            and not fr.offpolicy_fits_resident(body, head, (580, 580)))
    assert fr.offpolicy_fits(body, head, (580, 580))
    assert on_a_card(AgentTD3, hopper, (580, 580), 1024, 32) is not None
    assert [fr.offpolicy_group_lanes(body, head, (d, d)) for d in (2592, 2596, 8160, 8164)] \
        == [16, 8, 4, 0]
    assert on_a_card(AgentTD3, hopper, (2596, 2596), 1024, 32) is not None
    assert fr.offpolicy_width_limit(fr.HOPPER_BODY, head) == 8160
    with pytest.raises(ValueError, match='square widths up to 8160'):
        on_a_card(AgentTD3, hopper, (8164, 8164), 1024, 32)


@pytest.mark.parametrize('case', ['sac_hopper', 'dqn_cartpole'])
def test_wide_plain_matches_pallas_kernel(case):
    """At (256, 256), a width the card's kernel now takes (a cluster of
    blocks holds the net's slices), the plain version against the JAX
    kernel in interpret mode over 4 steps, with the tolerances above."""
    env_name, jbody, body, state_class, head, kind = CASES[case]
    wide, h = (256, 256), 4
    js, flat = _agent_state(jbody, kind, seed=5, net_dims=wide)
    env = ENVS[env_name]()
    env_state = _stagger(env_name, jax.vmap(env.init)(jax.random.split(jax.random.PRNGKey(9), N)))
    fast = jpr.make_fused_offpolicy_rollout(
        jbody, wide, h, N, REWARD_SCALE, head=head,
        head_cfg={'noise_std': NOISE_STD, 'explore_rate': EXPLORE_RATE,
                  'std_clip': _std_clip(head)}, block=8, interpret=True)
    key = jax.random.PRNGKey(4)
    jro, jenv2, _ = fast(js, env_state, jax.vmap(env.obs)(env_state), key)
    jro = jax.tree.map(np.asarray, jro)
    f0, i0 = body.pack(env_state_from_numpy(state_class, jax.tree.map(np.asarray, env_state),
                                            'cpu'))
    got = fr.offpolicy_rollout(flat, f0, i0, body=body, head=head, net_dims=wide, horizon_len=h,
                               reward_scale=REWARD_SCALE, noise_std=NOISE_STD,
                               explore_rate=EXPLORE_RATE, std_clip=_std_clip(head),
                               noise=torch.tensor(np.asarray(_noise(jbody, head, key, h))))
    np.testing.assert_allclose(got.states.numpy(), jro.states, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.rewards.numpy(), jro.rewards, rtol=0, atol=1e-5)
    if head in fr.CONTINUOUS_HEADS:
        np.testing.assert_allclose(got.actions.numpy(), jro.actions, rtol=0, atol=1e-5)
    else:
        np.testing.assert_array_equal(got.actions.numpy(), jro.actions)
    np.testing.assert_array_equal(1.0 - got.terminals.numpy(), jro.undones)
    jf, ji = jbody.pack(jenv2)
    np.testing.assert_allclose(got.env_f.numpy(), np.asarray(jf), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.env_i.numpy(), np.asarray(ji).reshape(got.env_i.shape))
