"""Whole training rounds of the port's new on-policy agents on the CPU (so
through the kernels' plain versions) against the JAX package's rounds, on
the same weights, env state, exploration noise and minibatch ids:
``AgentDiscretePPO`` on CartPole (JAX: both Pallas paths in interpret mode)
and ``AgentA2C`` on Pendulum (JAX: the Pallas rollout in interpret mode, the
update on its scan path, which is the only one A2C has).  Then
``train_agent`` end to end for every new agent class and env, and the
kernel selection for the new workloads.

The JAX round splits its carry key as ``key, k_roll, k_upd = split(key,
3)``; the discrete rollout draws ``uniform(k_roll, (H, A + n_reset, N))``,
the Gaussian one ``normal(kz)`` and ``uniform(ku)`` from ``split(k_roll)``;
the PPO update draws flat ids and the A2C update time-slice ids, one
``randint`` per ``split(k_upd, U)`` key.  The tests replay those draws.

Tolerances, as ``tests/test_torch_train_round.py``: rollouts and env state
1e-4 (f32 rounding carried through H steps), parameter updates rtol 5e-3,
metrics rtol 1e-4.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu.agents import (AgentA2C as JAgentA2C, AgentDiscretePPO as JAgentDiscretePPO)
from elegantrl_tpu.config import Config as JConfig
from elegantrl_tpu.envs import CartPoleEnv as JCartPoleEnv, PendulumEnv as JPendulumEnv
from elegantrl_tpu.train.runner import build_training as jbuild_training
from elegantrl_tpu.utils.checkpoint import load_pytree as jload_pytree
from elegantrl_tpu_torch import Config, build_training, train_agent
from elegantrl_tpu_torch.agents import (AgentA2C, AgentDiscreteA2C, AgentDiscretePPO, AgentPPO,
                                        make_ppo)
from elegantrl_tpu_torch.envs import (CartPoleEnv, CartPoleState, HopperEnv, PendulumEnv,
                                      PendulumState, PointChasingDiscreteEnv,
                                      PointChasingVecEnv)
from elegantrl_tpu_torch.utils.checkpoint import tree_leaves
from elegantrl_tpu_torch.utils.jax_params import (env_state_from_numpy, ppo_state_from_numpy,
                                                  ppo_state_to_numpy)

torch.set_num_threads(1)
H, N = 32, 16
ENVS = {
    'cartpole': (CartPoleEnv, {'env_name': 'CartPole-v1', 'max_step': 500, 'state_dim': 4,
                               'action_dim': 2, 'if_discrete': True}),
    'pendulum': (PendulumEnv, {'env_name': 'Pendulum-v1', 'max_step': 200, 'state_dim': 3,
                               'action_dim': 1, 'if_discrete': False}),
    'hopper': (HopperEnv, {'env_name': 'HopperSlip-v0', 'max_step': 1000, 'state_dim': 6,
                           'action_dim': 2, 'if_discrete': False}),
    'chasing': (PointChasingVecEnv, {'env_name': 'PointChasingVecEnv', 'max_step': 1024,
                                     'state_dim': 8, 'action_dim': 2, 'if_discrete': False}),
    'chasing_discrete': (PointChasingDiscreteEnv,
                         {'env_name': 'PointChasingDiscreteEnv', 'max_step': 1024,
                          'state_dim': 8, 'action_dim': 9, 'if_discrete': True}),
}


def _args(config_class, agent_class, env_class, env_args, batch):
    args = config_class(agent_class, env_class, dict(env_args, num_envs=N))
    args.horizon_len, args.net_dims, args.batch_size = H, (16, 16), batch
    args.repeat_times, args.random_seed, args.reward_scale = 8.0, 0, 0.5
    return args


ROUNDS = {   # name -> (JAX agent, JAX env, agent, env key, state class, batch, a2c)
    'discrete_ppo_cartpole': (JAgentDiscretePPO, JCartPoleEnv, AgentDiscretePPO, 'cartpole',
                              CartPoleState, 128, False),
    'a2c_pendulum': (JAgentA2C, JPendulumEnv, AgentA2C, 'pendulum', PendulumState, 8, True),
}


@pytest.fixture(scope='module', params=list(ROUNDS))
def rounds(request):
    jagent, jenv, agent, env_key, state_class, batch, a2c = ROUNDS[request.param]
    env_class, env_args = ENVS[env_key]
    updates = int(H * 8 / batch)
    jargs = _args(JConfig, jagent, jenv, env_args, batch)
    jargs.use_pallas_rollout = 'interpret'
    jargs.use_pallas_update = False if a2c else 'interpret'
    jctx = jbuild_training(jargs)
    jc = jctx.carry
    _, k_roll, k_upd = jax.random.split(jc.key, 3)
    if env_args['if_discrete']:
        noise = jax.random.uniform(k_roll, (H, env_args['action_dim'] + 4, N), jnp.float32)
    else:
        kz, ku = jax.random.split(k_roll)
        noise = jnp.concatenate([jax.random.normal(kz, (H, 1, N), jnp.float32),
                                 jax.random.uniform(ku, (H, 2, N), jnp.float32)], 1)
    high = H if a2c else H * N
    ids = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (batch,), 0, high))(
        jax.random.split(k_upd, updates)))
    jc2, jm = jax.jit(jctx.round_fn)(jc, None)

    args = _args(Config, agent, env_class, env_args, batch)
    args.device = 'cpu'
    ctx = build_training(args)
    assert ctx.fused_rollout and ctx.agent.name == jctx.agent.name
    state = ppo_state_from_numpy(jax.tree.map(np.asarray, jc.agent_state), 'cpu')
    carry = ctx.carry._replace(agent_state=state,
                               env_state=env_state_from_numpy(state_class, jc.env_state, 'cpu'),
                               obs=torch.from_numpy(np.array(jc.obs)))
    old = ppo_state_to_numpy(state)
    c2, m = ctx.round_fn(carry, noise=torch.from_numpy(np.array(noise)),
                         ids=torch.from_numpy(ids.copy()).long())
    return dict(jc=jc, jc2=jc2, jm=jm, old=old, c2=c2, m=m, updates=updates)


def test_round_metrics_match(rounds):
    for k in ('obj_critic', 'obj_actor', 'obj_entropy', 'exp_r'):
        np.testing.assert_allclose(float(rounds['m'][k]), float(rounds['jm'][k]),
                                   rtol=1e-4, atol=1e-5)


def test_round_parameter_updates_match(rounds):
    jold = jax.tree.map(np.asarray, rounds['jc'].agent_state)
    jnew = jax.tree.map(np.asarray, rounds['jc2'].agent_state)
    new = ppo_state_to_numpy(rounds['c2'].agent_state)
    old = rounds['old']
    for part in ('act', 'cri'):
        leaves = [tree_leaves(getattr(t, part)) for t in (new, old, jnew, jold)]
        assert len({len(x) for x in leaves}) == 1
        for a, b, ja, jb in zip(*leaves):
            np.testing.assert_allclose(a - b, ja - jb, rtol=5e-3, atol=1e-8)
    assert rounds['c2'].agent_state.act_opt.count == rounds['updates']


def test_round_env_state_and_obs_match(rounds):
    c2, jc2 = rounds['c2'], rounds['jc2']
    for name in type(c2.env_state)._fields:
        got, want = getattr(c2.env_state, name).numpy(), np.asarray(getattr(jc2.env_state, name))
        if got.dtype.kind == 'i':
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(c2.obs.numpy(), np.asarray(jc2.obs), atol=1e-4)


# ------------------------------------------------------------- train_agent

TRAIN = [(AgentDiscretePPO, 'cartpole', 128), (AgentA2C, 'pendulum', 8),
         (AgentDiscreteA2C, 'chasing_discrete', 8), (AgentPPO, 'hopper', 128),
         (AgentA2C, 'chasing', 8), (AgentDiscreteA2C, 'cartpole', 8)]


@pytest.mark.parametrize('agent_class,env_key,batch', TRAIN,
                         ids=[f'{a.__name__}-{e}' for a, e, _ in TRAIN])
def test_train_agent_on_cpu(agent_class, env_key, batch, tmp_path):
    env_class, env_args = ENVS[env_key]
    args = _args(Config, agent_class, env_class, env_args, batch)
    args.device, args.cwd = 'cpu', str(tmp_path / 'run')
    args.eval_per_step, args.break_step, args.eval_times = H * N, H * N, 2
    args.max_step = 50                       # evaluation episodes are cut at 50 steps
    out = train_agent(args)
    assert out['total_step'] == 2 * H * N
    assert out['recorder'].shape[0] == 2 and np.isfinite(out['recorder']).all()
    for name in ('agent.npz', 'train_carry.npz', 'recorder.npy'):
        assert os.path.isfile(os.path.join(args.cwd, name))
    state = out['agent_state']
    assert (state.act.std_log is None) == env_args['if_discrete']
    assert state.act_opt.count == 2 * int(H * 8 / batch)
    # resuming reads the carry back, env state included
    args.continue_train = True
    ctx = build_training(args)
    for a, b in zip(tree_leaves(ppo_state_to_numpy(ctx.carry.agent_state)),
                    tree_leaves(ppo_state_to_numpy(state))):
        np.testing.assert_array_equal(a, b)


def test_discrete_checkpoint_has_the_jax_leaf_order(tmp_path):
    env_class, env_args = ENVS['cartpole']
    args = _args(Config, AgentDiscretePPO, env_class, env_args, 128)
    args.device, args.cwd = 'cpu', str(tmp_path / 'run')
    args.eval_per_step, args.break_step, args.eval_times, args.max_step = H * N, 1, 2, 50
    out = train_agent(args)
    jargs = _args(JConfig, JAgentDiscretePPO, JCartPoleEnv, env_args, 128)
    jtemplate = JAgentDiscretePPO.make((16, 16), 4, 2, jargs).init(jax.random.PRNGKey(0))
    loaded = jload_pytree(os.path.join(args.cwd, 'agent.npz'), jtemplate)
    want = ppo_state_to_numpy(out['agent_state'])
    assert 'std_log' not in want.act
    for a, b in zip(jax.tree.leaves(loaded), tree_leaves(want), strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_greedy_cartpole_episodes_end_early(tmp_path):
    """Evaluation episodes that terminate stop counting: an untrained policy
    drops the pole long before the 500-step limit."""
    env_class, env_args = ENVS['cartpole']
    args = _args(Config, AgentDiscretePPO, env_class, env_args, 128)
    args.device, args.cwd = 'cpu', str(tmp_path / 'run')
    args.eval_per_step, args.break_step, args.eval_times, args.max_step = H * N, 1, 4, 120
    out = train_agent(args)
    avg_r = out['recorder'][0, 1]
    assert 5 <= avg_r < 120 and out['max_r'] == avg_r


# -------------------------------------------------------- kernel selection

def _rollout_on_a_card(args):
    """The rollout ``build_training`` would choose on a CUDA device (made
    before any tensor is): the kernel's ``rollout_fn``, or None."""
    from elegantrl_tpu_torch.train import runner
    env = runner._resolve_env_def(args)
    for k in ('state_dim', 'action_dim', 'if_discrete'):
        setattr(args, k, getattr(env.spec, k))
    agent = runner._make_agent(args, None)
    return runner._maybe_fused_rollout(args, env, agent, torch.device('cuda'), args.num_envs,
                                       args.horizon_len, 1.0)


@pytest.mark.parametrize('agent_class,env_key,fused', [
    (AgentDiscretePPO, 'cartpole', True), (AgentDiscreteA2C, 'chasing_discrete', True),
    (AgentA2C, 'hopper', True), (AgentPPO, 'chasing', True),
    (AgentPPO, 'cartpole', False),            # a continuous agent on a discrete env
    (AgentDiscretePPO, 'pendulum', False)])   # and the reverse
def test_fused_rollout_eligibility_follows_agent_and_env(agent_class, env_key, fused):
    env_class, env_args = ENVS[env_key]
    args = _args(Config, agent_class, env_class, env_args, 128)
    args.device = 'cpu'
    if fused:
        assert build_training(args).fused_rollout
        return
    args.use_fused_rollout = True
    with pytest.raises(ValueError, match='use_fused_rollout=True requires'):
        build_training(args)
    # the JAX package runs this rollout as XLA ops: the generic rollout, on a card too
    args.use_fused_rollout, args.device = 'auto', 'cuda'
    assert _rollout_on_a_card(args) is None


def test_point_chasing_other_dim_has_no_body():
    """The chasing bodies are fixed to dim 2: dim 3 runs the generic
    rollout, on the CPU and on a card, as the JAX package runs its scan."""
    env_args = dict(ENVS['chasing'][1], state_dim=12, action_dim=3, dim=3)
    args = _args(Config, AgentPPO, PointChasingVecEnv, env_args, 128)
    args.device = 'cpu'
    ctx = build_training(args)
    assert not ctx.fused_rollout
    _, m = ctx.round_fn(ctx.carry)
    assert np.isfinite(float(m['obj_critic']))
    args.device = 'cuda'
    assert _rollout_on_a_card(args) is None


@pytest.mark.parametrize('discrete', [False, True])
def test_update_kernel_selection_on_a_card(discrete):
    """(Discrete)PPO's update has a kernel, so on a card the plain path is
    refused; A2C's has none in either package, so A2C is built there and
    only an explicit request for the kernel is refused."""
    args = Config()
    args.device, args.net_dims, args.use_fused_update = 'cuda', (16, 16), False
    args.batch_size = 128                  # a batch the JAX package's kernel takes
    with pytest.raises(ValueError, match='use_fused_update=False .* CPU only'):
        make_ppo((16, 16), 4, 2, args, discrete=discrete)
    agent = make_ppo((16, 16), 4, 2, args, discrete=discrete, a2c=True)
    assert agent.name == ('AgentDiscreteA2C' if discrete else 'AgentA2C')
    args.use_fused_update = True
    with pytest.raises(ValueError, match='use_fused_update=True requires'):
        make_ppo((16, 16), 4, 2, args, discrete=discrete, a2c=True)
