"""The Isaac Gym-style adapter of the port (``elegantrl_tpu_torch/envs/
isaac.py``) against the JAX package's, on the mock VecTask of
``examples/plan_Isaac_Gym.py`` (torch tensors, an obs dict, auto-reset and
``info['time_outs']``): the done split (a time-out is a truncation, a reach
a termination) and the narrowing to fewer envs than the sim holds, exactly
equal; the sim's tensors kept as tensors on the run's device; one
``train_agent`` round through ``make_isaac_env`` on the CPU; and
``load_isaac_task`` raising ``SimUnavailable`` without ``isaacgymenvs``.
"""
import os
import sys

import numpy as np
import pytest
import torch

from elegantrl_tpu.envs.isaac import ExternalSimPool as JExternalSimPool
from elegantrl_tpu_torch import (Config, IsaacVecEnv, SimUnavailable, load_isaac_task,
                                 make_isaac_env, train_agent)
from elegantrl_tpu_torch.agents import AgentPPO
from elegantrl_tpu_torch.envs.base import vec_reset, vec_step
from elegantrl_tpu_torch.envs.isaac import ExternalSimPool

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, 'examples'))
from plan_Isaac_Gym import _mock_vectask  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize('width', [6, 4])
def test_sim_pool_done_split_and_narrowing_match_jax(width):
    """Two mock sims of 6 envs from one seed, stepped at ``width`` envs with
    the same actions: obs, rewards, terminals and truncates equal, the
    narrower batch padded into the sim and narrowed back."""
    jpool = JExternalSimPool(lambda: _mock_vectask(6))
    pool = ExternalSimPool(lambda: _mock_vectask(6))
    obs = pool.reset_all(width, 'cpu')
    assert isinstance(obs, torch.Tensor) and obs.dtype == torch.float32
    np.testing.assert_array_equal(obs.numpy(), jpool.reset_all(np.int32(width)))
    rng = np.random.default_rng(1)
    flags = np.zeros(2, int)
    for _ in range(60):
        a = rng.uniform(-1, 1, (width, 2)).astype(np.float32)
        a[:2] = np.clip(-5.0 * obs[:2].numpy(), -1, 1)    # two envs head for the target
        got, want = pool.step(torch.from_numpy(a)), jpool.step(a)
        obs = got[0]
        for x, y in zip(got, want):
            assert x.shape[0] == width
            np.testing.assert_array_equal(x.numpy(), y)
        flags += [int(want[2].sum()), int(want[3].sum())]
        assert not bool((got[2] & got[3]).any())
    assert flags.min() > 0, flags           # both kinds of done occurred


def test_isaac_env_batched_contract_and_vec_env():
    env = make_isaac_env(lambda: _mock_vectask(8), env_name='MockVecTask-v0')
    assert env.spec.state_dim == 2 and env.spec.max_step == 40 and env.batched
    assert env.fresh().host_pool is not env.host_pool
    state, obs = vec_reset(env, None, 8, torch.device('cpu'))
    assert obs.shape == (8, 2) and obs.device.type == 'cpu'
    state, obs, r, term, trunc = vec_step(env, state, torch.zeros((8, 2)), None)
    assert r.shape == (8,) and term.dtype == trunc.dtype == torch.bool
    v = IsaacVecEnv(lambda: _mock_vectask(8))
    assert (v.num_envs, v.state_dim, v.action_dim, v.if_discrete, v.max_step) == (8, 2, 2, False,
                                                                                   40)
    obs, _ = v.reset()
    assert obs.shape == (8, 2)
    with pytest.raises(SimUnavailable):
        load_isaac_task('Ant')


def test_train_agent_round_through_make_isaac_env(tmp_path):
    env = make_isaac_env(lambda: _mock_vectask(16), env_name='MockVecTask-v0')
    args = Config(AgentPPO, env, {'env_name': 'MockVecTask-v0', 'num_envs': 16, 'max_step': 40,
                                  'state_dim': 2, 'action_dim': 2, 'if_discrete': False})
    args.device, args.net_dims, args.horizon_len = 'cpu', (16, 16), 40
    args.batch_size, args.repeat_times, args.reward_scale, args.gamma = 64, 2.0, 4.0, 0.95
    args.eval_per_step, args.eval_times, args.break_step = 640, 2, 640
    args.cwd = str(tmp_path / 'isaac')
    r = train_agent(args)
    assert r['total_step'] >= 640 and r['recorder'].shape[0] == 2
    assert np.isfinite(r['recorder']).all()
