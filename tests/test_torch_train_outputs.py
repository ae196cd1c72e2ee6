"""What ``train_agent`` (``elegantrl_tpu_torch/train/runner.py``) leaves
behind and reads, as the JAX package's ``train_agent`` does
(``elegantrl_tpu/train/runner.py``):

- an off-policy run writes ``train_carry.npz`` (its replay ring included)
  only when it is resumable (``if_save_buffer`` or ``continue_train``);
- ``eval_env_class``/``eval_env_args`` choose the evaluation env;
- a resumable run writes the carry every ``save_gap`` evaluation periods, and
  a run stopped mid-way resumes from it to the same result;
- ``LearningCurve.jpg``, the discrete action histogram on the eval line and
  ``recorder_times`` in the result.
"""
import os
import shutil

import numpy as np
import torch

from elegantrl_tpu_torch import Config, build_training, train_agent
from elegantrl_tpu_torch.agents import AgentDiscretePPO, AgentPPO, AgentTD3
from elegantrl_tpu_torch.envs import CartPoleEnv, PendulumEnv
from elegantrl_tpu_torch.utils.checkpoint import tree_leaves

torch.set_num_threads(1)
PENDULUM = {'env_name': 'Pendulum-v1', 'num_envs': 4, 'max_step': 200, 'state_dim': 3,
            'action_dim': 1, 'if_discrete': False}


def _args(agent_class, env_class, env_args, cwd, **kw):
    a = Config(agent_class, env_class, dict(env_args))
    a.device, a.cwd, a.net_dims, a.random_seed, a.eval_times = 'cpu', str(cwd), (16, 16), 0, 2
    for k, v in kw.items():
        setattr(a, k, v)
    return a


def test_offpolicy_run_writes_no_carry_unless_resumable(tmp_path):
    args = _args(AgentTD3, PendulumEnv, PENDULUM, tmp_path / 'td3', horizon_len=50,
                 batch_size=32, buffer_size=400, eval_per_step=200, break_step=200)
    train_agent(args)
    names = os.listdir(args.cwd)
    assert 'agent.npz' in names and 'train_carry.npz' not in names


class _EvalPendulum(PendulumEnv):
    """A Pendulum whose ``init`` counts its calls, as an evaluation env; at
    the evaluation ``stop_at`` it keeps a copy of the run's carry file as it
    then stands and writes the ``stop`` file."""
    calls, stop_at, cwd = [], None, None

    def __init__(self, **kw):
        super().__init__(**kw)
        d = self._def
        cls = type(self)

        def init(gen, n, device):
            cls.calls.append(n)
            if cls.stop_at is not None and len(cls.calls) == cls.stop_at:
                carry = os.path.join(cls.cwd, 'train_carry.npz')
                if os.path.exists(carry):
                    shutil.copy(carry, os.path.join(cls.cwd, '..', 'mid_carry.npz'))
                open(os.path.join(cls.cwd, 'stop'), 'w').close()
            return d.init(gen, n, device)

        self._def = d._replace(init=init)


def test_eval_env_class_is_the_one_evaluated(tmp_path):
    _EvalPendulum.calls, _EvalPendulum.stop_at = [], None
    args = _args(AgentPPO, PendulumEnv, PENDULUM, tmp_path / 'ppo', horizon_len=16,
                 batch_size=32, eval_per_step=64, break_step=128, eval_times=3,
                 eval_env_class=_EvalPendulum, eval_env_args=dict(PENDULUM, num_envs=3))
    out = train_agent(args)
    assert out['recorder'].shape[0] == 3 and _EvalPendulum.calls == [3, 3, 3]


def test_stopped_run_resumes_from_the_mid_run_carry(tmp_path):
    """``save_gap=1`` with ``if_save_buffer``: the carry is on disk after
    every period.  The run stops during its third period (the ``stop``
    file); resuming from the carry of period 2, as a run killed there would,
    reproduces period 3 exactly."""
    cwd = tmp_path / 'run'
    _EvalPendulum.calls, _EvalPendulum.stop_at, _EvalPendulum.cwd = [], 3, str(cwd)

    def args_for(resume):
        return _args(AgentPPO, PendulumEnv, PENDULUM, cwd, horizon_len=16, batch_size=32,
                     eval_per_step=64, break_step=10 ** 6, save_gap=1, if_save_buffer=True,
                     continue_train=resume, eval_env_class=_EvalPendulum)

    train_agent(args_for(False))
    assert len(_EvalPendulum.calls) == 3
    with np.load(os.path.join(cwd, 'agent.npz')) as data:   # leaves in saved order
        final = [data[k] for k in sorted(data.files, key=lambda k: int(k.split('|')[0]))]
    shutil.copy(tmp_path / 'mid_carry.npz', cwd / 'train_carry.npz')   # killed after period 2
    os.remove(cwd / 'stop')
    ctx = build_training(args_for(True))
    carry, _ = ctx.round_fn(ctx.carry)
    resumed = tree_leaves(ctx.agent.state_to_numpy(carry.agent_state))
    assert len(resumed) == len(final)
    for a, b in zip(resumed, final):
        np.testing.assert_array_equal(a, b)


def test_run_outputs(tmp_path, capsys):
    """``LearningCurve.jpg``, the action histogram of a discrete agent on the
    eval line (the fractions of each action in the period's rollouts) and
    ``recorder_times``."""
    env_args = {'env_name': 'CartPole-v1', 'num_envs': 8, 'max_step': 500, 'state_dim': 4,
                'action_dim': 2, 'if_discrete': True}
    args = _args(AgentDiscretePPO, CartPoleEnv, env_args, tmp_path / 'cp', horizon_len=16,
                 batch_size=32, eval_per_step=128, break_step=128)
    out = train_agent(args)
    assert os.path.isfile(os.path.join(args.cwd, 'LearningCurve.jpg'))
    assert out['recorder_times'].shape == (2,) and np.all(np.diff(out['recorder_times']) >= 0)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ' a:' in ln]
    assert len(lines) == 2
    fracs = [float(x) for x in lines[0].split(' a:')[1].split()]
    assert len(fracs) == 2 and abs(sum(fracs) - 1.0) < 0.02
