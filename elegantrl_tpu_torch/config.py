"""Training configuration (counterpart of ``elegantrl_tpu/config.py``).

Same hyper-parameter names and defaults as the JAX package's ``Config``,
plus ``device``: the entry points run on the CUDA card unless the caller
asks for ``'cpu'``.  Asking for ``'cuda'`` on a machine without a GPU raises;
nothing silently runs on the CPU.
"""

from __future__ import annotations

import inspect
import os
import shutil
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

# Agent-name fragments that mark an on-policy algorithm.
_ON_POLICY_NAMES = ("SARSA", "VPG", "A2C", "A3C", "TRPO", "PPO", "MPO")


class Config:
    """Environment args, algorithm hypers, device and evaluation cadence.
    Mutable, so scripts can attach extra per-algorithm hypers that the
    agents read with ``getattr(args, name, default)``."""

    def __init__(self, agent_class: Any = None, env_class: Any = None,
                 env_args: Optional[Dict[str, Any]] = None):
        self.agent_class = agent_class
        self.if_off_policy = self.get_if_off_policy()

        '''environment'''
        self.env_class = env_class
        self.env_args = env_args
        if env_args is None:
            env_args = {'env_name': None, 'num_envs': 1, 'max_step': 12345,
                        'state_dim': None, 'action_dim': None, 'if_discrete': None}
        env_args.setdefault('num_envs', 1)
        env_args.setdefault('max_step', 12345)
        self.env_name = env_args['env_name']
        self.num_envs = env_args['num_envs']
        self.max_step = env_args['max_step']
        self.state_dim = env_args['state_dim']
        self.action_dim = env_args['action_dim']
        self.if_discrete = env_args['if_discrete']

        '''reward shaping'''
        self.gamma = 0.99
        self.reward_scale = 2 ** 0

        '''training'''
        self.net_dims = (128, 128)
        self.learning_rate = 6e-5
        self.clip_grad_norm = 3.0
        self.state_value_tau = 0.0
        self.soft_update_tau = 5e-3
        self.continue_train = False
        if self.if_off_policy:
            self.batch_size = 64
            self.horizon_len = 512
            self.buffer_size = int(1e6)
            self.repeat_times = 1.0
            self.if_use_per = False
            self.lambda_fit_cum_r = 0.0
            self.buffer_init_size = self.batch_size * 8
        else:
            self.batch_size = 128
            self.horizon_len = 2048
            self.buffer_size = None
            self.repeat_times = 8.0
            self.if_use_vtrace = True
            self.buffer_init_size = None

        '''device'''
        self.device = 'cuda'         # 'cuda' | 'cuda:<i>' | 'cpu'
        self.gpu_id = 0
        self.num_workers = 1
        self.random_seed = None      # None -> derived from gpu_id
        # matmul dtype: 'auto' keeps float32 below hidden width 512, as the
        # JAX package does; the hand-written kernels take float32 only
        self.compute_dtype = 'auto'
        self.storage_dtype = 'float32'
        # kernel selection: 'auto' | True | False (see select_kernel).  On a
        # CUDA device a workload that the JAX package sends to a kernel takes
        # the port's kernel or raises; the plain versions run on the CPU only
        self.use_fused_rollout = 'auto'
        self.use_fused_update = 'auto'
        # the kernels of ops/kernels.py: the V-trace recursion (K10), the
        # replay gather (K11a) and the no-grad 3-linear MLP forward (K11b)
        self.use_gae_kernel = 'auto'
        self.use_gather_kernel = 'auto'
        self.use_mlp3_kernel = 'auto'

        '''evaluation'''
        self.cwd = None
        self.if_remove = True
        self.break_step = np.inf
        self.break_score = np.inf
        self.if_keep_save = True
        self.if_over_write = False
        self.if_save_buffer = False

        self.save_gap = 8
        self.eval_times = 3
        self.eval_per_step = int(2e4)
        self.eval_env_class = None
        self.eval_env_args = None
        self.eval_record_step = 0

    def init_before_training(self):
        if self.random_seed is None:
            self.random_seed = max(0, int(self.gpu_id))
        if self.continue_train:
            self.if_remove = False
        if self.cwd is None:
            agent_name = getattr(self.agent_class, '__name__', 'Agent')
            agent_name = agent_name[5:] if agent_name.startswith('Agent') else agent_name
            self.cwd = f'./{self.env_name}_{agent_name}_{self.random_seed}'
        if self.if_remove is None:   # ask, as the JAX package does
            self.if_remove = bool(input(f"| Config PRESS 'y' to REMOVE: {self.cwd}? ") == 'y')
        if self.if_remove:
            shutil.rmtree(self.cwd, ignore_errors=True)
            print(f"| Config Remove cwd: {self.cwd}", flush=True)
        else:
            print(f"| Config Keep cwd: {self.cwd}", flush=True)
        os.makedirs(self.cwd, exist_ok=True)

    def get_if_off_policy(self) -> bool:
        agent_name = getattr(self.agent_class, '__name__', '') or ''
        return all(agent_name.find(s) == -1 for s in _ON_POLICY_NAMES)

    def print_config(self):
        from pprint import pprint
        pprint(vars(self))


def resolve_device(args) -> torch.device:
    """``args.device`` as a ``torch.device``; raises when CUDA is asked for
    and no GPU is present."""
    device = torch.device(str(getattr(args, 'device', 'cuda')))
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f"Config.device={str(device)!r} but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return device


def select_kernel(args, flag: str, jax_takes_kernel: bool, port_fits: bool, device,
                  scope: str) -> bool:
    """Resolve the switch ``args.<flag>`` ('auto' | True | False) for one
    workload; returns whether the kernel's path is taken.

    The rule: wherever the JAX package on a TPU would take a Pallas kernel,
    the port on a card takes its kernel or raises; where the JAX package
    runs XLA ops, the port runs PyTorch ops.  So each caller passes two
    predicates: ``jax_takes_kernel``, the JAX package's own eligibility for
    this workload copied term by term, and ``port_fits``, whether the port's
    kernel takes these shapes (``scope`` says what it takes).

    - On a CUDA device, a workload the JAX package sends to a kernel takes
      the port's kernel; ``False``, or a workload the port's kernel does not
      fit, raises: nothing falls back to a plain version there.
    - A workload the JAX package runs as XLA ops runs PyTorch ops on either
      device, and the choice is printed; ``True`` asks for a kernel the JAX
      package would not take and raises, as in the JAX package.
    - On the CPU the wrappers run the plain versions when the kernel's path
      is taken.

    A2C's update has no kernel in either package (``agents/ppo.py``) and is
    never asked about here.

    The three kernels of ``elegantrl_tpu/ops/pallas_kernels.py`` (the
    V-trace recursion, the replay gather, the 3-layer MLP forward;
    ``use_gae_kernel``, ``use_gather_kernel``, ``use_mlp3_kernel``) are kept
    by the JAX package beside XLA forms of the same functions, with XLA as
    its default from a TPU measurement that says nothing of a card.  For
    them the port takes its kernel on a card wherever the kernel fits, and
    raises on ``False`` there, as for every other kernel: the caller passes
    the kernel's fit as both predicates (``ops/kernels.py:select``).  The
    fit is the only predicate: V-trace advantages (not plain GAE) for K10,
    any replay field for K11a, a 3-linear f32 MLP whose forward needs no
    gradient for K11b."""
    mode = getattr(args, flag, 'auto')
    off = mode in (False, 'false', '0')
    if not jax_takes_kernel:
        if mode is True:
            raise ValueError(f'{flag}=True requires {scope}')
        print(f'| {flag}: PyTorch path (the JAX package runs this workload as XLA ops; '
              f'the kernel takes {scope})', flush=True)
        return False
    if torch.device(device).type == 'cuda':
        if off:
            raise ValueError(f'{flag}=False asks for the plain PyTorch path, which runs on '
                             f'the CPU only; on {device} the kernel is the path')
        if not port_fits:
            raise ValueError(f'{flag}: on {device} the workload must fit the kernel '
                             f'({scope}); the plain version runs on the CPU only')
        return True
    if mode is True and not port_fits:
        raise ValueError(f'{flag}=True requires {scope}')
    return port_fits and not off


def kwargs_filter(function: Callable, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only the kwargs that ``function`` accepts."""
    sign = {p.name for p in inspect.signature(function).parameters.values()}
    return {k: kwargs[k] for k in sign.intersection(kwargs.keys())}


def build_env(env_class=None, env_args: Optional[Dict[str, Any]] = None, gpu_id: int = -1):
    """Instantiate an env from its class and kwargs and stamp the six
    protocol attributes onto it.  Vectorisation is the env's own batch
    axis; ``env_args['device']``, when given, places the env's tensors."""
    env_args = dict(env_args or {})
    env_args.setdefault('num_envs', 1)
    env_args.setdefault('max_step', 12345)
    env = env_class(**kwargs_filter(env_class.__init__, env_args.copy()))
    for attr in ('env_name', 'num_envs', 'max_step', 'state_dim', 'action_dim', 'if_discrete'):
        if env_args.get(attr) is not None:
            setattr(env, attr, env_args[attr])
    return env


def get_gym_env_args(env, if_print: bool = True) -> Dict[str, Any]:
    """The env-protocol dict of an env instance: one of the port's envs, or
    any gymnasium env."""
    if {'env_name', 'state_dim', 'action_dim', 'if_discrete'}.issubset(dir(env)):
        env_args = {'env_name': env.env_name,
                    'num_envs': getattr(env, 'num_envs', 1),
                    'max_step': getattr(env, 'max_step', 12345),
                    'state_dim': env.state_dim,
                    'action_dim': env.action_dim,
                    'if_discrete': env.if_discrete}
    else:  # gymnasium-style
        import gymnasium as gym
        env_name = getattr(env.unwrapped, 'spec').id
        max_step = getattr(env, '_max_episode_steps', 12345)
        state_shape = env.observation_space.shape
        state_dim = state_shape[0] if len(state_shape) == 1 else state_shape
        if_discrete = isinstance(env.action_space, gym.spaces.Discrete)
        action_dim = (env.action_space.n if if_discrete
                      else env.action_space.shape[0])
        env_args = {'env_name': env_name, 'num_envs': 1, 'max_step': max_step,
                    'state_dim': state_dim, 'action_dim': action_dim,
                    'if_discrete': if_discrete}
    if if_print:
        print(f"env_args = {repr(env_args)}")
    return env_args
