"""Isaac Gym-style adapter: external batched simulators in the training
loop (counterpart of ``elegantrl_tpu/envs/isaac.py``).

Any object with the VecTask surface plugs in:

- attributes ``num_envs`` and either ``num_obs``/``num_actions`` (Isaac) or
  ``observation_space``/``action_space`` (gym.vector);
- ``reset() -> obs``, a tensor or an Isaac-style dict holding one (key
  ``'obs'``);
- ``step(actions) -> (obs, rewards, dones, info)``, which resets done
  sub-envs itself (the Isaac convention); ``info['time_outs']``, where
  given, marks the dones that are truncations.

:func:`make_isaac_env` wraps it as a ``batched`` :class:`EnvDef` whose
``host_pool`` is an :class:`ExternalSimPool`, the path the runner's
host-rollout mode and the evaluator's host path step.  The sim's tensors
stay torch tensors: its outputs come back on the run's device
(``torch.as_tensor(x, device=...)``), so a CUDA sim feeding a run on the
same card pays no host copy, and the actions go to the sim on the device
its own obs live on.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from .base import EnvDef, EnvSpec


class SimUnavailable(ImportError):
    """Raised when the optional external simulator package is absent."""


def _obs_tensor(x):
    """An Isaac obs dict's tensor ({'obs': tensor, ...}), or ``x``."""
    if isinstance(x, dict):
        x = x['obs'] if 'obs' in x else next(iter(x.values()))
    return x


def _sim_dims(sim) -> tuple:
    """(num_envs, obs_dim, action_dim, if_discrete, max_step) from the Isaac
    attributes or the gym spaces."""
    num_envs = int(sim.num_envs)
    if hasattr(sim, 'num_obs'):
        obs_dim = int(sim.num_obs)
    else:
        obs_dim = int(np.prod(sim.observation_space.shape[-1:]))
    if hasattr(sim, 'num_actions'):
        action_dim, if_discrete = int(sim.num_actions), False
    else:
        space = sim.action_space
        if hasattr(space, 'n'):
            action_dim, if_discrete = int(space.n), True
        else:
            action_dim, if_discrete = int(space.shape[-1]), False
    max_step = int(getattr(sim, 'max_episode_length', 1000))
    return num_envs, obs_dim, action_dim, if_discrete, max_step


class ExternalSimPool:
    """One stateful external simulator stepped as a whole batch (the
    batched-sim counterpart of ``host_env._HostPool``): ``reset_all(num_envs,
    device) -> obs`` and ``step(actions) -> (obs, rewards, terminals,
    truncates)``, all tensors on the run's device (``device_native``).
    Narrower batches (the evaluator's episode count) ride the first sub-envs:
    the actions are padded with zeros to the sim's width and the outputs
    narrowed."""

    device_native = True

    def __init__(self, sim_fn: Callable[[], Any]):
        self.sim_fn = sim_fn
        self.sim = None
        self.device = None       # where the outputs go (the run's device)
        self.sim_device = None   # where the sim's own obs live

    def _ensure(self):
        if self.sim is None:
            self.sim = self.sim_fn()
        return self.sim

    def _out(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(_obs_tensor(x), device=self.device).to(dtype)

    def reset_all(self, num_envs, device=None) -> torch.Tensor:
        sim = self._ensure()
        want = int(num_envs)
        assert want <= int(sim.num_envs), (
            f'external sim is built for {sim.num_envs} envs; asked for {want} -- set '
            f'args.num_envs to at most that (or build the sim wider through its sim_fn)')
        obs = _obs_tensor(sim.reset())
        if isinstance(obs, torch.Tensor):
            self.sim_device = obs.device
        if device is not None:
            self.device = torch.device(device)
        elif self.device is None:
            self.device = self.sim_device or torch.device('cpu')
        return self._out(obs, torch.float32)[:want]

    def step(self, actions):
        sim = self.sim
        a = torch.as_tensor(actions, device=self.sim_device)
        n = a.shape[0]
        if n < int(sim.num_envs):
            a = torch.cat([a, a.new_zeros((int(sim.num_envs) - n,) + a.shape[1:])])
        obs, rewards, dones, info = sim.step(a)
        obs, rewards = self._out(obs, torch.float32), self._out(rewards, torch.float32)
        dones = self._out(dones, torch.bool)
        # Isaac's one `dones` flag, and info['time_outs'] marking the dones
        # that are truncations (episode-length limits)
        if isinstance(info, dict) and 'time_outs' in info:
            truncates = dones & self._out(info['time_outs'], torch.bool)
        else:
            truncates = torch.zeros_like(dones)
        terminals = dones & ~truncates
        return obs[:n], rewards[:n], terminals[:n], truncates[:n]


def make_isaac_env(sim_fn: Callable[[], Any], env_name: str = 'IsaacVecTask',
                   spec: Optional[EnvSpec] = None, share_sim: bool = False) -> EnvDef:
    """Wrap ``sim_fn() -> external batched sim`` as a ``batched``
    :class:`EnvDef`.  The sim is built at the first reset; without ``spec``
    it is probed from one construction.  ``fresh()`` builds an independent
    sim for the evaluator; ``share_sim=True`` (a sim that cannot be built
    twice in a process) shares the training one instead."""
    pool = ExternalSimPool(sim_fn)
    if spec is None:
        num_envs, obs_dim, action_dim, if_discrete, max_step = _sim_dims(pool._ensure())
        spec = EnvSpec(env_name=env_name, num_envs=num_envs, max_step=max_step,
                       state_dim=obs_dim, action_dim=action_dim, if_discrete=if_discrete)

    def init(gen, num_envs: int, device):
        del gen
        obs = pool.reset_all(num_envs, device)
        return torch.zeros(num_envs, dtype=torch.int32, device=obs.device), obs

    def step(state, actions, gen):
        del gen
        return (state, *pool.step(actions))

    fresh = (None if share_sim else
             lambda: make_isaac_env(sim_fn, env_name=env_name, spec=spec, share_sim=share_sim))
    return EnvDef(spec=spec, init=init, obs=None, step=step, batched=True, fresh=fresh,
                  host_pool=pool)


class IsaacVecEnv:
    """The six protocol attributes and ``reset()``/``step()`` over an external
    batched sim, for interactive use and ``get_gym_env_args``; outputs on
    ``device`` (default: the sim's own).  Training uses
    :func:`make_isaac_env`."""

    def __init__(self, sim_fn: Callable[[], Any], env_name: str = 'IsaacVecTask',
                 device: Optional[str] = None):
        self.pool = ExternalSimPool(sim_fn)
        sim = self.pool._ensure()
        (self.num_envs, self.state_dim, self.action_dim,
         self.if_discrete, self.max_step) = _sim_dims(sim)
        self.env_name = env_name
        self.device = device

    def reset(self):
        return self.pool.reset_all(self.num_envs, self.device), {}

    def step(self, actions):
        obs, rewards, terminals, truncates = self.pool.step(actions)
        return obs, rewards, terminals, truncates, {}


def mock_vectask(num_envs: int, device=None):
    """A point-mass reach task with the VecTask surface (the JAX package's
    ``examples/plan_Isaac_Gym.py`` mock, its tensors on ``device``: None is
    the card, as for ``Config``, and without a GPU it raises, naming
    ``device='cpu'``; a device given is taken as given): obs and
    actions 2-D, an obs dict, reward ``-distance``, the sub-envs that reach
    the target or run 40 steps re-spawned inside ``step``, and
    ``info['time_outs']`` marking the time-outs.  Scripted optimum about
    -2.3 a 40-step episode, random about -30."""
    from types import SimpleNamespace

    from ..config import resolve_device
    if device is None:
        device = resolve_device(SimpleNamespace(device='cuda'), owner='mock_vectask')

    class MockVecTask:
        def __init__(self):
            self.num_envs, self.num_obs, self.num_actions = num_envs, 2, 2
            self.max_episode_length = 40
            self._g = torch.Generator(device=device).manual_seed(0)
            self._pos = torch.zeros((num_envs, 2), device=device)
            self._t = torch.zeros(num_envs, dtype=torch.long, device=device)

        def _spawn(self, mask):
            fresh = torch.rand((self.num_envs, 2), generator=self._g, device=device) * 2.0 - 1.0
            self._pos = torch.where(mask[:, None], fresh, self._pos)
            self._t = torch.where(mask, torch.zeros_like(self._t), self._t)

        def reset(self):
            self._spawn(torch.ones(self.num_envs, dtype=torch.bool, device=device))
            return {'obs': self._pos.clone()}

        def step(self, actions):
            actions = torch.as_tensor(actions, device=device).clamp(-1.0, 1.0)
            self._pos = self._pos + 0.1 * actions
            self._t = self._t + 1
            dist = self._pos.norm(dim=-1)
            reached = dist < 0.1
            timeout = self._t >= self.max_episode_length
            dones = reached | timeout
            self._spawn(dones)
            return {'obs': self._pos.clone()}, -dist, dones, {'time_outs': timeout & ~reached}

    return MockVecTask()


def load_isaac_task(task_name: str, env_num: Optional[int] = None, **task_kwargs) -> EnvDef:
    """An :class:`EnvDef` over a real Isaac Gym task where the CUDA-only
    ``isaacgymenvs`` package is installed (``env_num`` becomes its
    ``num_envs``); raises :class:`SimUnavailable` otherwise."""
    try:
        import isaacgymenvs  # noqa: F401
    except ImportError as e:
        raise SimUnavailable(
            'isaacgymenvs is not installed (CUDA-only). Wrap your own batched simulator '
            'with make_isaac_env(sim_fn) instead -- any object with reset()/step() over '
            'whole-batch tensors works.') from e

    def sim_fn():
        kwargs = dict(task_kwargs)
        if env_num is not None:
            kwargs['num_envs'] = env_num
        return isaacgymenvs.make(task=task_name, **kwargs)

    return make_isaac_env(sim_fn, env_name=f'Isaac:{task_name}')
