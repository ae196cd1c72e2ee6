"""Environment protocol (counterpart of ``elegantrl_tpu/envs/base.py``).

The JAX package writes an env as pure functions over ONE instance and
vectorises them with ``vmap``.  Here the functions take the whole batch:
the state is a NamedTuple of ``(N,)`` tensors, and ``vec_step`` applies the
masked auto-reset on ``terminal | truncate`` with ``torch.where``.
Randomness comes from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

EnvState = Any  # NamedTuple of (N, ...) tensors


class EnvSpec(NamedTuple):
    """The six protocol attributes every env exposes."""
    env_name: str
    num_envs: int
    max_step: int
    state_dim: int
    action_dim: int
    if_discrete: bool


class EnvDef(NamedTuple):
    """A batched functional environment.

    init: (gen, num_envs, device) -> env_state
    obs:  env_state -> (N, state_dim) observation
    step: (env_state, action, gen) -> (env_state', reward, terminal, truncate);
          ``action`` is ``(N, A)`` floats, or ``(N,)`` indices when discrete;
          ``gen`` feeds the env's own randomness (PointChasing's walker)

    ``step`` does not reset; :func:`vec_step` applies the auto-reset.

    ``batched=True`` (host pools and external sims, ``envs/host_env.py``,
    ``envs/isaac.py``): ``init`` and ``step`` take the whole batch and reset
    done instances themselves --
      init(gen, num_envs, device) -> (state, obs)
      step(state, actions, gen) -> (state, obs, rewards, terminals, truncates)
    """
    spec: EnvSpec
    init: Callable[[torch.Generator, int, torch.device], EnvState]
    obs: Callable[[EnvState], torch.Tensor]
    step: Callable[..., Tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor]]
    # optional: env_state -> (N,) episode return read at episode end in
    # place of the summed reward (the stock env's cumulative return)
    episode_return: Any = None
    # optional: the env's own fused-rollout body (ops/fused_rollout.py
    # KernelEnvBody), for an env whose body depends on its arguments and
    # data (the stock env's market tables); parameter-free envs register in
    # KERNEL_ENV_BODIES instead
    kernel_body: Any = None
    # whole-batch init/step with their own auto-reset (see above)
    batched: bool = False
    # optional () -> EnvDef making an INDEPENDENT instance: a host env owns a
    # stateful pool, and the evaluator must not reset or resize the
    # training pool mid-run, so it builds its own through this
    fresh: Any = None
    # host envs only: the stateful pool itself (``reset_all``, ``step``), which
    # the runner's host-rollout mode and the evaluator's host path step
    # directly
    host_pool: Any = None


def vec_reset(env: EnvDef, gen: torch.Generator, num_envs: int,
              device: torch.device) -> Tuple[EnvState, torch.Tensor]:
    """Initialise ``num_envs`` instances; returns (state, obs)."""
    if env.batched:
        return env.init(gen, num_envs, device)
    state = env.init(gen, num_envs, device)
    return state, env.obs(state)


def vec_step(env: EnvDef, state: EnvState, actions: torch.Tensor,
             gen: torch.Generator
             ) -> Tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Step all instances and auto-reset the done ones.

    Returns ``(state', obs', rewards, terminals, truncates)``; ``obs'``
    observes the post-reset state for done instances."""
    if env.batched:
        return env.step(state, actions, gen)
    num_envs = state[0].shape[0]
    s2, reward, terminal, truncate = env.step(state, actions, gen)
    done = terminal | truncate
    fresh = env.init(gen, num_envs, s2[0].device)
    s3 = type(s2)(*[torch.where(done.reshape((-1,) + (1,) * (old.dim() - 1)), new, old)
                    for new, old in zip(fresh, s2)])
    return s3, env.obs(s3), reward, terminal, truncate


class VecEnv:
    """Stateful adapter with the ``reset/step`` protocol over an
    :class:`EnvDef`, holding the state and a generator between calls.

    ``device`` is where ``reset`` and ``step`` run: the CUDA card unless the
    caller asks for ``'cpu'`` (None means ``'cuda'``), as for ``Config``.
    The generator and the state are made on the first ``reset``, through
    ``config.resolve_device``, so without a GPU that call raises; building
    an env only to read ``._def`` or its spec touches no device."""

    def __init__(self, env_def: EnvDef, num_envs: int = None, seed: int = 0,
                 device: str = None):
        self._def = env_def
        spec = env_def.spec
        if num_envs is not None:
            spec = spec._replace(num_envs=num_envs)
        self.spec = spec
        self.env_name = spec.env_name
        self.num_envs = spec.num_envs
        self.max_step = spec.max_step
        self.state_dim = spec.state_dim
        self.action_dim = spec.action_dim
        self.if_discrete = spec.if_discrete
        self.device = torch.device('cuda' if device is None else device)
        self._seed = int(seed)
        self._gen = None
        self._state = None

    def reset(self, **_kwargs):
        if self._gen is None:
            from ..config import resolve_device
            resolve_device(self, owner=type(self).__name__)
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(self._seed)
        self._state, obs = vec_reset(self._def, self._gen, self.num_envs, self.device)
        return obs, {}

    def step(self, actions):
        actions = torch.as_tensor(actions, device=self.device)
        actions = actions.to(torch.int32 if self.if_discrete else torch.float32)
        self._state, obs, rewards, terminals, truncates = vec_step(
            self._def, self._state, actions, self._gen)
        return obs, rewards, terminals, truncates, {}
