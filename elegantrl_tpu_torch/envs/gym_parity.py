"""Host-env factories for gymnasium's benchmark suites (counterpart of
``elegantrl_tpu/envs/gym_parity.py``): the real Box2D and MuJoCo physics
through :mod:`.host_env`, the cases the reference reaches through
``gym.make``::

    env = gym_env_def('LunarLanderContinuous-v3')
    args = Config(AgentModSAC, env, get_env_args(env))

gymnasium (and Box2D or mujoco for their envs) is imported when a factory
is called, with a clean error where it is absent.
"""

from __future__ import annotations

from .base import EnvDef, EnvSpec
from .host_env import make_host_env


def _require_gym():
    try:
        import gymnasium
        return gymnasium
    except ImportError as e:
        raise ImportError(
            "gymnasium is required for host-env physics parity; the tensor envs "
            "(PendulumEnv, LunarLanderEnv, HopperEnv, ...) need no extra packages.") from e


def _resolve_env_id(gym, env_id: str) -> str:
    """Accept version-less or stale-version ids (the reference's '-v2' where
    gymnasium registers '-v3'): the newest registered version of the base."""
    registry = gym.envs.registry
    if env_id in registry:
        return env_id
    base = env_id.rsplit('-v', 1)[0]
    versions = sorted((int(k.rsplit('-v', 1)[1]), k) for k in registry
                      if k.rsplit('-v', 1)[0] == base and '-v' in k)
    if versions:
        return versions[-1][1]
    return env_id   # gym.make raises its own error


def gym_env_def(env_id: str, seed: int = 0, num_threads: int = 0, **make_kwargs) -> EnvDef:
    """Any gymnasium env id as a batched host :class:`EnvDef`
    (``num_threads``: step the pool on threads, for envs whose C core
    releases the GIL)."""
    gym = _require_gym()
    env_id = _resolve_env_id(gym, env_id)
    probe = gym.make(env_id, **make_kwargs)
    try:
        if_discrete = isinstance(probe.action_space, gym.spaces.Discrete)
        action_dim = (int(probe.action_space.n) if if_discrete
                      else int(probe.action_space.shape[0]))
        state_dim = int(probe.observation_space.shape[0])
        max_step = int(getattr(probe, '_max_episode_steps', 1000) or 1000)
    finally:
        probe.close()
    spec = EnvSpec(env_name=env_id, num_envs=1, max_step=max_step, state_dim=state_dim,
                   action_dim=action_dim, if_discrete=if_discrete)
    return make_host_env(lambda: gym.make(env_id, **make_kwargs), spec, seed=seed,
                         num_threads=num_threads)


def get_env_args(env: EnvDef, num_envs: int = 1) -> dict:
    """``Config`` env_args for an :class:`EnvDef` (as ``get_gym_env_args``)."""
    s = env.spec
    return {'env_name': s.env_name, 'num_envs': num_envs, 'max_step': s.max_step,
            'state_dim': s.state_dim, 'action_dim': s.action_dim,
            'if_discrete': s.if_discrete}


def gym_lunar_lander_continuous(seed: int = 0) -> EnvDef:
    """Box2D LunarLanderContinuous."""
    return gym_env_def('LunarLanderContinuous-v3', seed=seed)


def gym_lunar_lander(seed: int = 0) -> EnvDef:
    """Box2D discrete LunarLander."""
    return gym_env_def('LunarLander-v3', seed=seed)


def gym_hopper(seed: int = 0, num_threads: int = 8) -> EnvDef:
    """MuJoCo Hopper, threaded by default (``mj_step`` releases the GIL)."""
    return gym_env_def('Hopper-v5', seed=seed, num_threads=num_threads)
