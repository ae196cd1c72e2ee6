"""Agent abstraction (counterpart of ``elegantrl_tpu/agents/base.py``).

An agent is a bundle of functions over an agent state, made by a
``make_*`` factory from the config.  Rollouts are time-major
``(H, N, ...)`` tensors with ``undones = 1 - terminal`` and
``unmasks = 1 - truncate``.

The optimizer is written out by hand as optax's
``chain(clip_by_global_norm(c), adam(lr, 0.9, 0.999, eps=1e-8))``:
``g`` is kept when its global norm is below ``c`` and scaled by
``c / norm`` otherwise (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to
the norm, so it is not used), and the bias corrections are
``1 - beta**count`` with ``count`` counting from 1.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..envs.base import EnvDef, vec_step


class Rollout(NamedTuple):
    """One exploration segment:
    states   (H, N, S), or (H, S, N) when ``extras`` holds the 'tsn' marker
    actions  (H, N, A), or (H, A, N) likewise
    logprobs (H, N)
    rewards  (H, N), already multiplied by reward_scale
    undones  (H, N) float, 1 - terminal
    unmasks  (H, N) float, 1 - truncate
    extras   dict: 'values' (H, N) critic values computed while collecting,
             and 'tsn' (a marker) for the kernel-native layout
    """
    states: torch.Tensor
    actions: torch.Tensor
    logprobs: Optional[torch.Tensor]
    rewards: torch.Tensor
    undones: torch.Tensor
    unmasks: torch.Tensor
    extras: Any = None


class AgentDef(NamedTuple):
    """An agent.  ``update`` differs by family:

    on-policy:  ``update(agent_state, rollout, last_obs, gen, ids=None)
                -> (agent_state, metrics)``
    off-policy: ``update(agent_state, buf_state, gen, ids=None, noise=None)
                -> (agent_state, buf_state, metrics)``

    ``state_to_numpy``/``state_from_numpy(tree, device)`` carry the agent
    state to and from the JAX package's nesting (``utils/jax_params.py``),
    which the checkpoints keep.  Off-policy only: ``cum_returns(agent_state,
    rollout, last_obs) -> (H, N)`` the rollout's discounted returns for the
    buffer's cumulative-return column, ``pre_update(agent_state, rollout,
    last_obs) -> agent_state`` a hook the runner calls before the insert
    (the H-term window harvest)."""
    name: str
    if_off_policy: bool
    if_discrete: bool
    init: Callable[[int, torch.device], Any]   # (seed, device) -> state
    explore_action: Callable[[Any, torch.Tensor, torch.Generator],
                             Tuple[torch.Tensor, Optional[torch.Tensor]]]
    greedy_action: Callable[[Any, torch.Tensor], torch.Tensor]
    env_action: Callable[[torch.Tensor], torch.Tensor]
    update: Callable[..., Tuple[Any, ...]]
    rollout_extras: Any = None
    state_to_numpy: Callable[[Any], Any] = None
    state_from_numpy: Callable[[Any, Any], Any] = None
    cum_returns: Any = None
    pre_update: Any = None


class AdamState(NamedTuple):
    """optax ``ScaleByAdamState`` over one flat parameter buffer."""
    count: int
    mu: torch.Tensor
    nu: torch.Tensor


class ClipAdam(NamedTuple):
    """Hyper-parameters of ``make_optimizer``'s clip-then-Adam chain."""
    lr: float
    clip_grad_norm: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, flat: torch.Tensor) -> AdamState:
        return AdamState(0, torch.zeros_like(flat), torch.zeros_like(flat))


def make_optimizer(learning_rate: float, clip_grad_norm: float) -> ClipAdam:
    return ClipAdam(float(learning_rate), float(clip_grad_norm))


def clip_adam_(opt: ClipAdam, params: torch.Tensor, mu: torch.Tensor,
               nu: torch.Tensor, grads: torch.Tensor, count: int) -> None:
    """One optax clip-by-global-norm + Adam step, in place on flat
    buffers; ``count`` is the step number after increment (>= 1)."""
    clip_adam_bc_(opt, params, mu, nu, grads, 1.0 - opt.b1 ** count, 1.0 - opt.b2 ** count)


def clip_adam_bc_(opt: ClipAdam, params: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                  grads: torch.Tensor, bc1, bc2) -> None:
    """:func:`clip_adam_` with the bias corrections ``bc1 = 1 - b1**count``
    and ``bc2 = 1 - b2**count`` given (the off-policy chunks take them from
    a per-step table)."""
    gn = torch.sqrt(torch.sum(torch.square(grads)))
    scale = torch.where(gn < opt.clip_grad_norm, torch.ones_like(gn),
                        opt.clip_grad_norm / gn)
    g = grads * scale
    mu.mul_(opt.b1).add_((1.0 - opt.b1) * g)
    nu.mul_(opt.b2).add_((1.0 - opt.b2) * torch.square(g))
    params.sub_(opt.lr * (mu / bc1) / (torch.sqrt(nu / bc2) + opt.eps))


def grad_step(opt: ClipAdam, params: torch.Tensor, state: AdamState,
              grads: torch.Tensor) -> AdamState:
    """Apply one step in place to ``params``; returns the new state."""
    count = state.count + 1
    clip_adam_(opt, params, state.mu, state.nu, grads, count)
    return AdamState(count, state.mu, state.nu)


def collect_rollout(env: EnvDef, agent_state: Any, explore_action: Callable,
                    env_action: Callable, env_state: Any, obs: torch.Tensor,
                    gen: torch.Generator, horizon_len: int, reward_scale: float,
                    extras_fn: Optional[Callable] = None,
                    store_dtype: Optional[torch.dtype] = None,
                    ) -> Tuple[Rollout, Any, torch.Tensor]:
    """Actor inference + env step, ``horizon_len`` times.  Stores the raw
    sampled action (pre-tanh for PPO; the int32 index, without a feature
    axis, for a discrete agent) and its logprob (None for an off-policy
    agent, whose ``explore_action`` returns none).  ``store_dtype``
    (bfloat16) stores the states in that type, and the policy acts on the
    rounded obs, so the stored state is the one acted on (the JAX package's
    quantise-before-act); float actions are stored in it too where no
    logprob is kept (off-policy).  Returns (rollout, env_state, obs)."""
    states, actions, logprobs, rewards, undones, unmasks, extras = ([] for _ in range(7))
    with torch.no_grad():
        for _ in range(horizon_len):
            if store_dtype is not None:   # round BEFORE acting
                obs = obs.to(store_dtype).to(obs.dtype)
            action, logprob = explore_action(agent_state, obs, gen)
            if extras_fn is not None:
                extras.append(extras_fn(agent_state, obs))
            env_state, next_obs, reward, terminal, truncate = vec_step(
                env, env_state, env_action(action), gen)
            store_act = action
            if store_dtype is not None and logprob is None and action.is_floating_point():
                store_act = action.to(store_dtype)
            states.append(obs if store_dtype is None else obs.to(store_dtype))
            actions.append(store_act)
            logprobs.append(logprob)
            rewards.append(reward)
            undones.append(~terminal)
            unmasks.append(~truncate)
            obs = next_obs
    extra = None
    if extras:
        extra = {k: torch.stack([e[k] for e in extras]) for k in extras[0]}
    rollout = Rollout(
        states=torch.stack(states), actions=torch.stack(actions),
        logprobs=None if logprobs[0] is None else torch.stack(logprobs),
        rewards=torch.stack(rewards) * reward_scale,
        undones=torch.stack(undones).float(), unmasks=torch.stack(unmasks).float(),
        extras=extra)
    return rollout, env_state, obs


def resolve_storage_dtype(args) -> Optional[torch.dtype]:
    """``args.storage_dtype`` as the rollout's and replay ring's bulk type:
    ``torch.bfloat16`` for 'bfloat16', None (float32) otherwise, as the JAX
    package's ``resolve_storage_dtype``."""
    return (torch.bfloat16 if str(getattr(args, 'storage_dtype', 'float32')) == 'bfloat16'
            else None)


def sample_flat_ids(gen: torch.Generator, horizon: int, num_seqs: int,
                    batch_size: int, num_batches: int, device) -> torch.Tensor:
    """Uniform flat ids over ``horizon * num_seqs``, ``(num_batches,
    batch_size)``; :func:`split_flat_ids` maps them to (t, env)."""
    return torch.randint(0, horizon * num_seqs, (num_batches, batch_size),
                         generator=gen, device=device)


def split_flat_ids(ids: torch.Tensor, horizon: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ids0 = ids % H``, ``ids1 = ids // H``."""
    return ids % horizon, ids // horizon
