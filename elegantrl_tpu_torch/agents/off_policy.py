"""Shared off-policy update loop (counterpart of
``elegantrl_tpu/agents/off_policy.py``).

A round runs ``update_times = int32(f32(size) * repeat_times / batch_size)``
(at least 1) sequential minibatch updates, where ``size`` counts the ring's
filled time rows (reference ``AgentBase.update_net``).  The draws of every
update (minibatch ids or rows, TD3's smoothing noise) are made before the
loop, so the scan path here and the fused chunk path of the DQN and DDPG
agents consume the same draws; tests inject the JAX package's.  Under
prioritised replay each update samples from the tree as the previous update
left it, so the draws made before the loop are the stratified uniforms
``(U, N, sub)``, not ids.

Each agent supplies ``objectives_fn(agent_state, batch, noise, update_t) ->
(agent_state, (obj_critic, obj_actor, actor_updated), td)``: one critic +
actor step on one gathered :class:`Batch`.  ``actor_updated`` is 1.0 or
0.0, so a delayed or gated actor averages over the steps it took; ``td`` is
the per-sample TD error that PER writes back (None without PER).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


class Batch(NamedTuple):
    """One gathered minibatch.  ``is_weight``: PER's importance weights;
    ``cum_r``: the buffer's cumulative returns at the sampled rows
    (``lambda_fit_cum_r``); each None when unused."""
    state: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    undone: torch.Tensor
    unmask: torch.Tensor
    next_state: torch.Tensor
    is_weight: Optional[torch.Tensor] = None
    cum_r: Optional[torch.Tensor] = None


def offpolicy_update_times(size: int, repeat_times: float, batch_size: int) -> int:
    """``max(int32(f32(size) * repeat_times / batch_size), 1)`` in float32,
    as the JAX package computes it."""
    n = np.float32(size) * np.float32(repeat_times) / np.float32(batch_size)
    return max(int(np.float32(n)), 1)


def draws_at(draws, i: int):
    """Update ``i``'s share of a round's draws: ``draws[i]`` of a tensor,
    element-wise through (named) tuples, None kept."""
    if draws is None:
        return None
    if isinstance(draws, tuple):
        parts = [draws_at(d, i) for d in draws]
        return type(draws)(*parts) if hasattr(draws, '_fields') else tuple(parts)
    return draws[i]


def sample_batch(buffer, buf_state, batch_size: int, draw, row_sample: bool):
    """One minibatch for one update's ``draw`` (PER uniforms ``(N, sub)``,
    rows ``(R,)`` or flat ids ``(B,)``): ``(Batch, ids)``."""
    weights = None
    if buffer.tree is not None:
        *items, weights, ids = buffer.sample_for_per(buf_state, batch_size, u=draw)
    elif row_sample:
        *items, ids = buffer.sample_rows(buf_state, batch_size, rows=draw)
    else:
        *items, ids = buffer.sample(buf_state, batch_size, ids=draw)
    cum_r = None if buf_state.cum_rewards is None else buf_state.cum_rewards[ids]
    # a bf16 ring's states and actions, widened: the updates compute in f32
    items = [x.float() if x.dtype == torch.bfloat16 else x for x in items]
    return Batch(*items, is_weight=weights, cum_r=cum_r), ids


def make_offpolicy_update(batch_size: int, repeat_times: float, buffer, row_sample: bool,
                          objectives_fn: Callable, noise_fn: Optional[Callable] = None):
    """``update(agent_state, buf_state, gen, ids=None, noise=None) ->
    (agent_state, buf_state, metrics)``, the scan path.  ``ids``: ``(U, B)``
    flat ids, ``(U, R)`` rows (``row_sample``) or, under PER, ``(U, N,
    sub)`` uniforms, else drawn from ``gen``; ``noise``: the per-update draws
    (a tensor or a tuple of tensors with a leading ``U`` axis), else
    ``noise_fn(gen, U)`` when given."""

    def update(agent_state, buf_state, gen, ids=None, noise=None):
        U = offpolicy_update_times(buf_state.size, repeat_times, batch_size)
        if ids is None:
            ids = buffer.draw(buf_state, gen, U, batch_size, row_sample)
        if noise is None and noise_fn is not None:
            noise = noise_fn(gen, U)
        sums = torch.zeros(2, device=buf_state.states.device)
        n_actor = 0.0          # a host float: no device copy per update
        for i in range(U):
            batch, pids = sample_batch(buffer, buf_state, batch_size, ids[i], row_sample)
            agent_state, (obj_c, obj_a, a_upd), td = objectives_fn(
                agent_state, batch, draws_at(noise, i), i)
            if td is not None:
                buf_state = buffer.td_error_update_for_per(buf_state, pids, td)
            sums += torch.stack([obj_c, obj_a * a_upd])
            n_actor += a_upd
        metrics = {'obj_critic': sums[0] / U, 'obj_actor': sums[1] / max(n_actor, 1.0)}
        return agent_state, buf_state, metrics

    return update


def cum_fit_term(cum_r: torch.Tensor, q_values: torch.Tensor, lam: float) -> torch.Tensor:
    """The critic's extra loss fitting the batch-mean cumulative return,
    ``lam * mean((mean_batch(q) - mean(cum_r))^2)``; ``q_values (B,)`` or
    ``(B, E)``, ``cum_r (B,)`` the buffer's column at the sampled rows."""
    return lam * torch.mean(torch.square(torch.mean(q_values, dim=0) - torch.mean(cum_r)))


def epsilon_greedy(gen: torch.Generator, q_action: torch.Tensor, action_dim: int,
                   explore_rate: float) -> torch.Tensor:
    """Per-env epsilon-greedy: a uniformly random action where a coin falls
    below ``explore_rate``, the greedy action elsewhere (int32)."""
    rand_actions = torch.randint(0, action_dim, q_action.shape, generator=gen,
                                 device=q_action.device)
    explore = torch.rand(q_action.shape, generator=gen, device=q_action.device) < explore_rate
    return torch.where(explore, rand_actions, q_action.long()).to(torch.int32)
