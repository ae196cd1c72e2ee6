"""Shared off-policy update loop (counterpart of
``elegantrl_tpu/agents/off_policy.py``).

A round runs ``update_times = int32(f32(size) * repeat_times / batch_size)``
(at least 1) sequential minibatch updates, where ``size`` counts the ring's
filled time rows (reference ``AgentBase.update_net``).  The draws of every
update (minibatch ids or rows, TD3's smoothing noise) are made before the
loop, so the scan path here and the fused chunk path of the DQN and DDPG
agents consume the same draws; tests inject the JAX package's.

Each agent supplies ``objectives_fn(agent_state, batch, noise, update_t) ->
(agent_state, (obj_critic, obj_actor, actor_updated))``: one critic + actor
step on one gathered minibatch.  ``actor_updated`` is 1.0 or 0.0, so a
delayed or gated actor averages over the steps it took.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def offpolicy_update_times(size: int, repeat_times: float, batch_size: int) -> int:
    """``max(int32(f32(size) * repeat_times / batch_size), 1)`` in float32,
    as the JAX package computes it."""
    n = np.float32(size) * np.float32(repeat_times) / np.float32(batch_size)
    return max(int(np.float32(n)), 1)


def make_offpolicy_update(batch_size: int, repeat_times: float, buffer, row_sample: bool,
                          objectives_fn: Callable, noise_fn: Optional[Callable] = None):
    """``update(agent_state, buf_state, gen, ids=None, noise=None) ->
    (agent_state, buf_state, metrics)``, the scan path.  ``ids``: ``(U, B)``
    flat ids or ``(U, R)`` rows (``row_sample``), else drawn from ``gen``;
    ``noise``: ``(U, B, A)``, else ``noise_fn(gen, U)`` when given."""

    def update(agent_state, buf_state, gen, ids=None, noise=None):
        U = offpolicy_update_times(buf_state.size, repeat_times, batch_size)
        if ids is None:
            ids = buffer.draw(buf_state, gen, U, batch_size, row_sample)
        if noise is None and noise_fn is not None:
            noise = noise_fn(gen, U)
        sample = buffer.sample_rows if row_sample else buffer.sample
        sums = torch.zeros(2, device=buf_state.states.device)
        n_actor = 0.0          # a host float: no device copy per update
        for i in range(U):
            if row_sample:
                batch = sample(buf_state, batch_size, rows=ids[i])
            else:
                batch = sample(buf_state, batch_size, ids=ids[i])
            agent_state, (obj_c, obj_a, a_upd) = objectives_fn(
                agent_state, batch[:6], None if noise is None else noise[i], i)
            sums += torch.stack([obj_c, obj_a * a_upd])
            n_actor += a_upd
        metrics = {'obj_critic': sums[0] / U, 'obj_actor': sums[1] / max(n_actor, 1.0)}
        return agent_state, buf_state, metrics

    return update


def cum_fit_term(*_args, **_kw):
    """The ``lambda_fit_cum_r`` critic term needs the buffer's cumulative-return
    column, which is not ported yet."""
    raise NotImplementedError('lambda_fit_cum_r != 0 is not ported yet: it needs the replay '
                              "buffer's cumulative-return column")


def epsilon_greedy(gen: torch.Generator, q_action: torch.Tensor, action_dim: int,
                   explore_rate: float) -> torch.Tensor:
    """Per-env epsilon-greedy: a uniformly random action where a coin falls
    below ``explore_rate``, the greedy action elsewhere (int32)."""
    rand_actions = torch.randint(0, action_dim, q_action.shape, generator=gen,
                                 device=q_action.device)
    explore = torch.rand(q_action.shape, generator=gen, device=q_action.device) < explore_rate
    return torch.where(explore, rand_actions, q_action.long()).to(torch.int32)
