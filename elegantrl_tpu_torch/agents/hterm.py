"""H-term rehearsal (counterpart of ``elegantrl_tpu/agents/hterm.py``),
shared by the H-term variants of PPO, DDPG, TD3, SAC and ModSAC.

Each rollout inserts every env's best k-step window (the argmax over a
per-start quality signal ``q``) into a fixed-size ring; the actor's
objective gains a return-weighted term over windows rehearsed from it: a
likelihood bonus for a stochastic policy (PPO, SAC), an action-regression
penalty for a deterministic one (DDPG, TD3).

The ring's tensors live on the run's device and are written in place;
``ptr`` and ``count`` are Python ints, so the rehearsal draws need no
device sync.  The JAX package draws each update's rehearsal ids from its
key; here they are drawn per round from the run's generator
(:func:`draw_rehearsal_ids`), or injected (tests pass the JAX package's).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class HtermBuffer(NamedTuple):
    states: torch.Tensor    # (K, k, S)
    actions: torch.Tensor   # (K, k, A)
    masks: torch.Tensor     # (K, k)  within-episode validity (stops at an episode end)
    returns: torch.Tensor   # (K,)    window quality label
    ptr: int
    count: int


class HtermDraws(NamedTuple):
    """An H-term agent's per-update draws: the base agent's noise (None for
    DDPG) and the rehearsal slot ids ``(U, h_batch)``."""
    noise: Optional[torch.Tensor]
    h_ids: torch.Tensor


def init_hterm_buffer(buffer_size: int, k_step: int, state_dim: int, action_dim: int,
                      device) -> HtermBuffer:
    K, k = int(buffer_size), int(k_step)
    return HtermBuffer(states=torch.zeros((K, k, state_dim), device=device),
                       actions=torch.zeros((K, k, action_dim), device=device),
                       masks=torch.zeros((K, k), device=device),
                       returns=torch.zeros((K,), device=device), ptr=0, count=0)


def insert_best_windows(h_buf: HtermBuffer, states, actions, undones, unmasks, q,
                        k_full: int) -> HtermBuffer:
    """Insert each env's best k-step window into the ring, in place.

    ``q (Hq, N)`` is the quality per window start, ``Hq = H - k_step + 1``
    with ``k_step = min(k_full, H)``.  A window's mask stops after the first
    episode boundary inside it (terminal or truncation); short horizons pad
    to ``k_full`` with the tail masked.  With more envs than ring slots the
    top-K windows by label are kept, ties to the lower env index (as
    ``jax.lax.top_k``): a stable descending sort."""
    horizon_len, num_envs = undones.shape
    K = h_buf.states.shape[0]
    k_step = min(k_full, horizon_len)
    dev = q.device
    t0 = torch.argmax(q, dim=0)                                         # (N,), first max
    labels = torch.gather(q, 0, t0[None])[0]
    if num_envs > K:
        keep = torch.sort(labels, descending=True, stable=True).indices[:K]
        labels, t0 = labels[keep], t0[keep]
        states, actions = states[:, keep], actions[:, keep]
        undones, unmasks = undones[:, keep], unmasks[:, keep]
        num_envs = K
    env_ids = torch.arange(num_envs, device=dev)[None, :]
    t_idx = torch.clamp(t0[None, :] + torch.arange(k_full, device=dev)[:, None],
                        max=horizon_len - 1)                            # (k, N)
    stop = (undones * unmasks)[t_idx, env_ids]                          # (k, N)
    in_range = (torch.arange(k_full, device=dev) < k_step)[:, None]
    w_masks = torch.cat([torch.ones((1, num_envs), device=dev),
                         torch.cumprod(stop, dim=0)[:-1]], 0) * in_range
    slot = (h_buf.ptr + torch.arange(num_envs, device=dev)) % K
    h_buf.states[slot] = states[t_idx, env_ids].transpose(0, 1).to(h_buf.states.dtype)
    h_buf.actions[slot] = actions[t_idx, env_ids].transpose(0, 1).to(h_buf.actions.dtype)
    h_buf.masks[slot] = w_masks.T
    h_buf.returns[slot] = labels
    return h_buf._replace(ptr=(h_buf.ptr + num_envs) % K, count=min(h_buf.count + num_envs, K))


def return_bounds(h_buf: HtermBuffer) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min and max quality over the filled slots (inf and -inf when empty):
    the rehearsal weights' bounds."""
    filled = torch.arange(h_buf.returns.shape[0], device=h_buf.returns.device) < h_buf.count
    inf = torch.full_like(h_buf.returns, float('inf'))
    return (torch.amin(torch.where(filled, h_buf.returns, inf)),
            torch.amax(torch.where(filled, h_buf.returns, -inf)))


def discounted_window_returns(rewards, undones, unmasks, gamma: float, k_full: int):
    """``(Hq, N)`` masked discounted return of every k-step window start,
    ``q[t] = sum_i gamma^i r[t+i] prod_{j<i} cont[t+j]`` with ``cont =
    undone * unmask``: the off-policy window quality."""
    horizon_len = rewards.shape[0]
    k_step = min(k_full, horizon_len)
    hq = horizon_len - k_step + 1
    cont = undones * unmasks
    q = torch.zeros_like(rewards[:hq])
    m = torch.ones_like(rewards[:hq])
    for i in range(k_step):
        q = q + (gamma ** i) * rewards[i:i + hq] * m
        m = m * cont[i:i + hq]
    return q


def window_harvest(gamma: float, k_step: int):
    """The off-policy H-term agents' ``pre_update(agent_state, rollout,
    last_obs)``: each env's best k-step window of the fresh rollout (quality:
    the masked discounted window return) into the agent state's ring."""
    def pre_update(s, rollout, last_obs):
        q = discounted_window_returns(rollout.rewards, rollout.undones, rollout.unmasks, gamma,
                                      k_step)
        return s._replace(h_buf=insert_best_windows(s.h_buf, rollout.states, rollout.actions,
                                                    rollout.undones, rollout.unmasks, q, k_step))
    return pre_update


def draw_rehearsal_ids(gen: torch.Generator, h_buf: HtermBuffer, count: int,
                       h_batch: int) -> torch.Tensor:
    """``count`` updates' rehearsal slot ids, ``(count, h_batch)``, uniform
    below ``max(count_filled, 1)``."""
    return torch.randint(0, max(h_buf.count, 1), (count, h_batch), generator=gen,
                         device=gen.device)


def rehearsal_sample(h_buf: HtermBuffer, ids: torch.Tensor, r_min=None, r_max=None):
    """The windows at slot ``ids (h_batch,)``: ``(states, actions, masks,
    weights, valid)`` with min-max-normalised quality weights and ``valid``
    1 for filled slots (weights 0 elsewhere, also for an empty ring).  The
    rehearsal objective is ``sum(term * w * valid) / max(sum(valid), 1)``."""
    if r_min is None or r_max is None:
        r_min, r_max = return_bounds(h_buf)
    w = (h_buf.returns[ids] - r_min) / (r_max - r_min + 1e-6)
    valid = (ids < h_buf.count).float()
    w = torch.where(valid > 0, w, torch.zeros_like(w))
    return h_buf.states[ids], h_buf.actions[ids], h_buf.masks[ids], w, valid


def masked_window_mean(term: torch.Tensor, masks: torch.Tensor, w: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """``sum(mean_window(term) * w * valid) / max(sum(valid), 1)`` with the
    window mean ``sum(term * mask) / max(sum(mask), 1)`` per window:
    the rehearsal objective over ``term (h_batch, k)``."""
    per_window = torch.sum(term * masks, 1) / torch.clamp(torch.sum(masks, 1), min=1.0)
    return torch.sum(per_window * w * valid) / torch.clamp(torch.sum(valid), min=1.0)
