"""Embed-DQN family: Q(s, a) through learned action embeddings (counterpart
of ``elegantrl_tpu/agents/embed_dqn.py``).

- an action embedding matrix ``(A, e)`` with ``e = max(8, int(sqrt(A)))``,
  orthogonal with gain 0.5;
- every action's Q is evaluated by tiling the action embeddings against the
  state batch, ``(B, A, E)`` heads;
- ``AgentEmbedDQN``: one MLP over ``[s, emb(a)]`` with E = 8 outputs;
  ``AgentEnsembleDQN``: a linear encoder of ``[s, emb(a)]`` and E = 4 head
  MLPs (the SAC critic's shape, ``ops/nets.py:sac_cri_shapes``);
- TD target ``r + undone * gamma * max_a mean_E Q_target(s', a)``, the TD
  error averaged over the heads; epsilon-greedy exploration on ``mean_E Q``;
- prioritised replay, ``lambda_fit_cum_r`` and ``cum_returns`` as the DQN
  family's.

The JAX package has no kernel for these agents and keeps them off the
rollout kernel, so their rollout and update are PyTorch ops on either
device (the scan path of ``agents/off_policy.py``).  The Q-network is one
flat buffer: the embedding, then the MLP's (or encoder's and heads') leaves.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from ..config import select_kernel
from ..ops.fused_offpolicy_update import sac_q_values
from ..ops.fused_update import value_and_grad_flat
from ..ops.gae import cumulative_returns
from ..ops.nets import (init_flat, mlp_apply_leaves, mlp_shapes, sac_cri_shapes,
                        soft_update_, split_flat)
from .base import AdamState, AgentDef, grad_step, make_optimizer
from .dqn import row_sampling
from .off_policy import cum_fit_term, epsilon_greedy, make_offpolicy_update


class EmbedDQNState(NamedTuple):
    q: torch.Tensor          # flat: embedding (A, e), then the Q net's leaves
    q_target: torch.Tensor
    opt: AdamState


def embed_param_shapes(state_dim: int, net_dims, action_dim: int, num_ensembles: int,
                       ensemble: bool) -> list:
    """Leaf shapes of the flat Q buffer: the embedding ``(A, e)``, then the
    MLP ``S + e -> net_dims -> E`` or the encoder and E heads."""
    e = max(8, int(action_dim ** 0.5))
    if ensemble:
        return [(action_dim, e)] + sac_cri_shapes(state_dim, e, net_dims, num_ensembles)
    return [(action_dim, e)] + mlp_shapes((state_dim + e, *net_dims, num_ensembles))


def make_embed_dqn(net_dims, state_dim: int, action_dim: int, args, buffer=None,
                   ensemble: bool = False) -> AgentDef:
    gamma = float(getattr(args, 'gamma', 0.99))
    lr = float(getattr(args, 'learning_rate', 6e-5))
    clip_grad = float(getattr(args, 'clip_grad_norm', 3.0))
    tau = float(getattr(args, 'soft_update_tau', 5e-3))
    explore_rate = float(getattr(args, 'explore_rate', 0.25))
    batch_size = int(getattr(args, 'batch_size', 64))
    repeat_times = float(getattr(args, 'repeat_times', 1.0))
    if_use_per = bool(getattr(args, 'if_use_per', False))
    lambda_fit_cum_r = float(getattr(args, 'lambda_fit_cum_r', 0.0))
    num_ensembles = int(getattr(args, 'num_ensembles', 4 if ensemble else 8))
    row_sample = row_sampling(args, buffer, batch_size)
    net_dims = tuple(int(d) for d in net_dims)
    E = num_ensembles
    shapes = embed_param_shapes(state_dim, net_dims, action_dim, E, ensemble)
    emb_dim = shapes[0][1]
    optimizer = make_optimizer(lr, clip_grad)
    if buffer is not None:   # no kernel in either package: PyTorch ops, said so
        select_kernel(args, 'use_fused_update', False, False, getattr(args, 'device', 'cuda'),
                      'a DQN-family agent of agents/dqn.py (no kernel takes the Embed-DQN nets)')

    def init(seed: int, device) -> EmbedDQNState:
        gen = torch.Generator().manual_seed(int(seed))
        emb = torch.empty((action_dim, emb_dim))
        torch.nn.init.orthogonal_(emb, gain=0.5, generator=gen)
        if ensemble:
            nets = [((state_dim + emb_dim, net_dims[0]), None)] + [((*net_dims, 1), 0.5)] * E
        else:
            nets = [((state_dim + emb_dim, *net_dims, E), 0.5)]
        q = torch.cat([emb.reshape(-1).to(device), init_flat(gen, nets, device)])
        return EmbedDQNState(q, q.clone(), optimizer.init(q))

    def q_heads(leaves, state, action_emb):
        """``(..., E)`` heads on ``[state, action_emb]``."""
        if ensemble:
            return sac_q_values(leaves[1:], state, action_emb, E)
        return mlp_apply_leaves(leaves[1:], torch.cat([state, action_emb], dim=-1))

    def mean_q(leaves, state):
        """``(B, A)``: every action's Q, averaged over the heads."""
        emb = leaves[0]
        b = state.shape[0]
        s = state[:, None, :].expand(b, action_dim, state.shape[-1])
        return torch.mean(q_heads(leaves, s, emb[None].expand(b, action_dim, emb_dim)), dim=-1)

    def explore_action(s: EmbedDQNState, obs, gen):
        greedy = torch.argmax(mean_q(split_flat(s.q, shapes), obs), dim=-1)
        return epsilon_greedy(gen, greedy, action_dim, explore_rate), None

    def greedy_action(s: EmbedDQNState, obs):
        return torch.argmax(mean_q(split_flat(s.q, shapes), obs), dim=-1).to(torch.int32)

    def loss(lv, b, label):
        qs = q_heads(lv, b.state, lv[0][b.action.long()])           # (B, E)
        td = torch.mean(torch.square(qs - label[:, None]), dim=-1) * b.unmask
        obj = torch.mean(td * b.is_weight) if if_use_per else torch.mean(td)
        if lambda_fit_cum_r != 0.0:
            obj = obj + cum_fit_term(b.cum_r, qs, lambda_fit_cum_r)
        return obj, qs, td

    def objectives(s: EmbedDQNState, b, _noise, _update_t):
        with torch.no_grad():
            next_q = torch.amax(mean_q(split_flat(s.q_target, shapes), b.next_state), dim=-1)
            label = b.reward + b.undone * gamma * next_q
        (obj, qs, td), g = value_and_grad_flat(lambda lv: loss(lv, b, label), s.q, shapes)
        with torch.no_grad():
            opt = grad_step(optimizer, s.q, s.opt, g)
            soft_update_(s.q_target, s.q, tau)
        return (EmbedDQNState(s.q, s.q_target, opt),
                (obj.detach(), torch.mean(qs).detach(), 1.0),
                td.detach() if if_use_per else None)

    update = make_offpolicy_update(batch_size, repeat_times, buffer, row_sample, objectives)

    def cum_returns(s: EmbedDQNState, rollout, last_obs):
        """Discounted returns bootstrapped with ``max_a mean_E Q_target``."""
        with torch.no_grad():
            next_v = torch.amax(mean_q(split_flat(s.q_target, shapes), last_obs), dim=-1)
            return cumulative_returns(rollout.rewards, rollout.undones, next_v, gamma)

    return AgentDef(name='AgentEnsembleDQN' if ensemble else 'AgentEmbedDQN',
                    if_off_policy=True, if_discrete=True, init=init,
                    explore_action=explore_action, greedy_action=greedy_action,
                    env_action=lambda a: a, update=update, cum_returns=cum_returns,
                    state_to_numpy=partial(_embed_to_numpy, shapes=shapes, ensemble=ensemble,
                                           num_ensembles=E),
                    state_from_numpy=partial(_embed_from_numpy, ensemble=ensemble))


def _embed_to_numpy(s, shapes, ensemble, num_ensembles):
    from ..utils.jax_params import embed_dqn_state_to_numpy
    return embed_dqn_state_to_numpy(s, shapes, ensemble, num_ensembles)


def _embed_from_numpy(tree, device, ensemble):
    from ..utils.jax_params import embed_dqn_state_from_numpy
    return embed_dqn_state_from_numpy(tree, device, ensemble)


class AgentEmbedDQN:
    make = staticmethod(partial(make_embed_dqn, ensemble=False))


class AgentEnsembleDQN:
    make = staticmethod(partial(make_embed_dqn, ensemble=True))
