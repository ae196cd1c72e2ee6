"""DQN family: DQN, DoubleDQN, DuelingDQN, D3QN (counterpart of
``elegantrl_tpu/agents/dqn.py``).

- epsilon-greedy exploration with ``explore_rate`` (default 0.25);
- TD target ``r + undone * gamma * max_a Q_target(s')``; DoubleDQN takes
  the elementwise min of its twin heads before the max;
- Dueling: ``val - mean(val) + adv`` on the greedy path; the TD path of the
  dueling net without a twin reads the value head alone (the reference's
  ``QNetDuel.get_q_value``), D3QN combines;
- one Q-network, one optimizer, one target, Polyak-averaged every step;
- prioritised replay (``if_use_per``): the TD loss ``mean(td * is_weight)``
  and the per-sample ``td`` written back as priorities; ``lambda_fit_cum_r``
  adds the cumulative-return term on head 1's ``q_a``; ``cum_returns``
  bootstraps with ``max_a Q_target(last_obs)`` of the TD path.

On a card the plain net's no-grad forwards (exploration, evaluation) run
K11b (``ops/kernels.py:fused_mlp3``) and the replay gathers K11a
(``train/replay_buffer.py``, one launch per chunk); the twin and dueling
nets' forwards run PyTorch ops.

The Q-network is one flat buffer in the leaf order of
``ops/nets.py:dqn_param_shapes``.  The update is the fused chunk
(``ops/fused_offpolicy_update.py:dqn_chunk``: the CUDA kernel on a card,
its plain version on the CPU) wherever the JAX package takes its Pallas
chunk (``batch_size % 128 == 0``, at most 2048, ``max(net_dims) *
batch_size <= 131072``, 2 hidden layers, no PER, no ``lambda_fit_cum_r``);
otherwise the scan path of ``agents/off_policy.py``, ``torch.autograd`` on
either device.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from ..config import select_kernel
from ..ops import kernels
from ..ops.fused_offpolicy_update import (dqn_bcv, dqn_chunk, dqn_fits, dqn_next_q,
                                          dqn_q_greedy, dqn_q_td, dqn_td_errors)
from ..ops.fused_update import value_and_grad_flat
from ..ops.gae import cumulative_returns
from ..ops.nets import dqn_param_shapes, init_flat, mlp3_forward, soft_update_, split_flat
from .base import AdamState, AgentDef, grad_step, make_optimizer
from .off_policy import (cum_fit_term, epsilon_greedy, make_offpolicy_update,
                         offpolicy_update_times)

FUSED_CHUNK = 16   # updates per fused chunk, as the JAX package's


class DQNState(NamedTuple):
    q: torch.Tensor          # flat Q-network (ops/nets.py:dqn_param_shapes)
    q_target: torch.Tensor
    opt: AdamState


def row_sampling(args, buffer, batch_size: int) -> bool:
    """``args.replay_row_sample`` ('auto' | True | False) resolved as the JAX
    agents resolve it: whole time rows whenever the batch tiles the env axis
    and PER is off."""
    row_mode = getattr(args, 'replay_row_sample', 'auto')
    rows = (row_mode not in (False, 'false', '0') and buffer is not None
            and not bool(getattr(args, 'if_use_per', False))
            and batch_size % buffer.num_seqs == 0 and batch_size >= buffer.num_seqs)
    if row_mode is True and not rows:
        raise ValueError('replay_row_sample=True needs uniform sampling (no PER) and batch_size '
                         f'a positive multiple of num_envs (got batch_size={batch_size}, '
                         f'num_envs={getattr(buffer, "num_seqs", None)})')
    return rows


def gather_chunk(buffer, buf_state, draws, batch_size: int, row_sample: bool):
    """Pre-gathered ``(C, ...)`` blocks of C minibatches, one K11a launch on
    a card: ``(sb (C, S, B), nsb (C, S, B), actions ((C, A, B) continuous,
    (C, B) discrete), rb, ud, um (C, B))``."""
    sample = buffer.sample_rows if row_sample else buffer.sample
    key = 'rows' if row_sample else 'ids'
    s, a, r, ud, um, ns, _ = sample(buf_state, batch_size, feature_major=True, **{key: draws})
    return s, ns, a, r, ud, um


def make_dqn(net_dims, state_dim: int, action_dim: int, args, twin: bool = False,
             duel: bool = False, buffer=None) -> AgentDef:
    gamma = float(getattr(args, 'gamma', 0.99))
    lr = float(getattr(args, 'learning_rate', 6e-5))
    clip_grad = float(getattr(args, 'clip_grad_norm', 3.0))
    tau = float(getattr(args, 'soft_update_tau', 5e-3))
    explore_rate = float(getattr(args, 'explore_rate', 0.25))
    batch_size = int(getattr(args, 'batch_size', 64))
    repeat_times = float(getattr(args, 'repeat_times', 1.0))
    if_use_per = bool(getattr(args, 'if_use_per', False))
    lambda_fit_cum_r = float(getattr(args, 'lambda_fit_cum_r', 0.0))
    row_sample = row_sampling(args, buffer, batch_size)
    net_dims = tuple(int(d) for d in net_dims)
    shapes = dqn_param_shapes(state_dim, net_dims, action_dim, twin, duel)
    optimizer = make_optimizer(lr, clip_grad)
    hypers = dict(net_dims=net_dims, twin=twin, duel=duel, gamma=gamma, tau=tau, lr=lr,
                  clip_grad=clip_grad)

    def init(seed: int, device) -> DQNState:
        gen = torch.Generator().manual_seed(int(seed))
        if twin or duel:
            d = net_dims[-1]
            nets = [((state_dim, *net_dims), None), ((d, action_dim), 0.1)]
            nets += [((d, 1), 0.1)] if duel else []
            if twin:
                nets += [((d, action_dim), 0.1)] + ([((d, 1), 0.1)] if duel else [])
        else:
            nets = [((state_dim, *net_dims, action_dim), 0.1)]
        q = init_flat(gen, nets, device)
        return DQNState(q, q.clone(), optimizer.init(q))

    def leaves(flat):
        return split_flat(flat, shapes)

    # K11b (ops/kernels.py) takes the plain Q net's no-grad forward; the twin
    # and dueling nets (an encoder and heads) run PyTorch ops
    plain_net = not (twin or duel)
    use_mlp3 = kernels.select(
        args, 'use_mlp3_kernel',
        plain_net and kernels.mlp3_fits((state_dim, *net_dims, action_dim)),
        getattr(args, 'device', 'cuda'),
        f'the no-grad forward of a 3-linear f32 MLP whose tiles fit one block (the plain '
        f'DQN net); got twin={twin}, duel={duel}, net_dims={net_dims}')

    def q_greedy(s: DQNState, obs):
        if use_mlp3:
            return mlp3_forward(leaves(s.q), obs, True)
        return dqn_q_greedy(leaves(s.q), obs, twin, duel)

    def explore_action(s: DQNState, obs, gen):
        greedy = torch.argmax(q_greedy(s, obs), dim=-1)
        return epsilon_greedy(gen, greedy, action_dim, explore_rate), None

    def greedy_action(s: DQNState, obs):
        return torch.argmax(q_greedy(s, obs), dim=-1).to(torch.int32)

    def one_hot(action):
        return torch.nn.functional.one_hot(action.long(), action_dim).float()

    def loss(lv, b, label):
        td, q1a = dqn_td_errors(lv, b.state, one_hot(b.action), label, b.unmask, twin, duel)
        obj = torch.mean(td * b.is_weight) if if_use_per else torch.mean(td)
        if lambda_fit_cum_r != 0.0:
            obj = obj + cum_fit_term(b.cum_r, q1a, lambda_fit_cum_r)
        return obj, q1a, td

    def objectives(s: DQNState, b, _noise, _update_t):
        with torch.no_grad():
            label = b.reward + b.undone * gamma * dqn_next_q(leaves(s.q_target), b.next_state,
                                                             twin, duel)
        (obj, q1a, td), g = value_and_grad_flat(lambda lv: loss(lv, b, label), s.q, shapes)
        with torch.no_grad():
            opt = grad_step(optimizer, s.q, s.opt, g)
            soft_update_(s.q_target, s.q, tau)
        return (DQNState(s.q, s.q_target, opt), (obj.detach(), torch.mean(q1a).detach(), 1.0),
                td.detach() if if_use_per else None)

    # the JAX package's eligibility for its Pallas chunk, term by term
    # (elegantrl_tpu/agents/dqn.py:_fused_update; the port has no mesh):
    # under bf16 storage (f32_storage false) it runs its scan
    jax_takes = (buffer is not None and not if_use_per and lambda_fit_cum_r == 0.0
                 and len(net_dims) == 2 and batch_size % 128 == 0
                 and batch_size <= 2048 and max(net_dims) * batch_size <= 131072
                 and getattr(buffer, 'storage_dtype', torch.float32) == torch.float32)
    port_fits = dqn_fits(net_dims)
    fused = buffer is not None and select_kernel(
        args, 'use_fused_update', jax_takes, port_fits, getattr(args, 'device', 'cuda'),
        f'a batch that is a multiple of 128 and at most 2048 with max(net_dims) * batch <= '
        f'131072, a 2-hidden-layer net, uniform sampling (no PER), lambda_fit_cum_r=0 and '
        f'float32 storage (the DQN chunk); got batch_size={batch_size}, net_dims={net_dims}, '
        f'if_use_per={if_use_per}, lambda_fit_cum_r={lambda_fit_cum_r}, '
        f"storage_dtype={getattr(args, 'storage_dtype', 'float32')}")

    def fused_update(s: DQNState, buf_state, gen, ids=None, noise=None):
        """The chunked update, ``FUSED_CHUNK`` updates per call of
        ``dqn_chunk`` over minibatches gathered with the scan path's draws."""
        U = offpolicy_update_times(buf_state.size, repeat_times, batch_size)
        n_chunks = -(-U // FUSED_CHUNK)
        if ids is None:
            ids = buffer.draw(buf_state, gen, U, batch_size, row_sample)
        dev = buf_state.states.device
        pad = n_chunks * FUSED_CHUNK - U
        if pad:   # padded steps are masked invalid; their draws are never used
            ids = torch.cat([ids, ids[:1].expand(pad, -1)])
        sums = torch.zeros(2, device=dev)
        for c in range(n_chunks):
            idx = torch.arange(c * FUSED_CHUNK, (c + 1) * FUSED_CHUNK, device=dev)
            sb, nsb, acts, rb, ud, um = gather_chunk(buffer, buf_state, ids[idx], batch_size,
                                                     row_sample)
            oh = one_hot(acts).transpose(1, 2).contiguous()            # (C, A, B)
            bcv = dqn_bcv(s.opt.count, idx, U)
            objs = dqn_chunk(s.q, s.q_target, s.opt.mu, s.opt.nu, sb, nsb, oh, rb, ud, um,
                             bcv, **hypers)
            sums += torch.sum(objs * bcv[:, 2:3], dim=0)
        metrics = {'obj_critic': sums[0] / U, 'obj_actor': sums[1] / U}
        return s._replace(opt=s.opt._replace(count=s.opt.count + U)), buf_state, metrics

    update = fused_update if fused else make_offpolicy_update(
        batch_size, repeat_times, buffer, row_sample, objectives)

    def cum_returns(s: DQNState, rollout, last_obs):
        """Discounted returns of the rollout bootstrapped with ``max_a``
        of the target's TD-path Q at ``last_obs`` (the JAX package's choice)."""
        with torch.no_grad():
            q1, _ = dqn_q_td(leaves(s.q_target), last_obs, twin, duel)
            return cumulative_returns(rollout.rewards, rollout.undones,
                                      torch.amax(q1, dim=-1), gamma)

    name = ('AgentD3QN' if (twin and duel) else 'AgentDoubleDQN' if twin
            else 'AgentDuelingDQN' if duel else 'AgentDQN')
    return AgentDef(name=name, if_off_policy=True, if_discrete=True, init=init,
                    explore_action=explore_action, greedy_action=greedy_action,
                    env_action=lambda a: a, update=update, cum_returns=cum_returns,
                    state_to_numpy=partial(_dqn_to_numpy, shapes=shapes, twin=twin, duel=duel),
                    state_from_numpy=partial(_dqn_from_numpy, twin=twin, duel=duel))


def _dqn_to_numpy(s, shapes, twin, duel):
    from ..utils.jax_params import dqn_state_to_numpy
    return dqn_state_to_numpy(s, shapes, twin, duel)


def _dqn_from_numpy(tree, device, twin, duel):
    from ..utils.jax_params import dqn_state_from_numpy
    return dqn_state_from_numpy(tree, device, twin, duel)


class AgentDQN:
    make = staticmethod(partial(make_dqn, twin=False, duel=False))


class AgentDoubleDQN:
    make = staticmethod(partial(make_dqn, twin=True, duel=False))


class AgentDuelingDQN:
    make = staticmethod(partial(make_dqn, twin=False, duel=True))


class AgentD3QN:
    make = staticmethod(partial(make_dqn, twin=True, duel=True))

