"""DDPG and TD3 and their H-term variants (counterpart of
``elegantrl_tpu/agents/ddpg_td3.py``).

- deterministic tanh actor with Gaussian exploration noise
  ``explore_noise_std``, clipped to [-1, 1];
- critic(s, a) is an MLP over ``[s, a]`` whose E outputs are the
  ensemble's heads on one trunk (E = ``num_ensembles``, 8 for TD3, 1 for
  DDPG); the scalar critic value is their mean;
- TD3: the target action from the *online* actor smoothed with
  ``policy_noise_std`` and clipped, the min over the heads for the TD
  target, the actor updated every ``update_freq``-th step of a round;
- DDPG: the reference's generic update with its quirks, ``q * unmask``
  inside the TD error and the actor gated on ``size >= buffer_init_size``;
- prioritised replay (``if_use_per``): the critic loss ``mean(td *
  is_weight)``, the per-sample ``td`` written back as priorities;
  ``lambda_fit_cum_r`` adds the cumulative-return term on the heads;
  ``cum_returns`` bootstraps with ``mean_E Q_target(last, act_target(last))``;
- H-term (``AgentDDPGHterm``, ``AgentTD3Hterm``): ``pre_update`` harvests
  each env's best k-step window (quality: the masked discounted window
  return) into the ring of ``agents/hterm.py``, and the actor loss gains
  ``h_term_lambda`` times the return-weighted MSE of the actor on rehearsed
  windows' actions.

Actor and critic are flat buffers (``ops/nets.py:ddpg_param_shapes``).
The update is the fused chunk (``ops/fused_offpolicy_update.py:ddpg_chunk``:
the CUDA kernel on a card, its plain version on the CPU; under PER the K7'
variant) wherever the JAX package takes its Pallas chunk, else the scan path
of ``agents/off_policy.py`` (``torch.autograd``) on either device.  The
fused PER path is the JAX package's: all C minibatches of a chunk are drawn
against the tree as it stands at the chunk's start, and the chunk's TD
errors are folded into the tree afterwards, step by step, for its valid
steps; so priorities lag by up to C - 1 updates inside a chunk.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from ..config import select_kernel
from ..ops import kernels
from ..ops.fused_offpolicy_update import (SMEM_LIMIT, ddpg_actor, ddpg_actor_loss, ddpg_bcv,
                                          ddpg_chunk, ddpg_critic_td, ddpg_q_values,
                                          ddpg_smem_bytes, ddpg_td_label)
from ..ops.fused_update import value_and_grad_flat
from ..ops.gae import cumulative_returns
from ..ops.nets import ddpg_param_shapes, init_flat, mlp3_forward, soft_update_, split_flat
from .base import AdamState, AgentDef, grad_step, make_optimizer
from .dqn import FUSED_CHUNK, gather_chunk, row_sampling
from .hterm import (HtermBuffer, HtermDraws, draw_rehearsal_ids, init_hterm_buffer,
                    masked_window_mean, rehearsal_sample, return_bounds, window_harvest)
from .off_policy import cum_fit_term, make_offpolicy_update, offpolicy_update_times


class DDPGState(NamedTuple):
    act: torch.Tensor          # flat actor (ops/nets.py:ddpg_param_shapes)
    act_target: torch.Tensor
    cri: torch.Tensor          # flat critic with E outputs
    cri_target: torch.Tensor
    act_opt: AdamState
    cri_opt: AdamState


class DDPGHtermState(NamedTuple):
    act: torch.Tensor
    act_target: torch.Tensor
    cri: torch.Tensor
    cri_target: torch.Tensor
    act_opt: AdamState
    cri_opt: AdamState
    h_buf: HtermBuffer


def _make(net_dims, state_dim: int, action_dim: int, args, buffer=None, td3: bool = True,
          hterm: bool = False) -> AgentDef:
    gamma = float(getattr(args, 'gamma', 0.99))
    lr = float(getattr(args, 'learning_rate', 6e-5))
    clip_grad = float(getattr(args, 'clip_grad_norm', 3.0))
    tau = float(getattr(args, 'soft_update_tau', 5e-3))
    batch_size = int(getattr(args, 'batch_size', 64))
    repeat_times = float(getattr(args, 'repeat_times', 1.0))
    if_use_per = bool(getattr(args, 'if_use_per', False))
    row_sample = row_sampling(args, buffer, batch_size)
    lambda_fit_cum_r = float(getattr(args, 'lambda_fit_cum_r', 0.0))
    buffer_init_size = int(getattr(args, 'buffer_init_size', batch_size * 8))
    explore_noise_std = float(getattr(args, 'explore_noise_std',
                                      getattr(args, 'explore_noise', 0.05)))
    update_freq = int(getattr(args, 'update_freq', 2))
    num_ensembles = int(getattr(args, 'num_ensembles', 8)) if td3 else 1
    policy_noise_std = float(getattr(args, 'policy_noise_std', 0.10))
    h_term_lambda = float(getattr(args, 'h_term_lambda', 2 ** -3))
    h_term_drop_rate = float(getattr(args, 'h_term_drop_rate', 2 ** -2))
    h_term_k_step = int(getattr(args, 'h_term_k_step', 16))
    h_term_buffer_size = int(getattr(args, 'h_term_buffer_size', 2 ** 12))
    h_batch = max(1, int(batch_size * h_term_drop_rate))
    net_dims = tuple(int(d) for d in net_dims)
    act_shapes, cri_shapes = ddpg_param_shapes(state_dim, net_dims, action_dim, num_ensembles)
    optimizer = make_optimizer(lr, clip_grad)
    hypers = dict(net_dims=net_dims, td3=td3, num_ensembles=num_ensembles, gamma=gamma,
                  tau=tau, lr=lr, clip_grad=clip_grad)

    def init(seed: int, device):
        gen = torch.Generator().manual_seed(int(seed))
        act = init_flat(gen, [((state_dim, *net_dims, action_dim), 0.1)], device)
        cri = init_flat(gen, [((state_dim + action_dim, *net_dims, num_ensembles), 0.5)],
                        device)
        base = (act, act.clone(), cri, cri.clone(), optimizer.init(act), optimizer.init(cri))
        if not hterm:
            return DDPGState(*base)
        return DDPGHtermState(*base, init_hterm_buffer(h_term_buffer_size, h_term_k_step,
                                                       state_dim, action_dim, device))

    # K11b (ops/kernels.py) takes the actor's no-grad forward (a 3-linear MLP)
    use_mlp3 = kernels.select(
        args, 'use_mlp3_kernel', kernels.mlp3_fits((state_dim, *net_dims, action_dim)),
        getattr(args, 'device', 'cuda'),
        f'the no-grad forward of a 3-linear f32 MLP whose tiles fit one block (the actor); '
        f'got net_dims={net_dims}')

    def greedy_action(s, obs):
        return torch.tanh(mlp3_forward(split_flat(s.act, act_shapes), obs, use_mlp3))

    def explore_action(s, obs, gen):
        a = greedy_action(s, obs)
        z = torch.randn(a.shape, generator=gen, device=a.device)
        return torch.clamp(a + explore_noise_std * z, -1.0, 1.0), None

    def smoothing_noise(gen, count):
        """TD3's target-policy smoothing noise, ``(count, B, A)``."""
        return policy_noise_std * torch.randn((count, batch_size, action_dim), generator=gen,
                                              device=gen.device)

    def do_actor(buf_state, update_t: int) -> bool:
        return update_t % update_freq == 0 if td3 else buf_state.size >= buffer_init_size

    def critic_loss(lv, b, label):
        td, qs = ddpg_critic_td(lv, b.state, b.action, label, b.unmask, td3)
        obj = torch.mean(td * b.is_weight) if if_use_per else torch.mean(td)
        if lambda_fit_cum_r != 0.0:
            obj = obj + cum_fit_term(b.cum_r, qs, lambda_fit_cum_r)
        return obj, td

    def actor_loss(lv, cri_leaves, state, h_ids, h_bounds, h_buf):
        loss = ddpg_actor_loss(lv, cri_leaves, state)
        if hterm:   # return-weighted regression of the actor onto rehearsed windows
            hs, ha, hm, w, valid = rehearsal_sample(h_buf, h_ids, *h_bounds)
            mse = torch.mean(torch.square(ddpg_actor(lv, hs) - ha), dim=-1)
            loss = loss + h_term_lambda * masked_window_mean(mse, hm, w, valid)
        return loss

    def make_objectives(buf_state, h_bounds):
        def objectives(s, b, draws, update_t):
            z = draws.noise if hterm else draws
            with torch.no_grad():
                label = ddpg_td_label(split_flat(s.act, act_shapes),
                                      split_flat(s.cri_target, cri_shapes), b.next_state,
                                      b.reward, b.undone, z, gamma, td3)
            (obj_c, td), g_c = value_and_grad_flat(lambda lv: critic_loss(lv, b, label), s.cri,
                                                   cri_shapes)
            with torch.no_grad():
                cri_opt = grad_step(optimizer, s.cri, s.cri_opt, g_c)
                soft_update_(s.cri_target, s.cri, tau)
            s = s._replace(cri_opt=cri_opt)
            td = td.detach() if if_use_per else None
            if not do_actor(buf_state, update_t):
                return s, (obj_c.detach(), torch.zeros_like(obj_c.detach()), 0.0), td
            cri_leaves = split_flat(s.cri, cri_shapes)
            obj_neg, g_a = value_and_grad_flat(
                lambda lv: actor_loss(lv, cri_leaves, b.state, draws.h_ids if hterm else None,
                                      h_bounds, s.h_buf if hterm else None), s.act, act_shapes)
            with torch.no_grad():
                act_opt = grad_step(optimizer, s.act, s.act_opt, g_a)
                soft_update_(s.act_target, s.act, tau)
            return s._replace(act_opt=act_opt), (obj_c.detach(), -obj_neg.detach(), 1.0), td
        return objectives

    def scan_update(s, buf_state, gen, ids=None, noise=None):
        """The scan path; an H-term agent's ``noise`` is ``HtermDraws(smoothing
        noise or None, rehearsal ids (U, h_batch))``."""
        noise_fn = smoothing_noise if td3 else None
        if hterm:
            noise_fn = lambda g, U: HtermDraws(  # noqa: E731
                smoothing_noise(g, U) if td3 else None,
                draw_rehearsal_ids(g, s.h_buf, U, h_batch))
        elif not td3:
            noise = None        # DDPG's target action takes no noise
        h_bounds = return_bounds(s.h_buf) if hterm else None   # fixed through the round
        update = make_offpolicy_update(batch_size, repeat_times, buffer, row_sample,
                                       make_objectives(buf_state, h_bounds), noise_fn)
        return update(s, buf_state, gen, ids=ids, noise=noise)

    # the JAX package's eligibility for its Pallas chunk, term by term
    # (elegantrl_tpu/agents/ddpg_td3.py:_fused_update; the storage is float32,
    # no mesh)
    jax_takes = (buffer is not None and not hterm and lambda_fit_cum_r == 0.0
                 and len(net_dims) == 2 and batch_size % 128 == 0 and batch_size <= 2048
                 and max(net_dims) * batch_size <= 131072
                 and (not if_use_per or batch_size % buffer.num_seqs == 0))
    port_fits = len(net_dims) == 2 and ddpg_smem_bytes(
        state_dim, action_dim, *net_dims, num_ensembles) <= SMEM_LIMIT
    fused = buffer is not None and select_kernel(
        args, 'use_fused_update', jax_takes, port_fits, getattr(args, 'device', 'cuda'),
        f'the non-H-term agent, lambda_fit_cum_r=0, a batch that is a multiple of 128 (and '
        f'under PER of num_envs) and at most 2048 with max(net_dims) * batch <= 131072 and a '
        f'2-hidden-layer net whose tiles fit one block (the DDPG/TD3 chunk); got '
        f'batch_size={batch_size}, net_dims={net_dims}, hterm={hterm}, '
        f'lambda_fit_cum_r={lambda_fit_cum_r}')

    def chunk_blocks(buf_state, draws):
        """One chunk's blocks ``(sb, nsb, ab (C, A, B), rb, ud, um)``, and under
        PER the draw against the tree as it stands: ``(ids0, ids1, iw (C, B))``."""
        if not if_use_per:
            sb, nsb, ab, rb, ud, um = gather_chunk(buffer, buf_state, draws, batch_size,
                                                   row_sample)
            return (sb, nsb, ab.transpose(1, 2).contiguous(), rb, ud, um), None
        ids0, ids1, iw = buffer.per_ids(buf_state, batch_size, draws)
        s_, a_, r_, ud, um, ns_, _ = buffer.gather(buf_state, ids0, ids1)
        return ((s_.transpose(1, 2).contiguous(), ns_.transpose(1, 2).contiguous(),
                 a_.transpose(1, 2).contiguous(), r_.contiguous(), ud.contiguous(),
                 um.contiguous()), (ids0, ids1, iw.contiguous()))

    def fused_update(s: DDPGState, buf_state, gen, ids=None, noise=None):
        """The chunked update, ``FUSED_CHUNK`` updates per call of
        ``ddpg_chunk`` over minibatches gathered with the scan path's draws;
        ``do_act`` restarts at update 0 every round."""
        U = offpolicy_update_times(buf_state.size, repeat_times, batch_size)
        n_chunks = -(-U // FUSED_CHUNK)
        dev = buf_state.states.device
        if ids is None:
            ids = buffer.draw(buf_state, gen, U, batch_size, row_sample)
        if noise is None:
            noise = (smoothing_noise(gen, U) if td3
                     else torch.zeros((U, batch_size, action_dim), device=dev))
        pad = n_chunks * FUSED_CHUNK - U
        if pad:   # padded steps are masked invalid; their draws are never used
            ids = torch.cat([ids, ids[:1].expand((pad,) + ids.shape[1:])])
            noise = torch.cat([noise, noise[:1].expand(pad, -1, -1)])
        ca0, cc0 = s.act_opt.count, s.cri_opt.count
        ddpg_do = buf_state.size >= buffer_init_size
        sums = torch.zeros(3, device=dev)
        for c in range(n_chunks):
            idx = torch.arange(c * FUSED_CHUNK, (c + 1) * FUSED_CHUNK, device=dev)
            blocks, per = chunk_blocks(buf_state, ids[idx])
            nz = noise[idx].transpose(1, 2).contiguous()                 # (C, A, B)
            if td3:   # the actor's Adam step at execution: earlier actor steps + 1
                do_act = idx % update_freq == 0
                act_steps = (idx + update_freq - 1) // update_freq + 1
            else:
                do_act = torch.full_like(idx, int(ddpg_do))
                act_steps = idx + 1
            bcv = ddpg_bcv(cc0, ca0, idx, U, do_act, act_steps)
            objs = ddpg_chunk(s.act, s.cri, s.act_target, s.cri_target, s.act_opt.mu,
                              s.cri_opt.mu, s.act_opt.nu, s.cri_opt.nu, *blocks[:5],
                              blocks[5], nz, bcv, **hypers,
                              **({} if per is None else {'iw': per[2]}))
            if per is not None:   # the priority fold, step by step, valid steps only
                objs, td = objs
                for u in range(min(FUSED_CHUNK, U - c * FUSED_CHUNK)):
                    buffer.td_error_update_for_per(buf_state, (per[0][u], per[1][u]), td[u])
            a_upd = bcv[:, 4] * bcv[:, 5]
            sums += torch.stack([torch.sum(objs[:, 0] * bcv[:, 4]),
                                 torch.sum(objs[:, 1] * a_upd), torch.sum(a_upd)])
        n_act = -(-U // update_freq) if td3 else (U if ddpg_do else 0)
        metrics = {'obj_critic': sums[0] / U,
                   'obj_actor': sums[1] / torch.clamp(sums[2], min=1.0)}
        s = s._replace(act_opt=s.act_opt._replace(count=ca0 + n_act),
                       cri_opt=s.cri_opt._replace(count=cc0 + U))
        return s, buf_state, metrics

    def cum_returns(s, rollout, last_obs):
        """Discounted returns bootstrapped with ``mean_E Q_target(last,
        act_target(last))``."""
        with torch.no_grad():
            na = ddpg_actor(split_flat(s.act_target, act_shapes), last_obs)
            next_v = torch.mean(ddpg_q_values(split_flat(s.cri_target, cri_shapes),
                                              last_obs, na), dim=-1)
            return cumulative_returns(rollout.rewards, rollout.undones, next_v, gamma)

    name = ('AgentTD3' if td3 else 'AgentDDPG') + ('Hterm' if hterm else '')
    return AgentDef(name=name, if_off_policy=True, if_discrete=False, init=init,
                    explore_action=explore_action, greedy_action=greedy_action,
                    env_action=lambda a: a, update=fused_update if fused else scan_update,
                    state_to_numpy=partial(_ddpg_to_numpy, act_shapes=act_shapes,
                                           cri_shapes=cri_shapes),
                    state_from_numpy=_ddpg_from_numpy, cum_returns=cum_returns,
                    pre_update=window_harvest(gamma, h_term_k_step) if hterm else None)


def _ddpg_to_numpy(s, act_shapes, cri_shapes):
    from ..utils.jax_params import ddpg_state_to_numpy
    return ddpg_state_to_numpy(s, act_shapes, cri_shapes)


def _ddpg_from_numpy(tree, device):
    from ..utils.jax_params import ddpg_state_from_numpy
    return ddpg_state_from_numpy(tree, device)


make_td3 = partial(_make, td3=True)
make_ddpg = partial(_make, td3=False)
make_td3_hterm = partial(_make, td3=True, hterm=True)
make_ddpg_hterm = partial(_make, td3=False, hterm=True)


class AgentTD3:
    make = staticmethod(make_td3)


class AgentDDPG:
    make = staticmethod(make_ddpg)


class AgentTD3Hterm:
    make = staticmethod(make_td3_hterm)


class AgentDDPGHterm:
    make = staticmethod(make_ddpg_hterm)
