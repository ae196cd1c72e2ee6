"""SAC and ModSAC and their H-term variants (counterpart of
``elegantrl_tpu/agents/sac.py``).

- SAC: the actor's encoder ``S -> net_dims`` with a trailing GELU feeds one
  head emitting ``(mean, log_std)``, ``log_std`` clipped to (-16, 2); the
  stored and stepped action is ``tanh(mean + exp(log_std) z)``; the logprob
  is the reference's density at the mean with the ``log(1.000001 - a^2)``
  correction;
- ModSAC: the raw encoding feeds separate ``avg`` and ``std`` heads,
  ``log_std`` clipped to (-20, 2), the softplus-form logprob, an actor
  target, and the gate ``upd_a / (t + 1) < 1 / (2 - e^-1)`` on the actor
  step (``upd_a`` restarts at update 0 of every round);
- critic: an ensemble of Q heads (E = ``num_ensembles``, 4 for SAC, 8 for
  ModSAC) over one linear encoder of ``[s, a]``; the TD target takes the
  min over the target heads;
- temperature: ``alpha_log`` (initially -1) with its own clip + Adam on
  ``mean(alpha_log (te - logp))``, clipped to [-16, 2] after each step;
  ``te = +log(A)`` for SAC and ``-log(A)`` for ModSAC, the reference's
  quirks kept;
- prioritised replay (``if_use_per``): the critic loss ``mean(td *
  is_weight)`` and the per-sample ``td`` written back as priorities;
  ``lambda_fit_cum_r`` adds the cumulative-return term on the heads;
  ``cum_returns`` bootstraps with ``mean_E Q_target(last, tanh(mean))`` of
  the actor (ModSAC: of the actor target);
- H-term (``AgentSACHterm``, ``AgentModSACHterm``): ``pre_update`` harvests
  each env's best window into the ring of ``agents/hterm.py``; the actor
  loss subtracts ``h_term_lambda`` times the return-weighted log-likelihood
  of rehearsed windows' actions (inverted through a clipped atanh).

The actor, critic and targets are flat buffers (``ops/nets.py:
sac_act_shapes``, ``sac_cri_shapes``).  The update is the fused chunk
(``ops/fused_offpolicy_update.py:sac_chunk``: the CUDA kernel on a card, its
plain version on the CPU) wherever the JAX package takes its Pallas chunk
(not under PER, ``lambda_fit_cum_r`` or the H-term), else the scan path of
``agents/off_policy.py`` (``torch.autograd``) on either device.  Both
consume the same draws, made once per round: the minibatch ids and, per
update, a next-action and a policy-gradient noise block, ``(U, 2, B, A)``.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Optional

import torch

from ..config import select_kernel
from ..ops import kernels
from ..ops.fused_offpolicy_update import (modsac_do_actor, sac_action_logprob,
                                          sac_actor_dist, sac_actor_loss, sac_bcv, sac_chunk,
                                          sac_fits, sac_q_values, sac_td_label)
from ..ops.fused_update import value_and_grad_flat
from ..ops.gae import cumulative_returns
from ..ops.nets import init_flat, sac_act_shapes, sac_cri_shapes, soft_update_, split_flat
from .base import AdamState, AgentDef, grad_step, make_optimizer
from .dqn import FUSED_CHUNK, gather_chunk, row_sampling
from .hterm import (HtermBuffer, HtermDraws, draw_rehearsal_ids, init_hterm_buffer,
                    masked_window_mean, rehearsal_sample, return_bounds, window_harvest)
from .off_policy import cum_fit_term, make_offpolicy_update, offpolicy_update_times


class SACState(NamedTuple):
    act: torch.Tensor                  # flat actor (ops/nets.py:sac_act_shapes)
    act_target: Optional[torch.Tensor]  # ModSAC only
    cri: torch.Tensor                  # flat critic ensemble (sac_cri_shapes)
    cri_target: torch.Tensor
    act_opt: AdamState
    cri_opt: AdamState
    alpha_log: torch.Tensor            # () float32, updated in place
    alpha_opt: AdamState               # over alpha_log: () moments
    update_a: int                      # ModSAC's actor-update counter


class SACHtermState(NamedTuple):
    act: torch.Tensor
    act_target: Optional[torch.Tensor]
    cri: torch.Tensor
    cri_target: torch.Tensor
    act_opt: AdamState
    cri_opt: AdamState
    alpha_log: torch.Tensor
    alpha_opt: AdamState
    update_a: int
    h_buf: HtermBuffer


def make_sac(net_dims, state_dim: int, action_dim: int, args, buffer=None,
             modsac: bool = False, hterm: bool = False) -> AgentDef:
    gamma = float(getattr(args, 'gamma', 0.99))
    lr = float(getattr(args, 'learning_rate', 6e-5))
    clip_grad = float(getattr(args, 'clip_grad_norm', 3.0))
    tau = float(getattr(args, 'soft_update_tau', 5e-3))
    batch_size = int(getattr(args, 'batch_size', 64))
    repeat_times = float(getattr(args, 'repeat_times', 1.0))
    if_use_per = bool(getattr(args, 'if_use_per', False))
    lambda_fit_cum_r = float(getattr(args, 'lambda_fit_cum_r', 0.0))
    row_sample = row_sampling(args, buffer, batch_size)
    num_ensembles = int(getattr(args, 'num_ensembles', 8 if modsac else 4))
    if modsac:
        target_entropy = float(getattr(args, 'target_entropy', -math.log(action_dim)))
    else:
        target_entropy = math.log(action_dim)
    std_clip = (-20.0, 2.0) if modsac else (-16.0, 2.0)
    h_term_lambda = float(getattr(args, 'h_term_lambda', 2 ** -3))
    h_term_drop_rate = float(getattr(args, 'h_term_drop_rate', 2 ** -2))
    h_term_k_step = int(getattr(args, 'h_term_k_step', 16))
    h_term_buffer_size = int(getattr(args, 'h_term_buffer_size', 2 ** 12))
    h_batch = max(1, int(batch_size * h_term_drop_rate))
    net_dims = tuple(int(d) for d in net_dims)
    S, A, E = state_dim, action_dim, num_ensembles
    act_shapes = sac_act_shapes(S, net_dims, A, modsac)
    cri_shapes = sac_cri_shapes(S, A, net_dims, E)
    optimizer = make_optimizer(lr, clip_grad)
    sac = dict(modsac=modsac, std_clip=std_clip)
    hypers = dict(net_dims=net_dims, num_ensembles=E, gamma=gamma, tau=tau, lr=lr,
                  clip_grad=clip_grad, target_entropy=target_entropy, **sac)

    def init(seed: int, device):
        gen = torch.Generator().manual_seed(int(seed))
        d = net_dims[-1]
        heads = [((d, A), 0.1), ((d, A), 0.1)] if modsac else [((d, 2 * A), 0.1)]
        act = init_flat(gen, [((S, *net_dims), None)] + heads, device)
        cri = init_flat(gen, [((S + A, net_dims[0]), None)] + [((*net_dims, 1), 0.5)] * E,
                        device)
        alpha_log = torch.full((), -1.0, device=device)
        base = (act, act.clone() if modsac else None, cri, cri.clone(), optimizer.init(act),
                optimizer.init(cri), alpha_log, optimizer.init(alpha_log), 0)
        if not hterm:
            return SACState(*base)
        return SACHtermState(*base, init_hterm_buffer(h_term_buffer_size, h_term_k_step, S, A,
                                                      device))

    # the actor is an encoder and heads, not a 3-linear MLP: K11b does not
    # take its forward (PyTorch ops, said so)
    kernels.select(args, 'use_mlp3_kernel', False, getattr(args, 'device', 'cuda'),
                   'the no-grad forward of a 3-linear f32 MLP; got the '
                   f'{"ModSAC" if modsac else "SAC"} actor (an encoder and heads)')

    def explore_action(s: SACState, obs, gen, z=None):
        mean, log_std = sac_actor_dist(split_flat(s.act, act_shapes), obs, **sac)
        if z is None:   # else the injected normals (the host rollout's noise)
            z = torch.randn(mean.shape, generator=gen, device=mean.device)
        return torch.tanh(mean + torch.exp(log_std) * z), None

    def greedy_action(s: SACState, obs):
        return torch.tanh(sac_actor_dist(split_flat(s.act, act_shapes), obs, **sac)[0])

    def update_noise(gen, count):
        """Per update, the next-action and the policy-gradient noise blocks,
        ``(count, 2, B, A)``."""
        return torch.randn((count, 2, batch_size, A), generator=gen, device=gen.device)

    def critic_loss(lv, b, label):
        qs = sac_q_values(lv, b.state, b.action, E)
        td = torch.mean(torch.square(qs - label[:, None]), dim=-1) * b.unmask
        obj = torch.mean(td * b.is_weight) if if_use_per else torch.mean(td)
        if lambda_fit_cum_r != 0.0:
            obj = obj + cum_fit_term(b.cum_r, qs, lambda_fit_cum_r)
        return obj, td

    def actor_loss(lv, cri_leaves, state, noise, alpha, h_ids, h_bounds, h_buf):
        loss = sac_actor_loss(lv, cri_leaves, state, noise, alpha, num_ensembles=E, **sac)
        if hterm:   # the return-weighted likelihood of rehearsed windows' actions
            hs, ha, hm, w, valid = rehearsal_sample(h_buf, h_ids, *h_bounds)
            mean_h, log_std_h = sac_actor_dist(lv, hs, **sac)
            pre = torch.atanh(torch.clamp(ha, -0.999999, 0.999999))
            z = (pre - mean_h) / torch.exp(log_std_h)
            lp_h = torch.sum(-0.5 * torch.square(z) - log_std_h - 0.5 * math.log(2.0 * math.pi)
                             - torch.log(1.000001 - torch.square(ha)), dim=-1)
            loss = loss - h_term_lambda * masked_window_mean(lp_h, hm, w, valid)
        return loss

    def make_objectives(h_bounds):
        return partial(objectives, h_bounds=h_bounds)

    def objectives(s, b, draws, update_t, h_bounds=None):
        noise = draws.noise if hterm else draws
        act_leaves = split_flat(s.act, act_shapes)
        with torch.no_grad():
            label = sac_td_label(act_leaves, split_flat(s.cri_target, cri_shapes), b.next_state,
                                 b.reward, b.undone, noise[0], torch.exp(s.alpha_log), gamma,
                                 num_ensembles=E, **sac)
        (obj_c, td), g_c = value_and_grad_flat(lambda lv: critic_loss(lv, b, label), s.cri,
                                               cri_shapes)
        td = td.detach() if if_use_per else None
        state = b.state
        with torch.no_grad():
            cri_opt = grad_step(optimizer, s.cri, s.cri_opt, g_c)
            soft_update_(s.cri_target, s.cri, tau)
            # the temperature: d mean(alpha_log (te - logp)) / d alpha_log, logp of
            # the pre-update actor
            lp_now = sac_action_logprob(act_leaves, state, noise[1], **sac)[1]
            alpha_opt = grad_step(optimizer, s.alpha_log, s.alpha_opt,
                                  target_entropy - torch.mean(lp_now))
            s.alpha_log.clamp_(-16.0, 2.0)
        do_act, update_a = modsac_do_actor(s.update_a, update_t) if modsac else (True, s.update_a)
        s = s._replace(cri_opt=cri_opt, alpha_opt=alpha_opt, update_a=update_a)
        if not do_act:
            return s, (obj_c.detach(), torch.zeros_like(obj_c.detach()), 0.0), td
        cri_leaves = split_flat(s.cri_target, cri_shapes)
        alpha = torch.exp(s.alpha_log)
        obj_neg, g_a = value_and_grad_flat(
            lambda lv: actor_loss(lv, cri_leaves, state, noise[1], alpha,
                                  draws.h_ids if hterm else None, h_bounds,
                                  s.h_buf if hterm else None), s.act, act_shapes)
        with torch.no_grad():
            act_opt = grad_step(optimizer, s.act, s.act_opt, g_a)
            if modsac:
                soft_update_(s.act_target, s.act, tau)
        return s._replace(act_opt=act_opt), (obj_c.detach(), -obj_neg.detach(), 1.0), td

    def scan_update(s, buf_state, gen, ids=None, noise=None):
        """The scan path; an H-term agent's ``noise`` is ``HtermDraws(noise
        (U, 2, B, A), rehearsal ids (U, h_batch))``."""
        noise_fn = update_noise
        if hterm:
            noise_fn = lambda g, U: HtermDraws(  # noqa: E731
                update_noise(g, U), draw_rehearsal_ids(g, s.h_buf, U, h_batch))
        h_bounds = return_bounds(s.h_buf) if hterm else None   # fixed through the round
        update = make_offpolicy_update(batch_size, repeat_times, buffer, row_sample,
                                       make_objectives(h_bounds), noise_fn)
        return update(s, buf_state, gen, ids=ids, noise=noise)

    # the JAX package's eligibility for its Pallas chunk, term by term
    # (elegantrl_tpu/agents/sac.py:298-332; no mesh): a lane chunk must exist;
    # under bf16 storage (f32_storage false) it runs its scan
    lane_chunk = any(lc <= batch_size and batch_size % lc == 0 and max(net_dims) * lc <= 131072
                     and max(net_dims) <= 128 for lc in (2048, 1024, 512, 256, 128))
    jax_takes = (buffer is not None and not hterm and not if_use_per
                 and lambda_fit_cum_r == 0.0 and len(net_dims) == 2 and batch_size % 128 == 0
                 and batch_size <= 2048 and lane_chunk
                 and getattr(buffer, 'storage_dtype', torch.float32) == torch.float32)
    port_fits = sac_fits(net_dims)
    fused = buffer is not None and select_kernel(
        args, 'use_fused_update', jax_takes, port_fits, getattr(args, 'device', 'cuda'),
        f'a batch that is a multiple of 128 and at most 2048 with a lane chunk (some lc of '
        f'2048, ..., 128 dividing it with max(net_dims) * lc <= 131072), max(net_dims) <= 128, '
        f'a 2-hidden-layer net, the non-H-term agent, uniform '
        f'sampling (no PER), lambda_fit_cum_r=0 and float32 storage (the SAC chunk); got '
        f'batch_size={batch_size}, net_dims={net_dims}, hterm={hterm}, '
        f'if_use_per={if_use_per}, lambda_fit_cum_r={lambda_fit_cum_r}, '
        f"storage_dtype={getattr(args, 'storage_dtype', 'float32')}")

    def fused_update(s: SACState, buf_state, gen, ids=None, noise=None):
        """The chunked update, ``FUSED_CHUNK`` updates per call of
        ``sac_chunk`` over minibatches gathered with the scan path's draws.
        The temperature and the gate live on the device in ``misc`` through
        the round; the counts are known on the host."""
        U = offpolicy_update_times(buf_state.size, repeat_times, batch_size)
        n_chunks = -(-U // FUSED_CHUNK)
        dev = buf_state.states.device
        if ids is None:
            ids = buffer.draw(buf_state, gen, U, batch_size, row_sample)
        if noise is None:
            noise = update_noise(gen, U)
        pad = n_chunks * FUSED_CHUNK - U
        if pad:   # padded steps are masked invalid; their draws are never used
            ids = torch.cat([ids, ids[:1].expand(pad, -1)])
            noise = torch.cat([noise, noise[:1].expand(pad, -1, -1, -1)])
        ca0, cc0, cl0 = s.act_opt.count, s.cri_opt.count, s.alpha_opt.count
        misc = torch.empty((5,), device=dev)
        misc[0:3] = torch.stack([s.alpha_log, s.alpha_opt.mu, s.alpha_opt.nu])
        misc[3] = float(ca0)
        misc[4] = float(s.update_a)
        sums = torch.zeros(3, device=dev)
        for c in range(n_chunks):
            idx = torch.arange(c * FUSED_CHUNK, (c + 1) * FUSED_CHUNK, device=dev)
            sb, nsb, ab, rb, ud, um = gather_chunk(buffer, buf_state, ids[idx], batch_size,
                                                   row_sample)
            nz = noise[idx].transpose(2, 3)                             # (C, 2, A, B)
            objs = sac_chunk(s.act, s.cri, s.act_target, s.cri_target, s.act_opt.mu,
                             s.cri_opt.mu, s.act_opt.nu, s.cri_opt.nu, misc, sb, nsb,
                             ab, rb, ud, um,
                             nz[:, 0].contiguous(), nz[:, 1].contiguous(),
                             sac_bcv(cc0, cl0, idx, U), **hypers)
            valid = (idx < U).float()
            sums += torch.stack([torch.sum(objs[:, 0] * valid), torch.sum(objs[:, 1] * objs[:, 2]),
                                 torch.sum(objs[:, 2])])
        n_act, update_a = U, s.update_a
        if modsac:   # the kernel's gate, replayed on the host for the counts
            n_act = 0
            for t in range(U):
                do_act, update_a = modsac_do_actor(update_a, t)
                n_act += int(do_act)
        with torch.no_grad():
            s.alpha_log.copy_(misc[0])
            s.alpha_opt.mu.copy_(misc[1])
            s.alpha_opt.nu.copy_(misc[2])
        metrics = {'obj_critic': sums[0] / U,
                   'obj_actor': sums[1] / torch.clamp(sums[2], min=1.0)}
        s = s._replace(act_opt=s.act_opt._replace(count=ca0 + n_act),
                       cri_opt=s.cri_opt._replace(count=cc0 + U),
                       alpha_opt=s.alpha_opt._replace(count=cl0 + U), update_a=update_a)
        return s, buf_state, metrics

    def cum_returns(s, rollout, last_obs):
        """Discounted returns bootstrapped with ``mean_E Q_target(last,
        tanh(mean))`` of the actor (ModSAC: of the actor target)."""
        with torch.no_grad():
            act = s.act_target if modsac else s.act
            mean = sac_actor_dist(split_flat(act, act_shapes), last_obs, **sac)[0]
            next_v = torch.mean(sac_q_values(split_flat(s.cri_target, cri_shapes), last_obs,
                                             torch.tanh(mean), E), dim=-1)
            return cumulative_returns(rollout.rewards, rollout.undones, next_v, gamma)

    name = ('AgentModSAC' if modsac else 'AgentSAC') + ('Hterm' if hterm else '')
    return AgentDef(name=name, if_off_policy=True, if_discrete=False, init=init,
                    explore_action=explore_action, greedy_action=greedy_action,
                    env_action=lambda a: a, update=fused_update if fused else scan_update,
                    state_to_numpy=partial(_sac_to_numpy, act_shapes=act_shapes,
                                           cri_shapes=cri_shapes, modsac=modsac,
                                           num_ensembles=E),
                    state_from_numpy=partial(_sac_from_numpy, modsac=modsac),
                    cum_returns=cum_returns,
                    pre_update=window_harvest(gamma, h_term_k_step) if hterm else None)


def _sac_to_numpy(s, act_shapes, cri_shapes, modsac, num_ensembles):
    from ..utils.jax_params import sac_state_to_numpy
    return sac_state_to_numpy(s, act_shapes, cri_shapes, modsac, num_ensembles)


def _sac_from_numpy(tree, device, modsac):
    from ..utils.jax_params import sac_state_from_numpy
    return sac_state_from_numpy(tree, device, modsac)


class AgentSAC:
    make = staticmethod(partial(make_sac, modsac=False))


class AgentModSAC:
    make = staticmethod(partial(make_sac, modsac=True))


class AgentSACHterm:
    make = staticmethod(partial(make_sac, modsac=False, hterm=True))


class AgentModSACHterm:
    make = staticmethod(partial(make_sac, modsac=True, hterm=True))
