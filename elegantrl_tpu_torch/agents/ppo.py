"""PPO and A2C, continuous and discrete (counterpart of
``elegantrl_tpu/agents/ppo.py``).

- actor: MLP -> Normal(mean, exp(std_log)) with a learned global
  ``std_log``; the env acts on ``tanh(sample)`` while the raw sample is
  stored for the ratio.  Discrete: MLP -> logits, no ``std_log``; the action
  is a categorical sample (greedy: argmax) stored as an int32 index without
  a feature axis, ``(H, N)`` in both rollout layouts;
- state normalisation ``(obs - avg) / (std + 1e-4)`` shared by actor and
  critic, updated with tau ``state_value_tau`` after each update;
- truncation bootstrap, V-trace (or plain) GAE, strided-std advantage
  normalisation;
- U = ``int(H * repeat_times / batch_size)`` minibatches of uniformly
  sampled flat (t, env) ids, gathered from either rollout layout
  (``(H, N, S)`` or the kernel-native ``(H, S, N)`` 'tsn' layout);
- the double-sided clipped surrogate by default, the single-sided
  reference form with ``args.if_single_sided_clip``; the entropy term has
  the reference's sign (``surrogate - lambda * entropy`` is maximised);
- A2C: each minibatch is ``batch_size`` whole time-slices ``ids0 ~ U[0, H)``,
  the objective is the unclipped ``mean(adv * logp * unmask)`` with the
  entropy as a bonus, and no stored logprob is used.  The JAX package runs
  this update as XLA autodiff and has no kernel for it, so here it is
  ``torch.autograd`` over the losses of ``ops/fused_update.py`` followed by
  ``grad_step``, on either device;
- ``AgentPPOHterm`` (continuous PPO only): each update first inserts every
  env's best k-step window (quality: the GAE target at the window start)
  into the ring of ``agents/hterm.py``; the actor loss subtracts
  ``h_term_lambda`` times the return-weighted log-likelihood of rehearsed
  windows' actions.  The JAX package runs it on XLA ops, without either
  kernel, so here its rollout is ``collect_rollout`` and its update
  ``torch.autograd``, on either device.
- The PPO update takes the fused update kernel (``ops/fused_update.py``)
  exactly where the JAX package takes its Pallas update: 2 hidden layers,
  ``batch_size % 128 == 0``, ``batch_size <= 2048``, float32 compute and the
  minibatch blocks within 8 MiB (:func:`jax_takes_fused_update`).  Elsewhere
  (a 3-layer net, batch 4096) the JAX package runs its minibatch scan on XLA
  autodiff, and here the same minibatch loop runs on ``torch.autograd``, on
  either device.

- The V-trace recursion runs K10 (``ops/kernels.py:gae_vtrace_kernel``,
  ``use_gae_kernel``) and the no-grad actor and critic forwards (the
  generic rollout's, the evaluator's, the value pass) run K11b
  (``fused_mlp3``, ``use_mlp3_kernel``) on a card; gradient paths run
  PyTorch ops.

Actor and critic are ``nn.Module`` views of two flat parameter buffers
(``ops/nets.py:bind_flat``); the update changes the buffers in place.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch
from torch import nn

from ..config import select_kernel
from ..ops import dists, gae, kernels
from ..ops.fused_update import (a2c_actor_loss, actor_loss, critic_loss,
                                fused_update_bytes, make_ppo_fused_update, update_fits,
                                value_and_grad_flat)
from ..ops.nets import (MLP, bind_flat, mlp3_forward, mlp_apply_leaves, mlp_init,
                        ppo_param_shapes, split_flat)
from .base import (AdamState, AgentDef, Rollout, grad_step, make_optimizer,
                   sample_flat_ids, split_flat_ids)
from .hterm import (HtermBuffer, init_hterm_buffer, insert_best_windows, masked_window_mean,
                    rehearsal_sample, return_bounds)

# hidden width from which the JAX package's compute_dtype='auto' picks bf16
BF16_AUTO_MIN_WIDTH = 512


class Actor(nn.Module):
    """Gaussian policy: ``mean = mlp(x)``, ``std = exp(std_log)``; with
    ``discrete`` a categorical policy: ``logits = mlp(x)``, no ``std_log``."""

    def __init__(self, mlp: MLP, action_dim: int, discrete: bool = False):
        super().__init__()
        self.mlp = mlp
        self.std_log = None if discrete else nn.Parameter(torch.zeros(1, action_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x)

    def leaves(self):
        """Parameters in the flat-buffer order: the MLP's, then std_log."""
        leaves = self.mlp.leaves()
        return leaves if self.std_log is None else [*leaves, self.std_log]


class PPOState(NamedTuple):
    act: Actor
    cri: MLP
    act_flat: torch.Tensor   # actor parameters, one buffer (act's params are views)
    cri_flat: torch.Tensor
    act_opt: AdamState
    cri_opt: AdamState
    norm_avg: torch.Tensor   # (S,)
    norm_std: torch.Tensor   # (S,)


class PPOHtermState(NamedTuple):
    act: Actor
    cri: MLP
    act_flat: torch.Tensor
    cri_flat: torch.Tensor
    act_opt: AdamState
    cri_opt: AdamState
    norm_avg: torch.Tensor
    norm_std: torch.Tensor
    h_buf: HtermBuffer


def modules_from_flat(act_flat: torch.Tensor, cri_flat: torch.Tensor,
                      state_dim: int, net_dims, action_dim: int, discrete: bool = False):
    """Actor and critic modules whose parameters are views of the given
    flat buffers (layout ``ops/nets.py:ppo_param_shapes``)."""
    dims = (state_dim, *net_dims)

    def mlp(out_dim):
        return MLP([nn.utils.skip_init(nn.Linear, i, o)
                    for i, o in zip(dims, (*dims[1:], out_dim))])

    act, cri = Actor(mlp(action_dim), action_dim, discrete), mlp(1)
    act_shapes, cri_shapes = ppo_param_shapes(state_dim, net_dims, action_dim, discrete)
    for module, flat, shapes in ((act, act_flat, act_shapes), (cri, cri_flat, cri_shapes)):
        for p, view in zip(module.leaves(), split_flat(flat, shapes)):
            p.data = view
        module.requires_grad_(False)
    return act, cri


def norm_state(obs, avg, std):
    return (obs - avg) / (std + 1e-4)


def resolve_compute_dtype(args, net_dims) -> str:
    """``args.compute_dtype`` as 'float32' or 'bfloat16' ('auto' picks
    bf16 when every hidden width is at least 512, as the JAX package)."""
    mode = str(getattr(args, 'compute_dtype', 'auto'))
    if mode == 'auto':
        dims = tuple(net_dims or ())
        return 'bfloat16' if dims and min(dims) >= BF16_AUTO_MIN_WIDTH else 'float32'
    return mode


def jax_takes_fused_update(net_dims, state_dim: int, action_dim: int, batch_size: int,
                           update_times: int) -> bool:
    """The JAX package's eligibility for its fused PPO update, term by term
    (``elegantrl_tpu/agents/ppo.py:_fused_update``), for (Discrete)PPO
    without the H-term in float32 (the only compute type here): 2 hidden
    layers, a batch that is a multiple of 128 and at most 2048, and the
    minibatch blocks with three copies of both nets within 8 MiB."""
    net_dims = tuple(net_dims)
    if not (len(net_dims) == 2 and batch_size % 128 == 0 and batch_size <= 2048):
        return False
    n_params = (state_dim * net_dims[0] + net_dims[0] + net_dims[0] * net_dims[1]
                + net_dims[1] + net_dims[1] * (action_dim + 1) + action_dim + 1) * 2
    return fused_update_bytes(update_times, batch_size, state_dim, action_dim,
                              n_params) <= 8 * 2 ** 20


def make_ppo(net_dims, state_dim: int, action_dim: int, args, buffer=None,
             discrete: bool = False, a2c: bool = False, hterm: bool = False) -> AgentDef:
    """Factory; ``args`` is read with ``getattr``, as in the JAX package."""
    if hterm and (discrete or a2c):
        raise ValueError('H-term is supported for continuous PPO only')
    if resolve_compute_dtype(args, net_dims) != 'float32' \
            or str(getattr(args, 'storage_dtype', 'float32')) != 'float32':
        raise NotImplementedError('the PyTorch port computes and stores in float32 only; '
                                  "set args.compute_dtype = args.storage_dtype = 'float32'")
    gamma = float(getattr(args, 'gamma', 0.99))
    lr = float(getattr(args, 'learning_rate', 6e-5))
    clip_grad = float(getattr(args, 'clip_grad_norm', 3.0))
    ratio_clip = float(getattr(args, 'ratio_clip', 0.25))
    lambda_gae_adv = float(getattr(args, 'lambda_gae_adv', 0.95))
    lambda_entropy = float(getattr(args, 'lambda_entropy', 0.01 if discrete else 0.001))
    if_use_vtrace = bool(getattr(args, 'if_use_vtrace', getattr(args, 'if_use_v_trace', True)))
    if_single_sided_clip = bool(getattr(args, 'if_single_sided_clip', False))
    state_value_tau = float(getattr(args, 'state_value_tau', 0.0))
    batch_size = int(getattr(args, 'batch_size', 128))
    repeat_times = float(getattr(args, 'repeat_times', 8.0))
    h_term_lambda = float(getattr(args, 'h_term_lambda', 2 ** -3))
    h_term_drop_rate = float(getattr(args, 'h_term_drop_rate', 2 ** -2))
    h_term_k_step = int(getattr(args, 'h_term_k_step', 16))
    h_term_buffer_size = int(getattr(args, 'h_term_buffer_size', 2 ** 12))
    h_batch = max(1, int(batch_size * h_term_drop_rate))
    net_dims = tuple(int(d) for d in net_dims)
    optimizer = make_optimizer(lr, clip_grad)
    hypers = dict(net_dims=net_dims, ratio_clip=ratio_clip,
                  lambda_entropy=lambda_entropy, lr=lr, clip_grad=clip_grad,
                  single_sided=if_single_sided_clip, discrete=discrete)
    act_shapes, cri_shapes = ppo_param_shapes(state_dim, net_dims, action_dim, discrete)

    if a2c:
        # no kernel exists for A2C's update in either package: it is autograd
        # on both devices, so only an explicit request for the kernel is refused
        if getattr(args, 'use_fused_update', 'auto') is True:
            raise ValueError('use_fused_update=True requires (Discrete)PPO: the A2C '
                             'update has no fused kernel')
    elif hterm:
        # the JAX package runs the H-term update as XLA autodiff
        # (elegantrl_tpu/agents/ppo.py:118): PyTorch ops on either device
        select_kernel(args, 'use_fused_update', False, False, getattr(args, 'device', 'cuda'),
                      '(Discrete)PPO without the H-term')
    kernel_choice = {}   # horizon_len -> whether the fused update runs

    def use_fused_update(horizon_len: int) -> bool:
        """``config.py:select_kernel`` for this horizon (decided once, at
        build time for ``args.horizon_len``): the fused update
        (``ops/fused_update.py:ppo_update``, the CUDA kernel on a card and
        its plain version on the CPU) where the JAX package takes its kernel,
        else the autograd minibatch loop."""
        if horizon_len not in kernel_choice:
            update_times = max(1, int(horizon_len * repeat_times / batch_size))
            kernel_choice[horizon_len] = select_kernel(
                args, 'use_fused_update',
                jax_takes_fused_update(net_dims, state_dim, action_dim, batch_size,
                                       update_times),
                update_fits(net_dims),
                getattr(args, 'device', 'cuda'),
                '(Discrete)PPO with a 2-hidden-layer MLP of any widths, batch_size a '
                'multiple of 128 and <= 2048, and minibatch blocks '
                f'within 8 MiB; got net_dims={net_dims}, batch_size={batch_size}, '
                f'update_times={update_times}')
        return kernel_choice[horizon_len]

    if not (a2c or hterm):
        use_fused_update(int(getattr(args, 'horizon_len', 2048)))
    device = getattr(args, 'device', 'cuda')
    # K10 (ops/kernels.py) computes the V-trace recursion; K11b the no-grad
    # forwards of the actor and the critic (the rollout's, the evaluator's and
    # the value pass), both 3-linear MLPs of the same hidden widths
    use_gae_kernel = kernels.select(
        args, 'use_gae_kernel', if_use_vtrace, device,
        f'V-trace advantages; got if_use_vtrace={if_use_vtrace}')
    use_mlp3 = kernels.select(
        args, 'use_mlp3_kernel', kernels.mlp3_fits((state_dim, *net_dims, action_dim)),
        device, f'the no-grad forward of a 3-linear f32 MLP whose tiles fit one block; '
                f'got net_dims={net_dims}')

    def init(seed: int, device) -> PPOState:
        gen = torch.Generator().manual_seed(int(seed))
        act = Actor(mlp_init(gen, (state_dim, *net_dims, action_dim), out_std=0.1),
                    action_dim, discrete)
        cri = mlp_init(gen, (state_dim, *net_dims, 1), out_std=0.5)
        act.requires_grad_(False)
        cri.requires_grad_(False)
        act_flat = bind_flat(act.leaves(), device)
        cri_flat = bind_flat(cri.leaves(), device)
        base = (act, cri, act_flat, cri_flat, optimizer.init(act_flat),
                optimizer.init(cri_flat), torch.zeros(state_dim, device=device),
                torch.ones(state_dim, device=device))
        if not hterm:
            return PPOState(*base)
        return PPOHtermState(*base, init_hterm_buffer(h_term_buffer_size, h_term_k_step,
                                                      state_dim, action_dim, device))

    def critic_value(s: PPOState, obs):
        return mlp3_forward(s.cri.leaves(), norm_state(obs, s.norm_avg, s.norm_std),
                            use_mlp3)[..., 0]

    def actor_out(s: PPOState, obs):
        return mlp3_forward(s.act.mlp.leaves(), norm_state(obs, s.norm_avg, s.norm_std),
                            use_mlp3)

    def explore_action(s: PPOState, obs, gen):
        out = actor_out(s, obs)
        if discrete:
            action = dists.categorical_sample(gen, out)
            return action.to(torch.int32), dists.categorical_logprob(out, action)
        std = torch.exp(s.act.std_log)
        action = dists.normal_sample(gen, out, std.expand_as(out))
        logprob = torch.sum(dists.normal_logprob(action, out, std), dim=-1)
        return action, logprob

    def greedy_action(s: PPOState, obs):
        out = actor_out(s, obs)
        if discrete:
            return torch.argmax(out, dim=-1).to(torch.int32)
        return torch.tanh(out)

    def env_action(action):
        return action if discrete else torch.tanh(action)

    def rollout_values(s: PPOState, obs):
        return {'values': critic_value(s, obs)}

    def one_hot(index):
        return torch.nn.functional.one_hot(index.long(), action_dim).float()

    def a2c_minibatches(s: PPOState, states, actions, advantages, reward_sums, unmasks,
                        tsn, ids):
        """``ids (U, B)`` time-slice ids; each minibatch is the ``(B, N)``
        block of whole slices.  Critic step, then actor step, as the JAX
        scan body."""
        act_opt, cri_opt = s.act_opt, s.cri_opt
        objs = []
        for ids0 in ids:
            state = torch.movedim(states[ids0], 1, 2) if tsn else states[ids0]
            if discrete:
                action = one_hot(actions[ids0])                       # (B, N, A)
            else:
                action = torch.movedim(actions[ids0], 1, 2) if tsn else actions[ids0]
            xn = norm_state(state.float(), s.norm_avg, s.norm_std)
            adv, rs, um = advantages[ids0], reward_sums[ids0], unmasks[ids0]
            obj_c, g_cri = value_and_grad_flat(
                lambda leaves: critic_loss(leaves, xn, rs, um), s.cri_flat, cri_shapes)
            (_, obj_s, obj_e), g_act = value_and_grad_flat(
                lambda leaves: a2c_actor_loss(leaves, xn, action, adv, um, lambda_entropy,
                                              discrete), s.act_flat, act_shapes)
            cri_opt = grad_step(optimizer, s.cri_flat, cri_opt, g_cri)
            act_opt = grad_step(optimizer, s.act_flat, act_opt, g_act)
            objs.append(torch.stack([obj_c, obj_s, obj_e]).detach())
        objs = torch.stack(objs).mean(0)
        metrics = {'obj_critic': objs[0], 'obj_actor': objs[1], 'obj_entropy': objs[2]}
        return s._replace(act_opt=act_opt, cri_opt=cri_opt), metrics

    def ppo_minibatches(s, states, actions, logprobs, advantages, reward_sums, unmasks,
                        tsn, ids, h_ids=None):
        """The PPO minibatch loop on ``torch.autograd`` (the JAX package's
        scan, ``elegantrl_tpu/agents/ppo.py:update``): per minibatch of flat
        ids a critic step, then an actor step on the PPO loss, from which the
        H-term agent subtracts ``h_term_lambda`` times the rehearsal objective
        over slots ``h_ids``.  Gathers from either rollout layout."""
        if hterm:
            r_min, r_max = return_bounds(s.h_buf)
        ids0, ids1 = split_flat_ids(ids, states.shape[0])
        act_opt, cri_opt = s.act_opt, s.cri_opt
        objs = []
        for u in range(ids.shape[0]):
            i0, i1 = ids0[u], ids1[u]
            state = states[i0, :, i1] if tsn else states[i0, i1]
            if discrete:
                action = one_hot(actions[i0, i1])
            else:
                action = actions[i0, :, i1] if tsn else actions[i0, i1]
            xn = norm_state(state.float(), s.norm_avg, s.norm_std)
            obj_c, g_cri = value_and_grad_flat(
                lambda lv: critic_loss(lv, xn, reward_sums[i0, i1], unmasks[i0, i1]),
                s.cri_flat, cri_shapes)
            cri_opt = grad_step(optimizer, s.cri_flat, cri_opt, g_cri)
            if hterm:
                hs, ha, hm, w, valid = rehearsal_sample(s.h_buf, h_ids[u], r_min, r_max)
                hxn = norm_state(hs, s.norm_avg, s.norm_std)

            def loss(lv):
                out = actor_loss(lv, xn, action, logprobs[i0, i1], advantages[i0, i1],
                                 unmasks[i0, i1], ratio_clip, lambda_entropy,
                                 if_single_sided_clip, discrete)
                if not hterm:
                    return out
                mean_h = mlp_apply_leaves(lv[:-1], hxn)
                lp = torch.sum(dists.normal_logprob(ha, mean_h, torch.exp(lv[-1])), dim=-1)
                return (out[0] - h_term_lambda * masked_window_mean(lp, hm, w, valid),
                        *out[1:])

            (_, obj_s, obj_e), g_act = value_and_grad_flat(loss, s.act_flat, act_shapes)
            act_opt = grad_step(optimizer, s.act_flat, act_opt, g_act)
            objs.append(torch.stack([obj_c, obj_s, obj_e]).detach())
        objs = torch.stack(objs).mean(0)
        metrics = {'obj_critic': objs[0], 'obj_actor': objs[1], 'obj_entropy': objs[2]}
        return s._replace(act_opt=act_opt, cri_opt=cri_opt), metrics

    def update(s: PPOState, rollout: Rollout, last_obs, gen, ids=None, h_ids=None):
        """``ids``: optional ``(U, B)`` minibatch ids (tests inject the JAX
        package's): flat (t, env) ids for PPO, time-slice ids for A2C; drawn
        from ``gen`` otherwise.  ``h_ids``: the H-term agent's ``(U,
        h_batch)`` rehearsal slot ids, likewise."""
        horizon_len, num_envs = rollout.rewards.shape
        states, actions = rollout.states, rollout.actions
        tsn = rollout.extras is not None and 'tsn' in rollout.extras
        with torch.no_grad():
            if rollout.extras is not None and 'values' in rollout.extras:
                values = rollout.extras['values']
            else:
                flat = torch.movedim(states, 1, 2) if tsn else states
                values = critic_value(s, flat)
            rewards_b, undones_b = gae.apply_truncation_bootstrap(
                rollout.rewards, rollout.undones, rollout.unmasks, values)
            next_value = critic_value(s, last_obs)
            if if_use_vtrace:
                advantages = gae.gae_vtrace(rewards_b, undones_b, values, next_value,
                                            gamma, lambda_gae_adv, use_kernel=use_gae_kernel)
            else:
                advantages = gae.gae_plain(rewards_b, undones_b, values, gamma,
                                           lambda_gae_adv)
            reward_sums = advantages + values
            advantages = gae.normalize_advantages(advantages)

            update_times = max(1, int(horizon_len * repeat_times / batch_size))
            if hterm:   # the window quality is the GAE target at the window start
                k_step = min(h_term_k_step, horizon_len)
                s = s._replace(h_buf=insert_best_windows(
                    s.h_buf, states, actions, rollout.undones, rollout.unmasks,
                    reward_sums[:horizon_len - k_step + 1], h_term_k_step))
                if ids is None:
                    ids = sample_flat_ids(gen, horizon_len, num_envs, batch_size,
                                          update_times, states.device)
                if h_ids is None:
                    h_ids = torch.randint(0, max(s.h_buf.count, 1), (update_times, h_batch),
                                          generator=gen, device=states.device)
                s, metrics = ppo_minibatches(s, states, actions, rollout.logprobs, advantages,
                                             reward_sums, rollout.unmasks, tsn, ids, h_ids)
            elif a2c:
                if ids is None:
                    ids = torch.randint(0, horizon_len, (update_times, batch_size),
                                        generator=gen, device=states.device)
                s, metrics = a2c_minibatches(s, states, actions, advantages, reward_sums,
                                             rollout.unmasks, tsn, ids)
            elif not use_fused_update(horizon_len):
                if ids is None:
                    ids = sample_flat_ids(gen, horizon_len, num_envs, batch_size,
                                          update_times, states.device)
                s, metrics = ppo_minibatches(s, states, actions, rollout.logprobs, advantages,
                                             reward_sums, rollout.unmasks, tsn, ids)
            else:
                if ids is None:
                    ids = sample_flat_ids(gen, horizon_len, num_envs, batch_size,
                                          update_times, states.device)
                ids0, ids1 = split_flat_ids(ids, horizon_len)
                # (H, S, N)[ids0, :, ids1] or (H, N, S)[ids0, ids1] -> (U, B, S)
                sb = states[ids0, :, ids1] if tsn else states[ids0, ids1]
                if discrete:      # (H, N) indices in both layouts -> one-hot (U, B, A)
                    ab = one_hot(actions[ids0, ids1])
                else:
                    ab = actions[ids0, :, ids1] if tsn else actions[ids0, ids1]
                sb = sb.transpose(1, 2).float().contiguous()          # (U, S, B)
                ab = ab.transpose(1, 2).float().contiguous()          # (U, A, B)
                blocks = [t[ids0, ids1].contiguous() for t in
                          (rollout.logprobs, advantages, reward_sums, rollout.unmasks)]
                fused = make_ppo_fused_update(state_dim, action_dim, batch_size,
                                              update_times, **hypers)
                s, metrics = fused(s, sb, ab, *blocks)

            if state_value_tau > 0:
                flat = (torch.movedim(states, 1, 2) if tsn else states)
                flat = flat.reshape(-1, flat.shape[-1]).float()
                tau = state_value_tau
                norm_avg = s.norm_avg * (1 - tau) + flat.mean(dim=0) * tau
                norm_std = torch.clamp(s.norm_std * (1 - tau)
                                       + flat.std(dim=0, unbiased=False) * tau, min=1e-4)
                s = s._replace(norm_avg=norm_avg, norm_std=norm_std)
        return s, metrics

    name = ('AgentDiscreteA2C' if (discrete and a2c) else
            'AgentDiscretePPO' if discrete else
            'AgentA2C' if a2c else 'AgentPPOHterm' if hterm else 'AgentPPO')
    return AgentDef(name=name, if_off_policy=False, if_discrete=discrete,
                    init=init, explore_action=explore_action,
                    greedy_action=greedy_action,
                    env_action=env_action, update=update,
                    rollout_extras=rollout_values,
                    state_to_numpy=_ppo_to_numpy, state_from_numpy=_ppo_from_numpy)


def _ppo_to_numpy(s):
    from ..utils.jax_params import ppo_state_to_numpy
    return ppo_state_to_numpy(s)


def _ppo_from_numpy(tree, device):
    from ..utils.jax_params import ppo_state_from_numpy
    return ppo_state_from_numpy(tree, device)


# Class-style markers for ``Config(agent_class=...)``.
class AgentPPO:
    make = staticmethod(partial(make_ppo, discrete=False, a2c=False))


class AgentA2C:
    make = staticmethod(partial(make_ppo, discrete=False, a2c=True))


class AgentDiscretePPO:
    make = staticmethod(partial(make_ppo, discrete=True, a2c=False))


class AgentDiscreteA2C:
    make = staticmethod(partial(make_ppo, discrete=True, a2c=True))


class AgentPPOHterm:
    """Continuous PPO with the H-term (hypers ``h_term_lambda`` 2**-3,
    ``h_term_drop_rate`` 2**-2, ``h_term_k_step`` 16, ``h_term_buffer_size``
    2**12)."""
    make = staticmethod(partial(make_ppo, discrete=False, a2c=False, hterm=True))
