"""Pixel-observation PPO (counterpart of ``elegantrl_tpu/agents/pixel.py``):
a ConvNet encoder under PPO heads.  Actor: ConvNet -> GELU -> MLP ->
Normal(mean, exp(std_log)); critic: ConvNet -> GELU -> MLP -> value, each
net with its own conv trunk.  Observations are (H, W, C) images
(``state_dim`` a tuple, H == W a size of ``ops/nets.py:_CONV_STAGES``),
scaled by ``x / 128 - 1`` in place of the running state normaliser.

The PPO math is ``agents/ppo.py``'s: the advantages through
``ops/gae.py:vtrace_advantages`` (K10 on a card, with the truncation
bootstrap and the reward sums), normalised, then per minibatch a critic
step and an actor step of clip-then-Adam.  The update is ``torch.autograd``
and the ConvNet ``torch.nn.functional.conv2d``, as the JAX package runs its
scan and its convolutions as XLA ops (no Pallas kernel): both choices are
printed by ``config.py:select_kernel``.  Each net is one flat buffer
(``act``, ``cri``) whose leaves are views: the conv leaves
(``ops/nets.py:convnet_shapes``), then the MLP's, then (actor) ``std_log``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import select_kernel
from ..ops import dists, gae, kernels
from ..ops.fused_update import value_and_grad_flat
from ..ops.nets import (bind_flat, convnet_apply, convnet_init, convnet_shapes, gelu,
                        mlp_apply_leaves, mlp_init, mlp_shapes, split_flat)
from .base import AdamState, AgentDef, Rollout, grad_step, make_optimizer, sample_flat_ids, \
    split_flat_ids


class PixelPPOState(NamedTuple):
    act: torch.Tensor        # flat: conv leaves, MLP leaves, std_log (1, A)
    cri: torch.Tensor        # flat: conv leaves, MLP leaves
    act_opt: AdamState
    cri_opt: AdamState


def pixel_ppo_shapes(state_dim, net_dims, action_dim: int, feat_dim: int):
    """Leaf shapes of the flat actor and critic buffers."""
    image_size, _, channels = state_dim
    conv = convnet_shapes(channels, feat_dim, image_size)
    return (conv + mlp_shapes((feat_dim, *net_dims, action_dim)) + [(1, action_dim)],
            conv + mlp_shapes((feat_dim, *net_dims, 1)))


def make_pixel_ppo(net_dims, state_dim, action_dim: int, args, buffer=None) -> AgentDef:
    """``state_dim`` is the image shape (H, W, C), H == W in
    ``ops/nets.py:_CONV_STAGES`` (64, 112, 224)."""
    image_size, _, channels = (int(d) for d in state_dim)
    feat_dim = int(getattr(args, 'encoder_dim', 128))
    gamma = float(getattr(args, 'gamma', 0.99))
    lr = float(getattr(args, 'learning_rate', 6e-5))
    clip_grad = float(getattr(args, 'clip_grad_norm', 3.0))
    ratio_clip = float(getattr(args, 'ratio_clip', 0.25))
    lambda_gae_adv = float(getattr(args, 'lambda_gae_adv', 0.95))
    lambda_entropy = float(getattr(args, 'lambda_entropy', 0.001))
    if_use_vtrace = bool(getattr(args, 'if_use_vtrace', True))
    batch_size = int(getattr(args, 'batch_size', 128))
    repeat_times = float(getattr(args, 'repeat_times', 8.0))
    net_dims = tuple(int(d) for d in net_dims)
    optimizer = make_optimizer(lr, clip_grad)
    act_shapes, cri_shapes = pixel_ppo_shapes((image_size, image_size, channels), net_dims,
                                              action_dim, feat_dim)
    n_conv = len(convnet_shapes(channels, feat_dim, image_size))
    device = getattr(args, 'device', 'cuda')
    # the JAX package runs the pixel update as its scan and the ConvNet as
    # XLA convolutions: PyTorch ops here, said so
    select_kernel(args, 'use_fused_update', False, False, device,
                  '(Discrete)PPO on a state vector (the pixel agent has a conv trunk)')
    select_kernel(args, 'use_conv_kernel', False, False, device,
                  'none: the JAX package has no Pallas kernel for its ConvNet')
    use_gae_kernel = kernels.select(args, 'use_gae_kernel', if_use_vtrace, device,
                                    f'V-trace advantages; got if_use_vtrace={if_use_vtrace}')

    def init(seed: int, device) -> PixelPPOState:
        gen = torch.Generator().manual_seed(int(seed))
        act = (convnet_init(gen, channels, feat_dim, image_size)
               + mlp_init(gen, (feat_dim, *net_dims, action_dim), out_std=0.1).leaves()
               + [torch.zeros((1, action_dim))])
        cri = (convnet_init(gen, channels, feat_dim, image_size)
               + mlp_init(gen, (feat_dim, *net_dims, 1), out_std=0.5).leaves())
        act_flat = bind_flat([p.detach() for p in act], device)
        cri_flat = bind_flat([p.detach() for p in cri], device)
        return PixelPPOState(act_flat, cri_flat, optimizer.init(act_flat),
                             optimizer.init(cri_flat))

    def actor_mean(act_leaves, obs):
        feat = convnet_apply(act_leaves[:n_conv], obs, image_size)
        return mlp_apply_leaves(act_leaves[n_conv:-1], gelu(feat))

    def critic_value(cri_leaves, obs):
        feat = convnet_apply(cri_leaves[:n_conv], obs, image_size)
        return mlp_apply_leaves(cri_leaves[n_conv:], gelu(feat))[..., 0]

    def explore_action(s: PixelPPOState, obs, gen, z=None):
        """``z``: standard normals in place of draws from ``gen``."""
        lv = split_flat(s.act, act_shapes)
        mean = actor_mean(lv, obs)
        std = torch.exp(lv[-1])
        action = (dists.normal_sample(gen, mean, std.expand_as(mean)) if z is None
                  else mean + std * z)
        return action, torch.sum(dists.normal_logprob(action, mean, std), dim=-1)

    def greedy_action(s: PixelPPOState, obs):
        return torch.tanh(actor_mean(split_flat(s.act, act_shapes), obs))

    def values_of(s: PixelPPOState, states, chunk: int = 2048):
        """The critic over (..., H, W, C) frames, ``chunk`` frames a pass (the
        JAX package maps it over time to bound the activations)."""
        lead = states.shape[:-3]
        flat = states.reshape(-1, *states.shape[-3:])
        lv = split_flat(s.cri, cri_shapes)
        out = torch.cat([critic_value(lv, flat[i:i + chunk])
                         for i in range(0, flat.shape[0], chunk)])
        return out.reshape(lead)

    def update(s: PixelPPOState, rollout: Rollout, last_obs, gen, ids=None):
        """``ids``: optional ``(U, B)`` flat minibatch ids (tests inject the
        JAX package's); drawn from ``gen`` otherwise."""
        horizon_len, num_envs = rollout.rewards.shape
        states, actions, logprobs = rollout.states, rollout.actions, rollout.logprobs
        unmasks = rollout.unmasks
        with torch.no_grad():
            values = values_of(s, states)
            next_value = values_of(s, last_obs)
            if if_use_vtrace:
                advantages, reward_sums = gae.vtrace_advantages(
                    rollout.rewards, rollout.undones, unmasks, values, next_value, gamma,
                    lambda_gae_adv, use_kernel=use_gae_kernel)
            else:
                rewards_b, undones_b = gae.apply_truncation_bootstrap(
                    rollout.rewards, rollout.undones, unmasks, values)
                advantages = gae.gae_plain(rewards_b, undones_b, values, gamma, lambda_gae_adv)
                reward_sums = advantages + values
            advantages = gae.normalize_advantages(advantages)
        update_times = max(1, int(horizon_len * repeat_times / batch_size))
        if ids is None:
            ids = sample_flat_ids(gen, horizon_len, num_envs, batch_size, update_times,
                                  states.device)
        ids0, ids1 = split_flat_ids(ids, horizon_len)
        act_opt, cri_opt = s.act_opt, s.cri_opt
        objs = []
        for u in range(ids.shape[0]):
            i0, i1 = ids0[u], ids1[u]
            state, action, unmask = states[i0, i1], actions[i0, i1], unmasks[i0, i1]
            logprob, advantage, reward_sum = logprobs[i0, i1], advantages[i0, i1], \
                reward_sums[i0, i1]

            def cri_loss(lv):
                return torch.mean(torch.square(critic_value(lv, state) - reward_sum) * unmask)

            obj_critic, g_cri = value_and_grad_flat(cri_loss, s.cri, cri_shapes)
            with torch.no_grad():
                cri_opt = grad_step(optimizer, s.cri, cri_opt, g_cri)

            def act_loss(lv):
                mean = actor_mean(lv, state)
                std = torch.exp(lv[-1])
                new_logprob = torch.sum(dists.normal_logprob(action, mean, std), dim=-1)
                entropy = torch.sum(dists.normal_entropy(std.expand_as(mean)), dim=-1)
                ratio = torch.exp(new_logprob - logprob)
                surrogate = torch.minimum(
                    advantage * ratio,
                    advantage * torch.clamp(ratio, 1 - ratio_clip, 1 + ratio_clip))
                obj_surrogate = torch.mean(surrogate * unmask)
                return (-(obj_surrogate - torch.mean(entropy * unmask) * lambda_entropy),
                        obj_surrogate)

            (_, obj_surrogate), g_act = value_and_grad_flat(act_loss, s.act, act_shapes)
            with torch.no_grad():
                act_opt = grad_step(optimizer, s.act, act_opt, g_act)
            objs.append(torch.stack([obj_critic, obj_surrogate]).detach())
        objs = torch.stack(objs).mean(0)
        metrics = {'obj_critic': objs[0], 'obj_actor': objs[1]}
        return s._replace(act_opt=act_opt, cri_opt=cri_opt), metrics

    return AgentDef(name='AgentPixelPPO', if_off_policy=False, if_discrete=False, init=init,
                    explore_action=explore_action, greedy_action=greedy_action,
                    env_action=torch.tanh, update=update,
                    state_to_numpy=lambda s: _to_numpy(s, act_shapes, cri_shapes, n_conv),
                    state_from_numpy=_from_numpy)


def _to_numpy(s, act_shapes, cri_shapes, n_conv):
    from ..utils.jax_params import pixel_ppo_state_to_numpy
    return pixel_ppo_state_to_numpy(s, act_shapes, cri_shapes, n_conv)


def _from_numpy(tree, device):
    from ..utils.jax_params import pixel_ppo_state_from_numpy
    return pixel_ppo_state_from_numpy(tree, device)


class AgentPixelPPO:
    make = staticmethod(make_pixel_ppo)
