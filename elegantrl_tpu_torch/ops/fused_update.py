"""Fused PPO update (counterpart of ``elegantrl_tpu/ops/pallas_update.py``,
``_make_kernel`` of ``make_ppo_fused_update``, continuous and discrete heads).

U sequential minibatch steps over pre-gathered ``(U, ., B)`` blocks: a
critic step on ``mean((v - rs)^2 * um)`` and an actor step on
``-(mean(surrogate * um) - lambda * mean(entropy * um))``, each followed
by optax's clip-by-global-norm and Adam (``agents/base.py:clip_adam_``).
Parameters and moments are flat buffers updated in place; the bias
corrections of step u are ``1 - beta**(count + u + 1)``, so each count
rises by U.

With ``discrete=True`` the actor's outputs are logits, the action block
``ab`` is the one-hot ``(U, A, B)`` (A = number of actions), ``new_lp =
sum(log_softmax * onehot)``, the entropy is the categorical one and the
actor's buffer has no ``std_log`` leaf.

- :func:`ppo_update_reference`: the plain version; gradients from
  ``torch.autograd``.  ``torch.minimum``/``torch.maximum`` split the
  gradient evenly at a tie, as JAX's do, so the clip is written with them
  (``torch.clamp`` would give the full gradient at ``ratio == 1 +- clip``).
- :func:`ppo_update`: the wrapper; plain version for CPU tensors, the
  hand-written CUDA kernel ``csrc/ppo_update.cu`` for CUDA tensors: one
  cooperative launch for all U steps, a persistent block per SM, 8 phases
  a step between grid barriers (``PPO_PHASES``; ``trace=`` returns block 0's
  stamps, :func:`ppo_phase_ms`).
- ``ppo_update.launches``: the count of wrapper calls that launched the
  kernel (one CUDA launch each, whatever U is);
  ``ppo_update.launches_by_head`` splits it by head.

The losses (:func:`actor_loss`, :func:`a2c_actor_loss`, :func:`critic_loss`)
are also what the A2C update differentiates with ``torch.autograd``
(``agents/ppo.py``): the JAX package has no kernel for A2C either.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from . import dists
from .nets import mlp_apply_leaves, ppo_param_shapes, split_flat

# Static shared memory of one block of the kernel, the same for every width,
# batch and U: gg::Smem (two 32 x 33 operand tiles, 8 x 2 reduction slots);
# the activations live in a workspace.  csrc/ppo_update.cu owns the layout
# (ppo_update_smem_bytes); chip_smoke.py checks this copy.
PPO_SMEM_BYTES = 4 * (2 * 32 * 33 + 8 * 2)
PPO_PHASES = ('layer 1', 'layer 2', 'heads and losses', 'head grads', 'layer 2 grads',
              'layer 1 grads', 'split sums and norms', 'clip + Adam')


def update_fits(net_dims: Sequence[int]) -> bool:
    """Whether the update kernel takes a net: any of two hidden layers, any
    batch, U and head (``PPO_SMEM_BYTES`` does not grow with them)."""
    return len(tuple(net_dims)) == 2


def fused_update_bytes(update_times: int, batch_size: int, state_dim: int,
                       action_dim: int, n_params: int) -> int:
    """The JAX package's reckoning of its fused update's VMEM residency
    (``elegantrl_tpu/ops/pallas_update.py:fused_update_bytes``): the
    minibatch blocks plus three copies of the parameters (p, mu, nu), f32.
    Kept here only to copy that package's kernel eligibility."""
    data = update_times * batch_size * (state_dim + action_dim + 4) * 4
    return data + 3 * n_params * 4


def adam_parts(opt_state):
    """(count, mu, nu) of an ``agents.base.AdamState``."""
    return opt_state.count, opt_state.mu, opt_state.nu


def with_adam_parts(opt_state, count, mu, nu):
    return opt_state._replace(count=count, mu=mu, nu=nu)


def logprob_entropy(leaves, xn, a, discrete: bool, dtype=None):
    """``(new_logprob, entropy)`` of actions ``a`` under the actor given by
    ``leaves``; ``a`` is ``(..., A)``: raw actions, or one-hot rows when
    ``discrete``.  ``dtype``: the MLP's compute type (``mlp_apply_leaves``)."""
    if discrete:
        logp = torch.log_softmax(mlp_apply_leaves(leaves, xn, dtype), dim=-1)
        return torch.sum(logp * a, dim=-1), -torch.sum(torch.exp(logp) * logp, dim=-1)
    mean = mlp_apply_leaves(leaves[:-1], xn, dtype)      # (..., A)
    std = torch.exp(leaves[-1])                          # (1, A)
    new_lp = torch.sum(dists.normal_logprob(a, mean, std), dim=-1)
    entropy = torch.sum(dists.normal_entropy(std.expand_as(mean)), dim=-1)
    return new_lp, entropy


def actor_loss(leaves, xn, a, lp, adv, um, ratio_clip, lambda_entropy, single_sided,
               discrete: bool = False, dtype=None):
    """PPO: ``-(mean(surrogate * um) - lambda * mean(entropy * um))``."""
    new_lp, entropy = logprob_entropy(leaves, xn, a, discrete, dtype)
    ratio = torch.exp(new_lp - lp)
    if single_sided:
        surrogate = adv * ratio * torch.where(adv > 0, 1.0 - ratio_clip, 1.0 + ratio_clip)
    else:
        lo = torch.full_like(ratio, 1.0 - ratio_clip)
        hi = torch.full_like(ratio, 1.0 + ratio_clip)
        clipped = torch.minimum(torch.maximum(lo, ratio), hi)
        surrogate = torch.minimum(adv * ratio, adv * clipped)
    obj_surrogate = torch.mean(surrogate * um)
    obj_entropy = torch.mean(entropy * um)
    return -(obj_surrogate - obj_entropy * lambda_entropy), obj_surrogate, obj_entropy


def a2c_actor_loss(leaves, xn, a, adv, um, lambda_entropy, discrete: bool = False,
                   dtype=None):
    """A2C: the unclipped policy gradient with a true entropy bonus,
    ``-(mean(adv * logp * um) + lambda * mean(entropy * um))``."""
    new_lp, entropy = logprob_entropy(leaves, xn, a, discrete, dtype)
    obj_surrogate = torch.mean(adv * new_lp * um)
    obj_entropy = torch.mean(entropy * um)
    return -(obj_surrogate + obj_entropy * lambda_entropy), obj_surrogate, obj_entropy


def discrete_head_backward(logits, onehot, g_lp, g_ent):
    """``d loss / d logits`` as ``csrc/ppo_update.cu`` writes it by hand, from
    ``g_lp = d loss / d new_lp`` and ``g_ent = d loss / d entropy`` per
    sample: ``g_lp * (onehot - p * sum(onehot)) - g_ent * p * (logp +
    entropy)``.  The tests hold it against autograd of
    :func:`logprob_entropy`."""
    logp = torch.log_softmax(logits, dim=-1)
    p = torch.exp(logp)
    entropy = -torch.sum(p * logp, dim=-1, keepdim=True)
    soh = torch.sum(onehot, dim=-1, keepdim=True)
    return g_lp[..., None] * (onehot - p * soh) - g_ent[..., None] * p * (logp + entropy)


def critic_loss(leaves, xn, rs, um, dtype=None):
    v = mlp_apply_leaves(leaves, xn, dtype)[..., 0]
    return torch.mean(torch.square(v - rs) * um)


def value_and_grad_flat(loss_fn, flat, shapes):
    """``loss_fn(leaves)`` on the leaves of a copy of ``flat``: its output
    and the gradient of the loss (the output, or its first element) with
    respect to the flat buffer, by ``torch.autograd``."""
    with torch.enable_grad():
        p = flat.detach().clone().requires_grad_(True)
        out = loss_fn(split_flat(p, shapes))
        grad, = torch.autograd.grad(out[0] if isinstance(out, tuple) else out, p)
    return out, grad


def ppo_update_reference(act_flat, cri_flat, act_mu, act_nu, cri_mu, cri_nu,
                         act_count: int, cri_count: int, norm_avg, norm_std,
                         sb, ab, lpb, advb, rsb, umb, *, net_dims: Sequence[int],
                         ratio_clip: float, lambda_entropy: float, lr: float,
                         clip_grad: float, single_sided: bool = False,
                         discrete: bool = False,
                         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                         ) -> torch.Tensor:
    """Plain PyTorch version; updates params and moments in place and
    returns the ``(U, 3)`` objectives (critic, surrogate, entropy)."""
    from ..agents.base import ClipAdam, clip_adam_
    U, S, B = sb.shape
    A = ab.shape[1]
    opt = ClipAdam(lr, clip_grad, b1, b2, eps)
    act_shapes, cri_shapes = ppo_param_shapes(S, net_dims, A, discrete)
    objs = torch.empty((U, 3), dtype=torch.float32, device=sb.device)
    for u in range(U):
        xn = ((sb[u] - norm_avg[:, None]) / (norm_std[:, None] + 1e-4)).T   # (B, S)
        obj_c, g_cri = value_and_grad_flat(
            lambda leaves: critic_loss(leaves, xn, rsb[u], umb[u]), cri_flat, cri_shapes)
        (_, obj_s, obj_e), g_act = value_and_grad_flat(
            lambda leaves: actor_loss(leaves, xn, ab[u].T, lpb[u], advb[u], umb[u], ratio_clip,
                                      lambda_entropy, single_sided, discrete),
            act_flat, act_shapes)
        with torch.no_grad():
            clip_adam_(opt, cri_flat, cri_mu, cri_nu, g_cri, cri_count + u + 1)
            clip_adam_(opt, act_flat, act_mu, act_nu, g_act, act_count + u + 1)
            objs[u] = torch.stack([obj_c, obj_s, obj_e]).detach()
    return objs


def ppo_update(act_flat, cri_flat, act_mu, act_nu, cri_mu, cri_nu,
               act_count: int, cri_count: int, norm_avg, norm_std,
               sb, ab, lpb, advb, rsb, umb, *, net_dims: Sequence[int],
               ratio_clip: float, lambda_entropy: float, lr: float,
               clip_grad: float, single_sided: bool = False, discrete: bool = False,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               trace=None) -> torch.Tensor:
    """The fused update: CUDA kernel for CUDA tensors (one cooperative
    launch, a block per SM; a card that refuses the launch raises), the
    plain version for CPU tensors.  In place; returns the ``(U, 3)``
    objectives.  ``trace``, a ``(U, len(PPO_PHASES) + 1)`` int64 CUDA
    tensor, receives block 0's clock stamps."""
    kw = dict(net_dims=net_dims, ratio_clip=ratio_clip, lambda_entropy=lambda_entropy,
              lr=lr, clip_grad=clip_grad, single_sided=single_sided, discrete=discrete,
              b1=b1, b2=b2, eps=eps)
    args = (act_flat, cri_flat, act_mu, act_nu, cri_mu, cri_nu, act_count, cri_count,
            norm_avg, norm_std, sb, ab, lpb, advb, rsb, umb)
    if act_flat.device.type == 'cpu':
        return ppo_update_reference(*args, **kw)
    if act_flat.device.type != 'cuda':
        raise ValueError(f'ppo_update: unsupported device {act_flat.device}')
    if len(net_dims) != 2:
        raise ValueError(f'ppo_update: the CUDA kernel takes 2 hidden layers, got {net_dims}')
    from ._cuda_build import check, check_tensor, ptr
    D1, D2 = (int(d) for d in net_dims)
    U, S, B = sb.shape
    A = ab.shape[1]
    dev = act_flat.device

    def _check(name, t, shape, device):
        check_tensor('ppo_update', name, t, shape, torch.float32, device)

    act_shapes, cri_shapes = ppo_param_shapes(S, (D1, D2), A, discrete)
    Pa = sum(math.prod(s) for s in act_shapes)
    Pc = sum(math.prod(s) for s in cri_shapes)
    for name, t in (('act_flat', act_flat), ('act_mu', act_mu), ('act_nu', act_nu)):
        _check(name, t, (Pa,), dev)
    for name, t in (('cri_flat', cri_flat), ('cri_mu', cri_mu), ('cri_nu', cri_nu)):
        _check(name, t, (Pc,), dev)
    _check('norm_avg', norm_avg, (S,), dev)
    _check('norm_std', norm_std, (S,), dev)
    _check('sb', sb, (U, S, B), dev)
    _check('ab', ab, (U, A, B), dev)
    for name, t in (('lpb', lpb), ('advb', advb), ('rsb', rsb), ('umb', umb)):
        _check(name, t, (U, B), dev)

    if trace is not None:
        check_tensor('ppo_update', 'trace', trace, (U, len(PPO_PHASES) + 1), torch.int64, dev)
    from .fused_offpolicy_update import _coop_grid
    lib = _library()
    grid = _coop_grid(lib, 'ppo_update', dev)
    ws = torch.empty(lib.ppo_update_workspace_floats(U, B, S, A, D1, D2, int(bool(discrete)),
                                                     grid), dtype=torch.float32, device=dev)
    objs = torch.empty((U, 3), dtype=torch.float32, device=dev)
    f = ctypes.c_float
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.ppo_update(
        *[ptr(t) for t in (act_flat, act_mu, act_nu, cri_flat, cri_mu, cri_nu,
                           norm_avg, norm_std, sb, ab, lpb, advb, rsb, umb, ws, objs, trace)],
        grid, U, B, S, A, D1, D2, int(act_count), int(cri_count), int(bool(single_sided)),
        int(bool(discrete)),
        f(ratio_clip), f(lambda_entropy), f(lr), f(clip_grad), f(b1), f(b2), f(eps),
        ctypes.c_void_p(stream))
    check(status, 'ppo_update')
    ppo_update.launches += 1
    ppo_update.launches_by_head['discrete' if discrete else 'continuous'] += 1
    return objs


ppo_update.launches = 0
ppo_update.launches_by_head = {'continuous': 0, 'discrete': 0}


def _library():
    from ._cuda_build import load
    from .fused_offpolicy_update import _bind
    return _bind(load('ppo_update'), 'ppo_update', 17, 11, 7, 8)


def ppo_phase_ms(trace: torch.Tensor) -> dict:
    """Mean ms per step of each of the update kernel's phases, from its
    ``trace`` buffer (``ppo_update(..., trace=)``: block 0's stamps at the
    start of a step and after each phase's barrier)."""
    from .fused_offpolicy_update import phase_ms
    return phase_ms(trace, PPO_PHASES)


def make_ppo_fused_update(state_dim: int, action_dim: int, batch_size: int,
                          update_times: int, *, net_dims: Sequence[int],
                          ratio_clip: float, lambda_entropy: float, lr: float,
                          clip_grad: float, single_sided: bool = False,
                          discrete: bool = False,
                          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """``fused(agent_state, sb, ab, lpb, advb, rsb, umb) -> (agent_state,
    metrics)``: the drop-in for the PPO minibatch loop, through
    :func:`ppo_update`.  ``sb (U, S, B)``, ``ab (U, A, B)`` (one-hot when
    ``discrete``), the rest ``(U, B)``."""
    U = int(update_times)
    kw = dict(net_dims=tuple(net_dims), ratio_clip=ratio_clip,
              lambda_entropy=lambda_entropy, lr=lr, clip_grad=clip_grad,
              single_sided=single_sided, discrete=discrete, b1=b1, b2=b2, eps=eps)

    def fused(s, sb, ab, lpb, advb, rsb, umb):
        a_count, a_mu, a_nu = adam_parts(s.act_opt)
        c_count, c_mu, c_nu = adam_parts(s.cri_opt)
        objs = ppo_update(s.act_flat, s.cri_flat, a_mu, a_nu, c_mu, c_nu,
                          a_count, c_count, s.norm_avg, s.norm_std,
                          sb, ab, lpb, advb, rsb, umb, **kw)
        s = s._replace(act_opt=with_adam_parts(s.act_opt, a_count + U, a_mu, a_nu),
                       cri_opt=with_adam_parts(s.cri_opt, c_count + U, c_mu, c_nu))
        metrics = {'obj_critic': objs[:, 0].mean(), 'obj_actor': objs[:, 1].mean(),
                   'obj_entropy': objs[:, 2].mean()}
        return s, metrics

    return fused
