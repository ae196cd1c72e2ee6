"""Fused off-policy update chunks (counterpart of
``elegantrl_tpu/ops/pallas_update.py``: ``make_dqn_fused_chunk``,
``make_ddpg_fused_chunk`` with ``per=False`` and ``per=True`` and
``make_sac_fused_chunk``).

A chunk is C sequential minibatch updates over pre-gathered blocks; steps
past the round's update count are masked by the per-step table ``bcv``.

- DQN family (``dqn_chunk``): per step, ``q_label = r + ud * gamma * max_a
  Q_target(nx)`` (plain max; DoubleDQN the min of the twin heads; Dueling's
  TD path reads the value head alone, D3QN combines), the TD loss
  ``mean(td)`` with ``td = (q_a - label)^2 * um`` (twin: both heads' terms),
  optax clip-by-global-norm + Adam over the whole net with the table's bias
  corrections, then Polyak ``t = t * (1 - tau) + p * tau``.  ``bcv`` is
  ``(C, 3)``: ``(bc1, bc2, valid)``.
- DDPG/TD3 (``ddpg_chunk``): per step, the TD target from the *online*
  actor on ``nx`` (TD3: plus the pre-drawn smoothing noise, clipped to
  [-1, 1]) and the target critic (TD3: min over the E heads, DDPG: their
  mean); the critic loss (TD3: ``mean_E((q - label)^2) * um``; DDPG:
  ``(mean_E(q) * um - label)^2 * um``, the unmask twice as the reference
  writes it); critic Adam + Polyak; then the actor loss ``-mean(Q_new(x,
  tanh(actor(x))))`` through the *updated* critic, actor Adam + Polyak.
  ``bcv`` is ``(C, 7)``: ``(bc1_c, bc2_c, bc1_a, bc2_a, valid, do_act, 0)``;
  the critic step is masked by ``valid``, the actor step (computed every
  step) by ``valid * do_act``.  With prioritised replay (``iw``, the PER
  variant) the critic loss is ``mean(td * iw)`` and the chunk also returns
  every step's per-sample ``td``, valid or not.
- SAC/ModSAC (``sac_chunk``): per step, ``alpha = exp(alpha_log)``; the
  label ``r + ud * gamma * (min_E Q_target(nx, a') - alpha * logp(a'))``
  with ``a'`` the pre-update actor's tanh-Gaussian draw on ``nx`` from the
  next-action noise ``nzn``; the critic loss ``mean(mean_E((q - label)^2) *
  um)``, critic Adam + Polyak; the temperature step on the gradient ``te -
  mean(logp)`` of the pre-update actor on ``x`` with the policy noise
  ``nzp`` (clip-by-norm, Adam with its own moments and bias corrections,
  ``alpha_log`` clipped to [-16, 2]); ModSAC's gate ``do_act = upd_a / (t +
  1) < 1 / (2 - e^-1)`` (``upd_a`` restarts at update 0); then the actor
  loss ``-(mean(Q_target'(x, a)) - alpha' * mean(logp))`` against the
  *fresh* target critic and the post-step alpha, with ``a`` drawn from
  ``nzp``, actor Adam (bias corrections from its own count) and, ModSAC,
  the actor target's Polyak step.  ``bcv`` is ``(C, 7)``: ``(bc1_c, bc2_c,
  bc1_alpha, bc2_alpha, valid, update_t, 0)``; ``misc`` is the ``(5,)``
  float vector ``(alpha_log, alpha_mu, alpha_nu, act_count, update_a)``.
  The critic, alpha and gate are masked by ``valid``, the actor by ``valid
  * do_act``.

Blocks: ``sb, nsb (C, S, B)``, one-hot ``oh (C, A, B)`` (DQN) or actions
``ab (C, A, B)`` and noise ``nz (C, A, B)`` (DDPG/TD3; SAC: ``nzn`` and
``nzp``), ``rb, ud, um (C, B)``.  Parameters, targets and Adam moments are
flat buffers in the leaf order of ``ops/nets.py:dqn_param_shapes``/
``ddpg_param_shapes``/``sac_act_shapes``/``sac_cri_shapes``, updated in
place; each function returns the objectives, ``(C, 2)`` (TD loss, mean
``q_a`` of the first head; or critic loss, mean Q of the actor step) or, SAC,
``(C, 3)`` (critic loss, actor objective, ``valid * do_act``).  A step with
``valid = 0`` leaves every buffer bit-identical.

As for every kernel of the port: ``*_chunk_reference`` is the plain version
(gradients by ``torch.autograd``), ``*_chunk`` the wrapper (the plain
version for CPU tensors; for CUDA tensors one cooperative launch of the
hand-written persistent kernel of ``csrc/dqn_update.cu``,
``csrc/ddpg_update.cu`` or ``csrc/sac_update.cu``, one block per SM, the
phases of every update between grid barriers), and ``*_chunk.launches`` the
count of chunks launched (``launches_by_variant`` splits it).  The functions below the chunks (Q
values of the four DQN nets, the dueling combine, the SAC actor and critic
ensemble) are also what the agents' scan updates differentiate.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .dists import tanh_normal_logprob, tanh_normal_logprob_simple
from .fused_update import value_and_grad_flat
from .nets import (ddpg_param_shapes, dqn_param_shapes, gelu, linear, mlp_apply_leaves,
                   sac_act_shapes, sac_cri_shapes, soft_update_, split_flat)

# ------------------------------------------------------------ DQN nets

def dueling_combine(val: torch.Tensor, adv: torch.Tensor) -> torch.Tensor:
    """``val - mean(val) + adv`` over the action axis (the last)."""
    return val - torch.mean(val, dim=-1, keepdim=True) + adv


def dqn_head_outputs(leaves, x, twin: bool, duel: bool, dtype=None) -> list:
    """The outputs of every head of the net for ``x (..., S)``: one ``(..., A)``
    for the plain MLP; else the heads after the encoder, in leaf order.
    ``dtype``: the compute type (``ops/nets.py:mlp_apply_leaves``)."""
    if not (twin or duel):
        return [mlp_apply_leaves(leaves, x, dtype)]
    h = mlp_apply_leaves(leaves[:4], x, dtype)   # the encoder: GELU after layer 1 only
    return [linear(h, leaves[i], leaves[i + 1], dtype) for i in range(4, len(leaves), 2)]


def dqn_q_greedy(leaves, x, twin: bool, duel: bool, dtype=None) -> torch.Tensor:
    """Q of the greedy policy: the plain net's output, or head 1, combined
    with its advantage head where the net is dueling."""
    outs = dqn_head_outputs(leaves, x, twin, duel, dtype)
    return dueling_combine(outs[0], outs[1]) if duel else outs[0]


def dqn_q_td(leaves, x, twin: bool, duel: bool):
    """``(q1, q2)`` of the TD path (``q2`` None unless twin).  The dueling
    net without a twin reads its value head alone (the reference's
    ``QNetDuel.get_q_value``); D3QN combines both heads."""
    outs = dqn_head_outputs(leaves, x, twin, duel)
    if not twin:
        return outs[0], None
    if duel:
        return dueling_combine(outs[0], outs[1]), dueling_combine(outs[2], outs[3])
    return outs[0], outs[1]


def dqn_next_q(leaves, nx, twin: bool, duel: bool) -> torch.Tensor:
    """``max_a`` of the target's TD-path Q (twin: of the min of both heads)."""
    q1, q2 = dqn_q_td(leaves, nx, twin, duel)
    return torch.amax(q1 if q2 is None else torch.minimum(q1, q2), dim=-1)


def dqn_td_errors(leaves, x, onehot, label, um, twin: bool, duel: bool):
    """``(td, q_a of head 1)``, ``td = (q_a - label)^2 * um`` summed over the
    twin heads, per sample; ``onehot (B, A)``."""
    q1, q2 = dqn_q_td(leaves, x, twin, duel)
    q1a = torch.sum(q1 * onehot, dim=-1)
    td = torch.square(q1a - label)
    if q2 is not None:
        td = td + torch.square(torch.sum(q2 * onehot, dim=-1) - label)
    return td * um, q1a


def dqn_td_loss(leaves, x, onehot, label, um, twin: bool, duel: bool):
    """``(mean(td), q_a of head 1)`` of :func:`dqn_td_errors`."""
    td, q1a = dqn_td_errors(leaves, x, onehot, label, um, twin, duel)
    return torch.mean(td), q1a


def dueling_combine_backward(g: torch.Tensor):
    """Gradients of :func:`dueling_combine` at ``d loss / d combined = g``:
    ``g - mean(g)`` into the value head, ``sum(g)`` into the advantage, as
    ``csrc/dqn_update.cu`` writes them by hand."""
    return g - torch.mean(g, dim=-1, keepdim=True), torch.sum(g, dim=-1, keepdim=True)


# ---------------------------------------------------------- DDPG nets

def ddpg_actor(leaves, x) -> torch.Tensor:
    return torch.tanh(mlp_apply_leaves(leaves, x))


def ddpg_q_values(leaves, x, a) -> torch.Tensor:
    """The critic's E heads on ``[x, a]``, ``(..., E)``."""
    return mlp_apply_leaves(leaves, torch.cat([x, a], dim=-1))


def ddpg_critic_td(leaves, x, a, label, um, td3: bool):
    """``(td, qs)``: the per-sample TD error after the unmask (TD3:
    ``mean_E((q - label)^2) um``; DDPG: ``(mean_E(q) um - label)^2 um``) and
    the E heads' values."""
    qs = ddpg_q_values(leaves, x, a)
    if td3:
        td = torch.mean(torch.square(qs - label[..., None]), dim=-1) * um
    else:
        q = torch.mean(qs, dim=-1) * um
        td = torch.square(q - label) * um
    return td, qs


def ddpg_critic_loss(leaves, x, a, label, um, td3: bool, iw=None):
    """``mean(td)``, or under PER the weighted ``mean(td * iw)``."""
    td = ddpg_critic_td(leaves, x, a, label, um, td3)[0]
    return torch.mean(td) if iw is None else torch.mean(td * iw)


def ddpg_actor_loss(act_leaves, cri_leaves, x):
    return -torch.mean(ddpg_q_values(cri_leaves, x, ddpg_actor(act_leaves, x)))


def ddpg_td_label(act_leaves, tcri_leaves, nx, r, ud, z, gamma: float, td3: bool):
    """``r + ud * gamma * Q_target(nx, a')`` with ``a'`` from the online actor
    (TD3: ``clip(a' + z, -1, 1)``, min over E; DDPG: mean over E)."""
    na = ddpg_actor(act_leaves, nx)
    if td3:
        na = torch.clamp(na + z, -1.0, 1.0)
    nq_all = ddpg_q_values(tcri_leaves, nx, na)
    nq = torch.amin(nq_all, dim=-1) if td3 else torch.mean(nq_all, dim=-1)
    return r + ud * gamma * nq


def tanh_backward(y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``d loss / d pre`` of ``y = tanh(pre)`` at ``d loss / d y = g``."""
    return g * (1.0 - y * y)


# The backward formulas that the CUDA kernels write by hand, in PyTorch, so
# that the tests hold them against autograd.

def td_head_grad(q: torch.Tensor, onehot: torch.Tensor, label: torch.Tensor,
                 um: torch.Tensor) -> torch.Tensor:
    """``d mean((q_a - label)^2 * um) / d q`` for ``q (B, A)``, ``q_a = sum(q *
    onehot)``: ``onehot * 2 (q_a - label) um / B``."""
    qa = torch.sum(q * onehot, dim=-1, keepdim=True)
    return onehot * (2.0 * (qa - label[:, None]) * um[:, None] / q.shape[0])


def ddpg_td_head_grad(qs: torch.Tensor, label: torch.Tensor, um: torch.Tensor, td3: bool,
                      iw=None) -> torch.Tensor:
    """``d mean(td * iw) / d q`` for the critic's heads ``qs (B, E)``, as
    ``csrc/ddpg_update.cu`` writes it: TD3 ``2 (q_e - label) um iw / (E B)``;
    DDPG ``2 (mean_E(q) um - label) um^2 iw / (E B)`` (``iw`` 1 without
    PER)."""
    B, E = qs.shape
    w = torch.ones_like(um) if iw is None else iw
    if td3:
        return 2.0 * (qs - label[:, None]) / E * (um * w)[:, None] / B
    diff = torch.mean(qs, dim=-1) * um - label
    return (2.0 * diff * um * um / E * w / B)[:, None].expand(B, E)


def gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """The derivative of the tanh-form GELU."""
    k = math.sqrt(2.0 / math.pi)
    t = torch.tanh(k * (x + 0.044715 * x ** 3))
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * k * (1.0 + 3.0 * 0.044715 * x * x)


def mlp_input_grad(leaves, x: torch.Tensor, g_out: torch.Tensor) -> torch.Tensor:
    """``d loss / d x`` of a GELU MLP (``mlp_apply_leaves``) at ``d loss / d
    output = g_out``, layer by layer as ``csrc/ddpg_update.cu`` runs the critic
    back to its action inputs."""
    n = len(leaves) // 2
    pre = []
    h = x
    for i in range(n):
        z = F.linear(h, leaves[2 * i], leaves[2 * i + 1])
        pre.append(z)
        h = F.gelu(z, approximate='tanh') if i < n - 1 else z
    g = g_out
    for i in range(n - 1, -1, -1):
        if i < n - 1:
            g = g * gelu_grad(pre[i])
        g = g @ leaves[2 * i]
    return g


# ----------------------------------------------------------- SAC nets

# ModSAC's gate ratio 1 / (2 - e^-1), as the float32 the kernels compare with
SAC_RELIABLE = float(np.float32(1.0 / (2.0 - math.exp(-1.0))))


def sac_actor_dist(leaves, x, modsac: bool, std_clip, dtype=None) -> tuple:
    """``(mean, log_std)`` of the actor on ``x (..., S)``: SAC reads ``[mean,
    log_std] = head(gelu(enc(x)))``, ModSAC the raw encoding into its ``avg``
    and ``std`` heads; ``log_std`` is clipped to ``std_clip``.  ``dtype``:
    the compute type (``ops/nets.py:mlp_apply_leaves``)."""
    n = len(leaves) - (4 if modsac else 2)
    enc = mlp_apply_leaves(leaves[:n], x, dtype)   # GELU between the encoder's layers only
    if modsac:
        mean = linear(enc, leaves[n], leaves[n + 1], dtype)
        log_std = linear(enc, leaves[n + 2], leaves[n + 3], dtype)
    else:
        mean, log_std = linear(gelu(enc), leaves[n], leaves[n + 1], dtype).chunk(2, dim=-1)
    return mean, torch.clamp(log_std, *std_clip)


def sac_action_logprob(leaves, x, noise, modsac: bool, std_clip) -> tuple:
    """``(tanh(pre), logprob)`` with ``pre = mean + exp(log_std) * noise``:
    ModSAC's softplus form (``ops/dists.py:tanh_normal_logprob``), SAC's
    density at the mean (``tanh_normal_logprob_simple``); logprob ``(...,)``."""
    mean, log_std = sac_actor_dist(leaves, x, modsac, std_clip)
    std = torch.exp(log_std)
    pre = mean + std * noise
    lp = (tanh_normal_logprob(log_std, noise, pre) if modsac
          else tanh_normal_logprob_simple(mean, std, pre))
    return torch.tanh(pre), lp


def sac_q_values(leaves, x, a, num_ensembles: int) -> torch.Tensor:
    """The critic ensemble on ``[x, a]``, ``(..., E)``: the linear encoder,
    then each head's MLP."""
    enc = F.linear(torch.cat([x, a], dim=-1), leaves[0], leaves[1])
    nh = (len(leaves) - 2) // num_ensembles
    return torch.stack([mlp_apply_leaves(leaves[2 + nh * e:2 + nh * (e + 1)], enc)[..., 0]
                        for e in range(num_ensembles)], dim=-1)


def sac_td_label(act_leaves, tcri_leaves, nx, r, ud, nz_next, alpha, gamma: float,
                 modsac: bool, std_clip, num_ensembles: int) -> torch.Tensor:
    """``r + ud * gamma * (min_E Q_target(nx, a') - alpha * logp(a'))``, ``a'``
    the actor's draw on ``nx`` from ``nz_next``."""
    na, nlp = sac_action_logprob(act_leaves, nx, nz_next, modsac, std_clip)
    nq = torch.amin(sac_q_values(tcri_leaves, nx, na, num_ensembles), dim=-1)
    return r + ud * gamma * (nq - nlp * alpha)


def sac_critic_loss(leaves, x, a, label, um, num_ensembles: int) -> torch.Tensor:
    qs = sac_q_values(leaves, x, a, num_ensembles)
    return torch.mean(torch.mean(torch.square(qs - label[..., None]), dim=-1) * um)


def sac_actor_loss(act_leaves, cri_leaves, x, noise, alpha, modsac: bool, std_clip,
                   num_ensembles: int) -> torch.Tensor:
    """``-(mean(Q(x, a)) - mean(alpha * logp(a)))`` over the batch and the heads."""
    a_pg, lp = sac_action_logprob(act_leaves, x, noise, modsac, std_clip)
    return -(torch.mean(sac_q_values(cri_leaves, x, a_pg, num_ensembles))
             - torch.mean(lp * alpha))


def sac_alpha_step(alpha_log, mu, nu, lp_mean, target_entropy: float, bc1, bc2, lr: float,
                   clip_grad: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """The temperature's step on ``mean(alpha_log * (te - lp))``: its gradient
    ``te - mean(lp)`` clipped by its norm, Adam, then the [-16, 2] clip.
    Returns ``(alpha_log, mu, nu)``."""
    g = target_entropy - lp_mean
    gn = torch.sqrt(g * g)
    g = g * torch.where(gn < clip_grad, torch.ones_like(gn), clip_grad / gn)
    mu = b1 * mu + (1.0 - b1) * g
    nu = b2 * nu + (1.0 - b2) * g * g
    return torch.clamp(alpha_log - lr * (mu / bc1) / (torch.sqrt(nu / bc2) + eps), -16.0, 2.0), mu, nu


def modsac_do_actor(update_a: int, update_t: int) -> tuple:
    """ModSAC's gate at update ``update_t`` of a round: ``(do_act, update_a
    after it)``, in float32 as the JAX package and the kernel compute it."""
    upd = 0 if update_t == 0 else int(update_a)
    do = bool(np.float32(upd) / np.float32(update_t + 1.0) < np.float32(SAC_RELIABLE))
    return do, upd + int(do)


# The SAC backward formulas that csrc/sac_update.cu writes by hand, in
# PyTorch, so that the tests hold them against autograd.

def sac_td_head_grad(qs: torch.Tensor, label: torch.Tensor, um: torch.Tensor) -> torch.Tensor:
    """``d mean(mean_E((q - label)^2) * um) / d q`` for ``qs (B, E)``:
    ``2 (q - label) um / (E B)``, one head's column needing only its own q."""
    B, E = qs.shape
    return 2.0 * (qs - label[:, None]) * um[:, None] / (E * B)


def sac_head_backward(out: torch.Tensor, noise: torch.Tensor, g_act: torch.Tensor,
                      w_lp, modsac: bool, std_clip) -> torch.Tensor:
    """The gradient at the actor's raw head outputs ``out = [mean, log_std
    before the clip] (B, 2A)`` of ``sum(g_act * a) + w_lp * sum(logp)``, with
    ``a = tanh(pre)``, ``pre = mean + exp(clip(log_std)) * noise``:
    ``G = g_act (1 - a^2) + w_lp dlogp/dpre`` into the mean, and ``(G std z -
    w_lp) [lo <= log_std <= hi]`` into log_std.  ``dlogp/dpre`` is ``2 - 4
    sigmoid(-2 pre)`` for ModSAC's softplus form and ``2 a (1 - a^2) /
    (1.000001 - a^2)`` for SAC's."""
    A = noise.shape[-1]
    mean, raw = out[..., :A], out[..., A:]
    log_std = torch.clamp(raw, *std_clip)
    std = torch.exp(log_std)
    pre = mean + std * noise
    a = torch.tanh(pre)
    if modsac:
        dlp = 2.0 - 4.0 * torch.sigmoid(-2.0 * pre)
    else:
        dlp = 2.0 * a * (1.0 - a * a) / (1.000001 - a * a)
    G = g_act * (1.0 - a * a) + w_lp * dlp
    inside = ((raw >= std_clip[0]) & (raw <= std_clip[1])).to(out.dtype)
    return torch.cat([G, (G * std * noise - w_lp) * inside], dim=-1)


def sac_q_input_grad(leaves, x, a, g_q: torch.Tensor, num_ensembles: int) -> torch.Tensor:
    """``d sum(g_q * Q(x, a)) / d [x, a]`` of the ensemble, head by head as
    ``csrc/sac_update.cu`` runs it: each head's gradient at its hidden
    pre-activation, ``w2 g gelu'(z)``, back through its first layer into the
    encoding, summed over the heads, then through the linear encoder."""
    xin = torch.cat([x, a], dim=-1)
    enc = F.linear(xin, leaves[0], leaves[1])
    nh = (len(leaves) - 2) // num_ensembles
    denc = torch.zeros_like(enc)
    for e in range(num_ensembles):
        w1, b1, w2 = leaves[2 + nh * e:5 + nh * e]
        z = F.linear(enc, w1, b1)
        denc = denc + (g_q[:, e:e + 1] * w2 * gelu_grad(z)) @ w1
    return denc @ leaves[0]


# ------------------------------------------------------ plain versions

def _opt(lr, clip_grad, b1, b2, eps):
    from ..agents.base import ClipAdam
    return ClipAdam(lr, clip_grad, b1, b2, eps)


def dqn_chunk_reference(p, t, mu, nu, sb, nsb, oh, rb, ud, um, bcv, *,
                        net_dims: Sequence[int], twin: bool, duel: bool, gamma: float,
                        tau: float, lr: float, clip_grad: float, b1: float = 0.9,
                        b2: float = 0.999, eps: float = 1e-8) -> torch.Tensor:
    """Plain PyTorch version of the DQN-family chunk; in place, returns the
    ``(C, 2)`` objectives."""
    from ..agents.base import clip_adam_bc_
    C, S, B = sb.shape
    A = oh.shape[1]
    shapes = dqn_param_shapes(S, net_dims, A, twin, duel)
    opt = _opt(lr, clip_grad, b1, b2, eps)
    objs = torch.empty((C, 2), dtype=torch.float32, device=sb.device)
    for u in range(C):
        x, nx, onehot = sb[u].T, nsb[u].T, oh[u].T
        with torch.no_grad():
            label = rb[u] + ud[u] * gamma * dqn_next_q(split_flat(t, shapes), nx, twin, duel)
        (obj, q1a), g = value_and_grad_flat(
            lambda leaves: dqn_td_loss(leaves, x, onehot, label, um[u], twin, duel), p, shapes)
        with torch.no_grad():
            objs[u] = torch.stack([obj, torch.mean(q1a)]).detach()
            if float(bcv[u, 2]) > 0:
                clip_adam_bc_(opt, p, mu, nu, g, bcv[u, 0], bcv[u, 1])
                soft_update_(t, p, tau)
    return objs


def ddpg_chunk_reference(pa, pc, ta, tc, mua, muc, nua, nuc, sb, nsb, ab, rb, ud, um, nz,
                         bcv, *, net_dims: Sequence[int], td3: bool, num_ensembles: int,
                         gamma: float, tau: float, lr: float, clip_grad: float,
                         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, iw=None):
    """Plain PyTorch version of the DDPG/TD3 chunk; in place, returns the
    ``(C, 2)`` objectives, and with the PER importance weights ``iw (C, B)``
    ``(objs, td)``: the critic loss is then ``mean(td * iw)`` and ``td (C, B)``
    the per-sample TD errors of every step, valid or not."""
    from ..agents.base import clip_adam_bc_
    C, S, B = sb.shape
    A = ab.shape[1]
    act_shapes, cri_shapes = ddpg_param_shapes(S, net_dims, A, num_ensembles)
    opt = _opt(lr, clip_grad, b1, b2, eps)
    objs = torch.empty((C, 2), dtype=torch.float32, device=sb.device)
    tds = None if iw is None else torch.empty((C, B), dtype=torch.float32, device=sb.device)

    def critic(leaves, x, a, label, u):
        td = ddpg_critic_td(leaves, x, a, label, um[u], td3)[0]
        return (torch.mean(td) if iw is None else torch.mean(td * iw[u])), td

    for u in range(C):
        x, nx, a, z = sb[u].T, nsb[u].T, ab[u].T, nz[u].T
        valid, do_act = float(bcv[u, 4]) > 0, float(bcv[u, 5]) > 0
        with torch.no_grad():
            label = ddpg_td_label(split_flat(pa, act_shapes), split_flat(tc, cri_shapes), nx,
                                  rb[u], ud[u], z, gamma, td3)
        (obj_c, td), g_c = value_and_grad_flat(
            lambda leaves: critic(leaves, x, a, label, u), pc, cri_shapes)
        if tds is not None:
            tds[u] = td.detach()
        with torch.no_grad():
            if valid:
                clip_adam_bc_(opt, pc, muc, nuc, g_c, bcv[u, 0], bcv[u, 1])
                soft_update_(tc, pc, tau)
        cri_leaves = split_flat(pc.detach(), cri_shapes)
        obj_neg, g_a = value_and_grad_flat(
            lambda leaves: ddpg_actor_loss(leaves, cri_leaves, x), pa, act_shapes)
        with torch.no_grad():
            if valid and do_act:
                clip_adam_bc_(opt, pa, mua, nua, g_a, bcv[u, 2], bcv[u, 3])
                soft_update_(ta, pa, tau)
            objs[u] = torch.stack([obj_c, -obj_neg]).detach()
    return objs if tds is None else (objs, tds)


def sac_chunk_reference(pa, pc, ta, tc, mua, muc, nua, nuc, misc, sb, nsb, ab, rb, ud, um,
                        nzn, nzp, bcv, *, net_dims: Sequence[int], modsac: bool,
                        num_ensembles: int, gamma: float, tau: float, lr: float,
                        clip_grad: float, target_entropy: float, std_clip,
                        b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                        ) -> torch.Tensor:
    """Plain PyTorch version of the SAC/ModSAC chunk; in place (``ta`` is None
    for SAC), returns the ``(C, 3)`` objectives."""
    from ..agents.base import clip_adam_bc_
    C, S, B = sb.shape
    A, E = ab.shape[1], int(num_ensembles)
    act_shapes = sac_act_shapes(S, net_dims, A, modsac)
    cri_shapes = sac_cri_shapes(S, A, net_dims, E)
    opt = _opt(lr, clip_grad, b1, b2, eps)
    sac = dict(modsac=modsac, std_clip=std_clip)
    objs = torch.empty((C, 3), dtype=torch.float32, device=sb.device)
    for u in range(C):
        x, nx, a, zn, zp = sb[u].T, nsb[u].T, ab[u].T, nzn[u].T, nzp[u].T
        valid = float(bcv[u, 4]) > 0
        act_leaves = split_flat(pa, act_shapes)
        with torch.no_grad():
            label = sac_td_label(act_leaves, split_flat(tc, cri_shapes), nx, rb[u], ud[u], zn,
                                 torch.exp(misc[0]), gamma, num_ensembles=E, **sac)
        obj_c, g_c = value_and_grad_flat(
            lambda lv: sac_critic_loss(lv, x, a, label, um[u], E), pc, cri_shapes)
        with torch.no_grad():
            lp_mean = torch.mean(sac_action_logprob(act_leaves, x, zp, **sac)[1])
            al2, mu2, nu2 = sac_alpha_step(misc[0], misc[1], misc[2], lp_mean, target_entropy,
                                           bcv[u, 2], bcv[u, 3], lr, clip_grad, b1, b2, eps)
            do_act, update_a = (modsac_do_actor(int(misc[4]), int(bcv[u, 5])) if modsac
                                else (True, None))
            if valid:
                clip_adam_bc_(opt, pc, muc, nuc, g_c, bcv[u, 0], bcv[u, 1])
                soft_update_(tc, pc, tau)
                misc[0], misc[1], misc[2] = al2, mu2, nu2
                if modsac:
                    misc[4] = float(update_a)
        cri_leaves = split_flat(tc.detach(), cri_shapes)
        obj_neg, g_a = value_and_grad_flat(
            lambda lv: sac_actor_loss(lv, cri_leaves, x, zp, torch.exp(al2),
                                      num_ensembles=E, **sac), pa, act_shapes)
        with torch.no_grad():
            if valid and do_act:
                count = misc[3] + 1.0
                clip_adam_bc_(opt, pa, mua, nua, g_a, 1.0 - torch.exp(count * math.log(b1)),
                              1.0 - torch.exp(count * math.log(b2)))
                if modsac:
                    soft_update_(ta, pa, tau)
                misc[3] = count
            objs[u] = torch.stack([obj_c.detach(), -obj_neg.detach(),
                                   obj_c.new_tensor(float(valid and do_act))])
    return objs


# ------------------------------------------------------------ wrappers

def dqn_variant(twin: bool, duel: bool) -> str:
    return {(False, False): 'dqn', (True, False): 'doubledqn', (False, True): 'duelingdqn',
            (True, True): 'd3qn'}[(bool(twin), bool(duel))]


# Shared memory of one block of the update chunks' persistent kernels, the
# same for every width, batch, head and ensemble: gg::Smem (two 32 x 33
# operand tiles, 8 x 2 reduction slots), then for the DQN chunk 8 warps' 2 x
# 64 head rows.  The .cu files own the layouts (dqn_update_smem_bytes,
# ddpg_update_smem_bytes, sac_update_smem_bytes); chip_smoke.py checks these
# copies.
GG_SMEM_BYTES = 4 * (2 * 32 * 33 + 8 * 2)
DQN_SMEM_BYTES = GG_SMEM_BYTES + 4 * 8 * 2 * 64
DDPG_SMEM_BYTES = SAC_SMEM_BYTES = GG_SMEM_BYTES


def dqn_fits(net_dims: Sequence[int]) -> bool:
    """Whether the DQN chunk's kernel takes a net: any of two hidden layers
    (its shared memory, ``DQN_SMEM_BYTES``, does not grow with the widths,
    the batch or the heads)."""
    return len(net_dims) == 2


def ddpg_fits(net_dims: Sequence[int]) -> bool:
    """Whether the DDPG/TD3 chunk's kernel takes a net: any of two hidden
    layers, any batch or ensemble (``DDPG_SMEM_BYTES`` does not grow with
    them; the activations live in the workspace)."""
    return len(net_dims) == 2


def sac_fits(net_dims: Sequence[int]) -> bool:
    """Whether the SAC/ModSAC chunk's kernel takes a net: any of two hidden
    layers, any batch or ensemble (``SAC_SMEM_BYTES`` does not grow with
    them)."""
    return len(net_dims) == 2


def _check_blocks(what, dev, C, S, A, B, blocks, bcv, bcv_cols):
    from ._cuda_build import check_tensor
    for name, t, shape in blocks:
        check_tensor(what, name, t, shape, torch.float32, dev)
    check_tensor(what, 'bcv', bcv, (C, bcv_cols), torch.float32, dev)


def dqn_chunk(p, t, mu, nu, sb, nsb, oh, rb, ud, um, bcv, *, net_dims: Sequence[int],
              twin: bool, duel: bool, gamma: float, tau: float, lr: float, clip_grad: float,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
              trace=None) -> torch.Tensor:
    """The DQN-family chunk: CUDA kernel for CUDA tensors (one cooperative
    launch, one block per SM; a card that refuses the launch raises), the
    plain version for CPU tensors.  In place; returns the ``(C, 2)``
    objectives.  ``trace``, a ``(C, 8)`` int64 CUDA tensor, receives the
    kernel's phase stamps (ns; ``dqn_phase_ms`` reads them)."""
    kw = dict(net_dims=net_dims, twin=twin, duel=duel, gamma=gamma, tau=tau, lr=lr,
              clip_grad=clip_grad, b1=b1, b2=b2, eps=eps)
    args = (p, t, mu, nu, sb, nsb, oh, rb, ud, um, bcv)
    if p.device.type == 'cpu':
        return dqn_chunk_reference(*args, **kw)
    if p.device.type != 'cuda':
        raise ValueError(f'dqn_chunk: unsupported device {p.device}')
    if len(net_dims) != 2:
        raise ValueError(f'dqn_chunk: the CUDA kernel takes 2 hidden layers, got {net_dims}')
    from ._cuda_build import check, check_tensor, ptr
    D1, D2 = (int(d) for d in net_dims)
    C, S, B = sb.shape
    A = oh.shape[1]
    dev = p.device
    P = sum(math.prod(s) for s in dqn_param_shapes(S, (D1, D2), A, twin, duel))
    for name, buf in (('p', p), ('t', t), ('mu', mu), ('nu', nu)):
        check_tensor('dqn_chunk', name, buf, (P,), torch.float32, dev)
    _check_blocks('dqn_chunk', dev, C, S, A, B,
                  (('sb', sb, (C, S, B)), ('nsb', nsb, (C, S, B)), ('oh', oh, (C, A, B)),
                   ('rb', rb, (C, B)), ('ud', ud, (C, B)), ('um', um, (C, B))), bcv, 3)
    if trace is not None:
        check_tensor('dqn_chunk', 'trace', trace, (C, 8), torch.int64, dev)
    lib = _dqn_library()
    grid = _coop_grid(lib, 'dqn_update', dev)
    ws = torch.empty(lib.dqn_update_workspace_floats(B, S, A, D1, D2, int(bool(twin)),
                                                     int(bool(duel)), grid),
                     dtype=torch.float32, device=dev)
    objs = torch.empty((C, 2), dtype=torch.float32, device=dev)
    f = ctypes.c_float
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.dqn_update(
        *[ptr(x) for x in (p, t, mu, nu, sb, nsb, oh, rb, ud, um, bcv, ws, objs, trace)],
        grid, C, B, S, A, D1, D2, int(bool(twin)), int(bool(duel)),
        f(gamma), f(tau), f(lr), f(clip_grad), f(b1), f(b2), f(eps), ctypes.c_void_p(stream))
    variant = dqn_variant(twin, duel)
    check(status, f'dqn_update[{variant}]')
    dqn_chunk.launches += 1
    dqn_chunk.launches_by_variant[variant] += 1
    return objs


dqn_chunk.launches = 0
dqn_chunk.launches_by_variant = {v: 0 for v in ('dqn', 'doubledqn', 'duelingdqn', 'd3qn')}


def ddpg_chunk(pa, pc, ta, tc, mua, muc, nua, nuc, sb, nsb, ab, rb, ud, um, nz, bcv, *,
               net_dims: Sequence[int], td3: bool, num_ensembles: int, gamma: float,
               tau: float, lr: float, clip_grad: float, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, iw=None, trace=None):
    """The DDPG/TD3 chunk: CUDA kernel for CUDA tensors (one cooperative
    launch, one block per SM; a card that refuses the launch raises), the
    plain version for CPU tensors.  In place; returns the ``(C, 2)``
    objectives, or with PER's importance weights ``iw (C, B)`` (K7') ``(objs,
    td (C, B))``.  ``trace``, a ``(C, len(DDPG_PHASES) + 1)`` int64 CUDA
    tensor, receives the kernel's phase stamps (``ddpg_phase_ms``)."""
    kw = dict(net_dims=net_dims, td3=td3, num_ensembles=num_ensembles, gamma=gamma, tau=tau,
              lr=lr, clip_grad=clip_grad, b1=b1, b2=b2, eps=eps, iw=iw)
    args = (pa, pc, ta, tc, mua, muc, nua, nuc, sb, nsb, ab, rb, ud, um, nz, bcv)
    if pa.device.type == 'cpu':
        return ddpg_chunk_reference(*args, **kw)
    if pa.device.type != 'cuda':
        raise ValueError(f'ddpg_chunk: unsupported device {pa.device}')
    if not ddpg_fits(net_dims):
        raise ValueError(f'ddpg_chunk: the CUDA kernel takes 2 hidden layers, got {net_dims}')
    from ._cuda_build import check, check_tensor, ptr
    D1, D2 = (int(d) for d in net_dims)
    C, S, B = sb.shape
    A, E = ab.shape[1], int(num_ensembles)
    dev = pa.device
    act_shapes, cri_shapes = ddpg_param_shapes(S, (D1, D2), A, E)
    Pa = sum(math.prod(s) for s in act_shapes)
    Pc = sum(math.prod(s) for s in cri_shapes)
    for name, buf in (('pa', pa), ('ta', ta), ('mua', mua), ('nua', nua)):
        check_tensor('ddpg_chunk', name, buf, (Pa,), torch.float32, dev)
    for name, buf in (('pc', pc), ('tc', tc), ('muc', muc), ('nuc', nuc)):
        check_tensor('ddpg_chunk', name, buf, (Pc,), torch.float32, dev)
    _check_blocks('ddpg_chunk', dev, C, S, A, B,
                  (('sb', sb, (C, S, B)), ('nsb', nsb, (C, S, B)), ('ab', ab, (C, A, B)),
                   ('nz', nz, (C, A, B)), ('rb', rb, (C, B)), ('ud', ud, (C, B)),
                   ('um', um, (C, B))), bcv, 7)
    if iw is not None:
        check_tensor('ddpg_chunk', 'iw', iw, (C, B), torch.float32, dev)
    if trace is not None:
        check_tensor('ddpg_chunk', 'trace', trace, (C, len(DDPG_PHASES) + 1), torch.int64, dev)
    lib = _ddpg_library()
    grid = _coop_grid(lib, 'ddpg_update', dev)
    ws = torch.empty(lib.ddpg_update_workspace_floats(B, S, A, D1, D2, E, grid),
                     dtype=torch.float32, device=dev)
    objs = torch.empty((C, 2), dtype=torch.float32, device=dev)
    td = None if iw is None else torch.empty((C, B), dtype=torch.float32, device=dev)
    f = ctypes.c_float
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.ddpg_update(
        *[ptr(x) for x in (pa, pc, ta, tc, mua, muc, nua, nuc, sb, nsb, ab, rb, ud, um, nz, bcv,
                           iw, td, ws, objs, trace)],
        grid, C, B, S, A, D1, D2, E, int(bool(td3)),
        f(gamma), f(tau), f(lr), f(clip_grad), f(b1), f(b2), f(eps), ctypes.c_void_p(stream))
    variant = ('td3' if td3 else 'ddpg') + ('' if iw is None else '_per')
    check(status, f'ddpg_update[{variant}]')
    ddpg_chunk.launches += 1
    ddpg_chunk.launches_by_variant[variant] += 1
    return objs if td is None else (objs, td)


ddpg_chunk.launches = 0
ddpg_chunk.launches_by_variant = {'ddpg': 0, 'td3': 0, 'ddpg_per': 0, 'td3_per': 0}


def sac_chunk(pa, pc, ta, tc, mua, muc, nua, nuc, misc, sb, nsb, ab, rb, ud, um, nzn, nzp,
              bcv, *, net_dims: Sequence[int], modsac: bool, num_ensembles: int, gamma: float,
              tau: float, lr: float, clip_grad: float, target_entropy: float, std_clip,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
              trace=None) -> torch.Tensor:
    """The SAC/ModSAC chunk: CUDA kernel for CUDA tensors (one cooperative
    launch, one block per SM; a card that refuses the launch raises), the
    plain version for CPU tensors.  In place (``ta`` is None for SAC);
    returns the ``(C, 3)`` objectives.  ``trace``, a ``(C, len(SAC_PHASES) +
    1)`` int64 CUDA tensor, receives the kernel's phase stamps
    (``sac_phase_ms``)."""
    kw = dict(net_dims=net_dims, modsac=modsac, num_ensembles=num_ensembles, gamma=gamma,
              tau=tau, lr=lr, clip_grad=clip_grad, target_entropy=target_entropy,
              std_clip=std_clip, b1=b1, b2=b2, eps=eps)
    args = (pa, pc, ta, tc, mua, muc, nua, nuc, misc, sb, nsb, ab, rb, ud, um, nzn, nzp, bcv)
    if pa.device.type == 'cpu':
        return sac_chunk_reference(*args, **kw)
    if pa.device.type != 'cuda':
        raise ValueError(f'sac_chunk: unsupported device {pa.device}')
    if not sac_fits(net_dims):
        raise ValueError(f'sac_chunk: the CUDA kernel takes 2 hidden layers, got {net_dims}')
    if (ta is None) == bool(modsac):
        raise ValueError('sac_chunk: ModSAC takes an actor target, SAC none')
    from ._cuda_build import check, check_tensor, ptr
    D1, D2 = (int(d) for d in net_dims)
    C, S, B = sb.shape
    A, E = ab.shape[1], int(num_ensembles)
    dev = pa.device
    Pa = sum(math.prod(s) for s in sac_act_shapes(S, (D1, D2), A, modsac))
    Pc = sum(math.prod(s) for s in sac_cri_shapes(S, A, (D1, D2), E))
    for name, buf in (('pa', pa), ('ta', ta), ('mua', mua), ('nua', nua)):
        if buf is not None:
            check_tensor('sac_chunk', name, buf, (Pa,), torch.float32, dev)
    for name, buf in (('pc', pc), ('tc', tc), ('muc', muc), ('nuc', nuc)):
        check_tensor('sac_chunk', name, buf, (Pc,), torch.float32, dev)
    check_tensor('sac_chunk', 'misc', misc, (5,), torch.float32, dev)
    _check_blocks('sac_chunk', dev, C, S, A, B,
                  (('sb', sb, (C, S, B)), ('nsb', nsb, (C, S, B)), ('ab', ab, (C, A, B)),
                   ('nzn', nzn, (C, A, B)), ('nzp', nzp, (C, A, B)), ('rb', rb, (C, B)),
                   ('ud', ud, (C, B)), ('um', um, (C, B))), bcv, 7)
    if trace is not None:
        check_tensor('sac_chunk', 'trace', trace, (C, len(SAC_PHASES) + 1), torch.int64, dev)
    lib = _sac_library()
    grid = _coop_grid(lib, 'sac_update', dev)
    ws = torch.empty(lib.sac_update_workspace_floats(B, S, A, D1, D2, E, grid),
                     dtype=torch.float32, device=dev)
    objs = torch.empty((C, 3), dtype=torch.float32, device=dev)
    f = ctypes.c_float
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.sac_update(
        *[ptr(x) for x in (pa, pc, ta, tc, mua, muc, nua, nuc, misc, sb, nsb, ab, rb, ud, um,
                           nzn, nzp, bcv, ws, objs, trace)],
        grid, C, B, S, A, D1, D2, E, int(bool(modsac)),
        *[f(v) for v in (gamma, tau, lr, clip_grad, b1, b2, eps, target_entropy, std_clip[0],
                         std_clip[1], SAC_RELIABLE)], ctypes.c_void_p(stream))
    variant = 'modsac' if modsac else 'sac'
    check(status, f'sac_update[{variant}]')
    sac_chunk.launches += 1
    sac_chunk.launches_by_variant[variant] += 1
    return objs


sac_chunk.launches = 0
sac_chunk.launches_by_variant = {'sac': 0, 'modsac': 0}


def _bind(lib, name, n_ptr, n_int, n_float, n_sizes):
    """ctypes signatures of a chunk's launcher ``name`` (pointers, the grid
    and ints, floats, the stream) and of ``name_smem_bytes``, ``name_grid``,
    ``name_phases`` and ``name_workspace_floats`` (``n_sizes`` ints)."""
    fn = getattr(lib, name)
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * n_ptr + [i] * n_int + [ctypes.c_float] * n_float + [vp]
        fn.restype = i
        for suffix in ('_smem_bytes', '_grid', '_phases'):
            g = getattr(lib, name + suffix)
            g.argtypes, g.restype = [], i
        ws = getattr(lib, name + '_workspace_floats')
        ws.argtypes, ws.restype = [i] * n_sizes, ctypes.c_longlong
    return lib


def _dqn_library():
    from ._cuda_build import load
    return _bind(load('dqn_update'), 'dqn_update', 14, 9, 7, 8)


def _ddpg_library():
    from ._cuda_build import load
    return _bind(load('ddpg_update'), 'ddpg_update', 21, 9, 7, 7)


def _sac_library():
    from ._cuda_build import load
    return _bind(load('sac_update'), 'sac_update', 21, 9, 11, 7)


DQN_PHASES = ('layer 1', 'layer 2', 'heads and loss', 'head grads', 'layer 2 grads',
              'layer 1 grads', 'clip + Adam + Polyak')
DDPG_PHASES = ('layer 1 (actor nx, x; critic)', 'layer 2', "a', a_pi, q", 'target layer 1',
               'target layer 2', 'label and loss', 'critic head grads', 'critic layer 2 grads',
               'critic layer 1 grads', 'critic split sums', 'critic clip + Adam + Polyak',
               'actor step layer 1', 'actor step layer 2', 'actor step q', 'actor step dlayer 1',
               'actor step da', 'actor head grads', 'actor layer 2 grads',
               'actor layer 1 grads', 'actor split sums', 'actor clip + Adam + Polyak')
SAC_PHASES = ('layer 1 (actor nx, x; encoder)', 'layer 2, head layers', 'draws, q',
              'target encoder', 'target head layers', 'label, loss, alpha step',
              'critic head grads, dencoding', 'encoder grads', 'critic split sums',
              'critic clip + Adam + Polyak', 'actor step encoder', 'actor step head layers',
              'actor step q', 'actor step dencoding', 'actor step dhead', 'actor head grads',
              'actor layer 2 grads', 'actor layer 1 grads', 'actor split sums',
              'actor clip + Adam')


def phase_ms(trace: torch.Tensor, names: Sequence[str]) -> dict:
    """Mean ms per update of each of a chunk kernel's phases, from its
    ``trace`` buffer (block 0's stamps at the start and after each phase's
    barrier; the last update's last phase is block 0's alone)."""
    t = trace.detach().cpu().double()
    d = (t[:, 1:] - t[:, :-1]) / 1e6
    return {name: float(d[:, k].mean()) for k, name in enumerate(names)}


def dqn_phase_ms(trace: torch.Tensor) -> dict:
    """:func:`phase_ms` of the DQN chunk (``dqn_chunk(..., trace=)``)."""
    return phase_ms(trace, DQN_PHASES)


def ddpg_phase_ms(trace: torch.Tensor) -> dict:
    """:func:`phase_ms` of the DDPG/TD3 chunk (``ddpg_chunk(..., trace=)``)."""
    return phase_ms(trace, DDPG_PHASES)


def sac_phase_ms(trace: torch.Tensor) -> dict:
    """:func:`phase_ms` of the SAC/ModSAC chunk (``sac_chunk(..., trace=)``)."""
    return phase_ms(trace, SAC_PHASES)


_grids = {}


def _coop_grid(lib, name: str, dev) -> int:
    """Blocks of a chunk's cooperative launch on ``dev`` (one per SM);
    raises where the card cannot launch it cooperatively."""
    key = (name, torch.device(dev).index if torch.device(dev).index is not None
           else torch.cuda.current_device())
    if key not in _grids:
        with torch.cuda.device(key[1]):
            grid = getattr(lib, name + '_grid')()
        if grid <= 0:
            raise RuntimeError(f'{name}: the card refuses the cooperative launch of one '
                               f'block per SM (CUDA error {-grid})')
        _grids[key] = grid
    return _grids[key]


# ------------------------------------------------- the per-step tables

def dqn_bcv(count0: int, idx: torch.Tensor, update_times: int, b1: float = 0.9,
            b2: float = 0.999) -> torch.Tensor:
    """``(C, 3)`` float32 ``(1 - b1**step, 1 - b2**step, valid)`` for the chunk
    of update indices ``idx``, ``step = count0 + idx + 1``, as the JAX agents
    build it (``agents/dqn.py:_fused_update``)."""
    steps = float(count0) + idx.float() + 1.0
    valid = (idx < update_times).float()
    return torch.stack([1.0 - torch.pow(torch.tensor(b1, device=idx.device), steps),
                        1.0 - torch.pow(torch.tensor(b2, device=idx.device), steps),
                        valid], dim=1)


def ddpg_bcv(cc0: int, ca0: int, idx: torch.Tensor, update_times: int, do_act: torch.Tensor,
             act_steps: torch.Tensor, b1: float = 0.9, b2: float = 0.999) -> torch.Tensor:
    """``(C, 7)`` float32 ``(bc1_c, bc2_c, bc1_a, bc2_a, valid, do_act, 0)``:
    the critic's step is ``cc0 + idx + 1``, the actor's ``ca0 + act_steps``
    (``agents/ddpg_td3.py:_fused_update``)."""
    dev = idx.device
    pw = lambda beta, s: 1.0 - torch.pow(torch.tensor(beta, device=dev), s)  # noqa: E731
    cri_step = float(cc0) + idx.float() + 1.0
    act_step = float(ca0) + act_steps.float()
    valid = (idx < update_times).float()
    return torch.stack([pw(b1, cri_step), pw(b2, cri_step), pw(b1, act_step), pw(b2, act_step),
                        valid, do_act.float(), torch.zeros_like(valid)], dim=1)


def sac_bcv(cc0: int, cl0: int, idx: torch.Tensor, update_times: int, b1: float = 0.9,
            b2: float = 0.999) -> torch.Tensor:
    """``(C, 7)`` float32 ``(bc1_c, bc2_c, bc1_alpha, bc2_alpha, valid,
    update_t, 0)``: the critic's step is ``cc0 + idx + 1``, the temperature's
    ``cl0 + idx + 1`` (``elegantrl_tpu/agents/sac.py:_fused_update``); the
    actor's bias corrections come from its count in ``misc``."""
    dev = idx.device
    pw = lambda beta, s: 1.0 - torch.pow(torch.tensor(beta, device=dev), s)  # noqa: E731
    cri_step = float(cc0) + idx.float() + 1.0
    al_step = float(cl0) + idx.float() + 1.0
    valid = (idx < update_times).float()
    return torch.stack([pw(b1, cri_step), pw(b2, cri_step), pw(b1, al_step), pw(b2, al_step),
                        valid, idx.float(), torch.zeros_like(valid)], dim=1)
