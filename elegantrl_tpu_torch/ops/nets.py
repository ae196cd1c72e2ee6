"""MLP building blocks (counterpart of ``elegantrl_tpu/ops/nets.py``).

The JAX package keeps nets as ``[(w, b), ...]`` pytrees with ``w`` stored
``(in, out)``.  Here a net is an ``nn.Module`` of ``nn.Linear`` layers, whose
weight is stored ``(out, in)`` — the ``W^T`` layout the fused kernels read.

The activation is GELU in its tanh form: ``jax.nn.gelu`` defaults to
``approximate=True``, so every forward here (and in the kernels) uses
``F.gelu(x, approximate='tanh')``.

:func:`bind_flat` moves a module's parameters into one contiguous buffer
and leaves the parameters as views of it, so the fused update can apply
Adam to the whole net in place with one pointer.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate='tanh')


def linear_init(gen: torch.Generator, in_dim: int, out_dim: int) -> nn.Linear:
    """Hidden layer: weight and bias uniform in ``+-1/sqrt(in_dim)``
    (torch.nn.Linear's default, as the JAX package re-derives it)."""
    layer = nn.Linear(in_dim, out_dim)
    bound = 1.0 / math.sqrt(max(in_dim, 1))
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=gen)
        layer.bias.uniform_(-bound, bound, generator=gen)
    return layer


def orthogonal_init(gen: torch.Generator, in_dim: int, out_dim: int,
                    std: float = 1.0, bias_const: float = 1e-6) -> nn.Linear:
    """Output layer: orthogonal weight scaled by ``std``, constant bias."""
    layer = nn.Linear(in_dim, out_dim)
    with torch.no_grad():
        nn.init.orthogonal_(layer.weight, gain=std, generator=gen)
        layer.bias.fill_(bias_const)
    return layer


class MLP(nn.Module):
    """Linear+GELU stack with a raw output layer."""

    def __init__(self, layers: Sequence[nn.Linear]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self, x)

    def leaves(self) -> List[nn.Parameter]:
        """Parameters in the flat-buffer order: W1, b1, W2, b2, ..."""
        return [p for layer in self.layers for p in (layer.weight, layer.bias)]


def mlp_init(gen: torch.Generator, dims: Sequence[int],
             out_std: Optional[float] = None) -> MLP:
    """An MLP ``dims[0] -> ... -> dims[-1]``; with ``out_std`` the last layer
    is orthogonal with that gain."""
    n = len(dims) - 1
    layers: List[nn.Linear] = []
    for i in range(n):
        if i == n - 1 and out_std is not None:
            layers.append(orthogonal_init(gen, dims[i], dims[i + 1], std=out_std))
        else:
            layers.append(linear_init(gen, dims[i], dims[i + 1]))
    return MLP(layers)


def mlp_apply(mlp: MLP, x: torch.Tensor) -> torch.Tensor:
    return mlp_apply_leaves(mlp.leaves(), x)


def bind_flat(params: Sequence[nn.Parameter], device: torch.device) -> torch.Tensor:
    """Copy ``params`` (in order) into one contiguous float32 buffer on
    ``device`` and make each parameter a view of it.  In-place updates of
    the returned buffer update the parameters."""
    flat = torch.cat([p.detach().reshape(-1).float() for p in params]).to(device)
    off = 0
    for p in params:
        n = p.numel()
        p.data = flat[off:off + n].view(p.shape)
        off += n
    return flat


def ppo_param_shapes(state_dim: int, net_dims: Sequence[int], action_dim: int,
                     discrete: bool = False):
    """Leaf shapes of the flat actor and critic buffers, in order.  Actor:
    ``W1 (D1,S), b1, W2 (D2,D1), b2, Wa (A,D2), ba, std_log (1,A)``, without
    the std_log leaf when ``discrete`` (the head is then A logits); critic
    the same with a ``(1, D2)`` value head and no std_log."""
    act = mlp_shapes((state_dim, *net_dims, action_dim))
    if not discrete:
        act.append((1, action_dim))
    return act, mlp_shapes((state_dim, *net_dims, 1))


def split_flat(flat: torch.Tensor, shapes) -> list:
    """Views of ``flat`` with the given leaf shapes, in order."""
    out, off = [], 0
    for shape in shapes:
        n = math.prod(shape)
        out.append(flat[off:off + n].view(shape))
        off += n
    if off != flat.numel():
        raise ValueError(f'flat buffer has {flat.numel()} values, shapes need {off}')
    return out


def mlp_apply_leaves(leaves: Sequence[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """:func:`mlp_apply` over ``[W1, b1, W2, b2, ..., Wo, bo]`` leaves."""
    n = len(leaves) // 2
    for i in range(n):
        x = F.linear(x, leaves[2 * i], leaves[2 * i + 1])
        if i < n - 1:
            x = gelu(x)
    return x


def mlp3_forward(leaves: Sequence[torch.Tensor], x: torch.Tensor, use_kernel: bool
                 ) -> torch.Tensor:
    """The no-grad forward of a 3-linear MLP ``[W0, b0, W1, b1, W2, b2]``
    over the last axis of ``x``: K11b (``ops/kernels.py:fused_mlp3``, one
    launch on a card) when ``use_kernel`` (``config.py:select_kernel`` on
    ``use_mlp3_kernel``), else :func:`mlp_apply_leaves`.  No gradient path
    calls it: K11b has no backward, in the JAX package either."""
    if not use_kernel:
        return mlp_apply_leaves(leaves, x)
    from .kernels import fused_mlp3    # kernels.py builds on this module
    lead = x.shape[:-1]
    out = fused_mlp3(x.reshape(-1, x.shape[-1]).float().contiguous(), *leaves)
    return out.reshape(*lead, out.shape[-1])


def soft_update_(target: torch.Tensor, online: torch.Tensor, tau: float) -> None:
    """Polyak averaging in place on flat buffers, ``target = target * (1 - tau)
    + online * tau`` (``elegantrl_tpu/ops/nets.py:soft_update``)."""
    target.mul_(1.0 - tau).add_(online * tau)


def mlp_shapes(dims: Sequence[int]) -> list:
    """Leaf shapes ``W (out, in), b (out,)`` of an MLP ``dims[0] -> ... ->
    dims[-1]``, in the flat-buffer order."""
    shapes = []
    for i in range(len(dims) - 1):
        shapes += [(dims[i + 1], dims[i]), (dims[i + 1],)]
    return shapes


def dqn_param_shapes(state_dim: int, net_dims: Sequence[int], action_dim: int,
                     twin: bool, duel: bool) -> list:
    """Leaf shapes of the DQN family's flat Q buffer, in the kernel leaf order
    of ``elegantrl_tpu/ops/pallas_update.py:dqn_flatten``: the plain net is
    one MLP ``S -> net_dims -> A``; the twin or dueling nets are an encoder
    ``S -> net_dims`` (no activation after its last layer) followed by the
    heads ``val1 (A)``, ``adv1 (1)`` when ``duel``, ``val2 (A)`` and ``adv2
    (1)`` when ``twin`` (``agents/dqn.py:init``)."""
    if not (twin or duel):
        return mlp_shapes((state_dim, *net_dims, action_dim))
    d = net_dims[-1]
    shapes = mlp_shapes((state_dim, *net_dims)) + mlp_shapes((d, action_dim))
    if duel:
        shapes += mlp_shapes((d, 1))
    if twin:
        shapes += mlp_shapes((d, action_dim))
        if duel:
            shapes += mlp_shapes((d, 1))
    return shapes


def ddpg_param_shapes(state_dim: int, net_dims: Sequence[int], action_dim: int,
                      num_ensembles: int):
    """Leaf shapes of the DDPG/TD3 actor ``S -> net_dims -> A`` and of the
    critic ``S + A -> net_dims -> E``, whose E outputs are the ensemble's
    heads on one shared trunk (``agents/ddpg_td3.py:init``)."""
    return (mlp_shapes((state_dim, *net_dims, action_dim)),
            mlp_shapes((state_dim + action_dim, *net_dims, num_ensembles)))


def sac_act_shapes(state_dim: int, net_dims: Sequence[int], action_dim: int,
                   modsac: bool) -> list:
    """Leaf shapes of the SAC/ModSAC actor, in the kernel leaf order of
    ``elegantrl_tpu/ops/pallas_update.py:sac_act_flatten``: the encoder ``S ->
    net_dims`` (no activation after its last layer), then SAC's head ``(2A)``
    (mean, then log_std) or ModSAC's ``avg (A)`` and ``std (A)`` heads."""
    d = net_dims[-1]
    shapes = mlp_shapes((state_dim, *net_dims))
    if modsac:
        return shapes + mlp_shapes((d, action_dim)) + mlp_shapes((d, action_dim))
    return shapes + mlp_shapes((d, 2 * action_dim))


def sac_cri_shapes(state_dim: int, action_dim: int, net_dims: Sequence[int],
                   num_ensembles: int) -> list:
    """Leaf shapes of the SAC critic ensemble (``sac_cri_flatten``): the
    encoder, one linear layer ``S + A -> net_dims[0]`` without activation,
    then per head an MLP ``net_dims -> 1``."""
    return (mlp_shapes((state_dim + action_dim, net_dims[0]))
            + mlp_shapes((*net_dims, 1)) * int(num_ensembles))


def init_flat(gen: torch.Generator, nets, device) -> torch.Tensor:
    """One flat float32 buffer on ``device`` holding the leaves of the MLPs
    ``nets = [(dims, out_std), ...]`` in order (:func:`mlp_init`; an MLP of
    one layer is that layer alone, without activation)."""
    leaves = [p.detach().reshape(-1) for dims, out_std in nets
              for p in mlp_init(gen, dims, out_std).leaves()]
    return torch.cat(leaves).float().to(device)
