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

from ..utils.checkpoint import tree_leaves, tree_unflatten


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


def round_to(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (nearest, ties to even) and widened back to
    float32; ``x`` as float32 when ``dtype`` is None.  Its gradient is
    rounded the same way, as JAX's ``astype`` transposes."""
    return x.float() if dtype is None else x.to(dtype).float()


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``F.linear``; with ``dtype`` over ``x`` and ``w`` rounded to it, summed
    in float32 (one layer of :func:`mlp_apply_leaves`)."""
    if dtype is None:
        return F.linear(x, w, b)
    return F.linear(round_to(x, dtype), round_to(w, dtype), b)


def mlp_apply_leaves(leaves: Sequence[torch.Tensor], x: torch.Tensor,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:func:`mlp_apply` over ``[W1, b1, W2, b2, ..., Wo, bo]`` leaves.  With
    ``dtype`` (bfloat16) the JAX package's ``mlp_apply(dtype=...)``: the
    input, each weight and each hidden activation are rounded to ``dtype``,
    the products of the rounded operands are summed in float32 (a product of
    two bf16 values is exact in float32, so the float32 matmul of the
    widened operands is ``preferred_element_type=float32``'s product; a
    matmul in bf16 would round its output), biases and GELU stay float32 and
    the result is float32."""
    n = len(leaves) // 2
    if dtype is not None:
        x = round_to(x, dtype)
    for i in range(n):
        w = leaves[2 * i] if dtype is None else round_to(leaves[2 * i], dtype)
        x = F.linear(x, w, leaves[2 * i + 1])
        if i < n - 1:
            x = gelu(x)
            if dtype is not None:
                x = round_to(x, dtype)
    return x


def mlp3_forward(leaves: Sequence[torch.Tensor], x: torch.Tensor, use_kernel: bool,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The no-grad forward of a 3-linear MLP ``[W0, b0, W1, b1, W2, b2]``
    over the last axis of ``x``: K11b (``ops/kernels.py:fused_mlp3``, one
    launch on a card) when ``use_kernel`` (``config.py:select_kernel`` on
    ``use_mlp3_kernel``), else :func:`mlp_apply_leaves` (with ``dtype``, the
    bf16 compute K11b does not take: its caller declines the kernel then).
    No gradient path calls it: K11b has no backward, in the JAX package
    either."""
    if not use_kernel:
        return mlp_apply_leaves(leaves, x, dtype)
    if dtype is not None:
        raise ValueError(f'mlp3_forward: K11b computes in float32, not {dtype}')
    from .kernels import fused_mlp3    # kernels.py builds on this module
    lead = x.shape[:-1]
    out = fused_mlp3(x.reshape(-1, x.shape[-1]).float().contiguous(), *leaves)
    return out.reshape(*lead, out.shape[-1])


def soft_update_(target: torch.Tensor, online: torch.Tensor, tau: float) -> None:
    """Polyak averaging in place on flat buffers, ``target = target * (1 - tau)
    + online * tau`` (``elegantrl_tpu/ops/nets.py:soft_update``)."""
    target.mul_(1.0 - tau).add_(online * tau)


def soft_update(target, online, tau: float):
    """Polyak averaging ``target * (1 - tau) + online * tau`` over matching
    trees of tensors (a flat buffer, or lists, tuples and dicts of them),
    returned as new tensors (``elegantrl_tpu/ops/nets.py:soft_update``;
    :func:`soft_update_` updates a flat buffer in place)."""
    pairs = zip(tree_leaves(target), tree_leaves(online))
    return tree_unflatten(target, iter([t * (1.0 - tau) + o * tau for t, o in pairs]))


def ensemble_init(gen: torch.Generator, num: int, init_fn):
    """``num`` independent parameter trees from ``init_fn(gen)``, stacked
    along a new leading axis (``elegantrl_tpu/ops/nets.py:ensemble_init``:
    critic ensembles evaluated as one batched product)."""
    members = [init_fn(gen) for _ in range(int(num))]
    leaves = zip(*[tree_leaves(m) for m in members])
    return tree_unflatten(members[0], iter([torch.stack(xs) for xs in leaves]))


def global_norm(tree) -> torch.Tensor:
    """The square root of the sum of squares of every leaf of ``tree``."""
    return torch.sqrt(sum(torch.sum(torch.square(x)) for x in tree_leaves(tree)))


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


# --------------------------------------------------------- pixel encoder
# The strided conv stack of the JAX package's ``convnet_*``
# (``elegantrl_tpu/ops/nets.py``), the reference's ConvNet: per stage
# (channels, kernel, stride), VALID padding, ReLU, then one linear layer.
# The JAX package runs it as XLA ops (no Pallas kernel), so here it is
# ``torch.nn.functional.conv2d``.  The public layout stays the JAX
# package's: images NHWC, transposed to NCHW once at the input; the flat
# features are taken in NHWC order, so the linear layer's input rows are
# the JAX package's.  Leaves: per stage W (out, in, k, k) (OIHW; the JAX
# HWIO transposed) and b, then the linear W (out, in) and b.

_CONV_STAGES = {
    224: [(32, 5, 2), (48, 3, 2), (64, 3, 2), (96, 3, 2), (128, 3, 2), (192, 5, 1)],
    112: [(32, 5, 2), (48, 3, 2), (64, 3, 2), (96, 3, 2), (128, 5, 1)],
    64: [(16, 5, 2), (32, 3, 2), (32, 3, 2), (64, 3, 2), (64, 2, 1)],
}


def convnet_out_hw(image_size: int) -> int:
    """The side of the last stage's feature map (VALID convolutions)."""
    hw = image_size
    for _c, k, stride in _CONV_STAGES[image_size]:
        hw = (hw - k) // stride + 1
    return hw


def convnet_shapes(inp_dim: int, out_dim: int, image_size: int = 112) -> list:
    """Leaf shapes of :func:`convnet_apply`'s parameters, in order."""
    assert image_size in _CONV_STAGES, f'image_size must be one of {sorted(_CONV_STAGES)}'
    shapes, c_in = [], inp_dim
    for c_out, k, _stride in _CONV_STAGES[image_size]:
        shapes += [(c_out, c_in, k, k), (c_out,)]
        c_in = c_out
    return shapes + [(out_dim, c_in * convnet_out_hw(image_size) ** 2), (out_dim,)]


def convnet_init(gen: torch.Generator, inp_dim: int, out_dim: int,
                 image_size: int = 112) -> List[torch.Tensor]:
    """Leaves as the JAX ``convnet_init`` draws them (from ``gen``): conv
    weights uniform in ``+-1/sqrt(k k c_in)``, zero biases, the linear layer
    as :func:`linear_init`."""
    shapes = convnet_shapes(inp_dim, out_dim, image_size)
    leaves = []
    for w_shape, b_shape in zip(shapes[:-2:2], shapes[1:-2:2]):
        bound = 1.0 / math.sqrt(max(w_shape[1] * w_shape[2] * w_shape[3], 1))
        leaves += [torch.empty(w_shape).uniform_(-bound, bound, generator=gen),
                   torch.zeros(b_shape)]
    lin = linear_init(gen, shapes[-2][1], out_dim)
    return leaves + [lin.weight.detach().clone(), lin.bias.detach().clone()]


def convnet_apply(leaves: Sequence[torch.Tensor], x: torch.Tensor,
                  image_size: int = 112) -> torch.Tensor:
    """``x`` (batch, H, W, C), uint8 or float, scaled to ``x / 128 - 1`` (the
    reference's); returns (batch, out_dim)."""
    stages = _CONV_STAGES[image_size]
    h = (x.float() / 128.0 - 1.0).permute(0, 3, 1, 2)        # NHWC -> NCHW, once
    for i, (_c, _k, stride) in enumerate(stages):
        w, b = leaves[2 * i], leaves[2 * i + 1]
        h = F.relu(F.conv2d(h, w, stride=stride) + b[:, None, None])
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)          # NHWC order
    return F.linear(h, leaves[-2], leaves[-1])


# ------------------------------------------------------------- DenseNet
# The reference's ``DenseNet`` (``elegantrl_tpu/ops/nets.py:densenet_*``):
# two concat-growing Hardswish blocks, lay_dim -> 4 lay_dim.  Leaves as
# everywhere in the port: W (out, in), b.

def densenet_init(gen: torch.Generator, lay_dim: int) -> dict:
    """``{'dense1': (W, b), 'dense2': (W, b)}``, each layer as
    :func:`linear_init` draws it: ``lay_dim -> lay_dim``, then ``2 lay_dim ->
    2 lay_dim``."""
    out = {}
    for name, dim in (('dense1', lay_dim), ('dense2', 2 * lay_dim)):
        layer = linear_init(gen, dim, dim)
        out[name] = (layer.weight.detach().clone(), layer.bias.detach().clone())
    return out


def densenet_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    w1, b1 = params['dense1']
    x2 = torch.cat([x, F.hardswish(F.linear(x, w1, b1))], dim=-1)
    w2, b2 = params['dense2']
    return torch.cat([x2, F.hardswish(F.linear(x2, w2, b2))], dim=-1)


# ----------------------------------------------------- Ornstein-Uhlenbeck
def ou_noise_step(noise: torch.Tensor, gen: Optional[torch.Generator] = None,
                  theta: float = 0.15, sigma: float = 0.3, dt: float = 1e-2,
                  normal: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One Ornstein-Uhlenbeck step (``elegantrl_tpu/ops/nets.py:ou_noise_step``,
    the reference's sign convention): ``n - (theta n dt + sigma sqrt(dt) z)``,
    ``z`` standard normals drawn from ``gen``, or ``normal`` given (a test
    replays the JAX draws).  Functional: the caller carries ``noise``."""
    if normal is None:
        normal = torch.randn(noise.shape, generator=gen, device=noise.device, dtype=noise.dtype)
    eps = sigma * math.sqrt(dt) * normal
    return noise - (theta * noise * dt + eps)
