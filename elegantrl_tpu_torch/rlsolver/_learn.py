"""Parameters and optimizers of the learned solvers.

A learned solver's parameters are a tree (NamedTuples, tuples and dicts) of
float32 tensors laid out as the JAX package lays them out (weights ``(in,
out)``), so weights carry across leaf for leaf
(``utils/jax_params.py``).  Its optax chain, ``adam(lr)`` or
``chain(clip_by_global_norm(c), adam(lr))``, is the port's
:class:`~..agents.base.ClipAdam` over the leaves flattened in the JAX
flatten order (dict keys sorted); Adam is elementwise, so the moments of
each leaf (and of each replica of a stacked leaf) stay its own.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from ..agents.base import AdamState, ClipAdam, grad_step
from ..marl.env import flat_tree
from ..utils.checkpoint import tree_leaves, tree_unflatten


def adam(lr: float, clip: float = math.inf, eps: float = 1e-8) -> ClipAdam:
    """optax ``adam(lr, eps=eps)``, after ``clip_by_global_norm(clip)``
    where ``clip`` is finite."""
    return ClipAdam(float(lr), float(clip), eps=float(eps))


def adam_init(params) -> AdamState:
    n = sum(x.numel() for x in tree_leaves(params))
    dev = tree_leaves(params)[0].device
    return AdamState(0, torch.zeros(n, device=dev), torch.zeros(n, device=dev))


def value_and_grad(loss_fn: Callable, params, has_aux: bool = False
                   ) -> Tuple[torch.Tensor, object, torch.Tensor]:
    """``(loss, aux, flat gradient)`` of ``loss_fn(params)`` (``aux`` None
    without ``has_aux``); a leaf the loss does not reach has a zero
    gradient, as in JAX."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    out = loss_fn(tree_unflatten(params, iter(leaves)))
    loss, aux = out if has_aux else (out, None)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    g = torch.cat([(torch.zeros_like(x) if gr is None else gr).reshape(-1)
                   for x, gr in zip(leaves, grads)])
    return loss.detach(), aux, g


def apply(opt: ClipAdam, params, state: AdamState, grads: torch.Tensor):
    """One optimizer step from a flat gradient: ``(params, state)``, the new
    parameters views of a fresh buffer (``params`` are left as they were)."""
    vec, views = flat_tree(params)
    return views, grad_step(opt, vec, state, grads)


def step(opt: ClipAdam, params, state: AdamState, loss_fn: Callable, has_aux: bool = False):
    """``(params, state, loss, aux)`` after one step on ``loss_fn``."""
    loss, aux, g = value_and_grad(loss_fn, params, has_aux)
    params, state = apply(opt, params, state, g)
    return params, state, loss, aux


def to_device(tree, device):
    return tree_unflatten(tree, iter([x.to(device) for x in tree_leaves(tree)]))


# initial weights, drawn from a CPU generator (:func:`init_generator`) and
# moved to ``device``, as the agents draw theirs

def glorot(gen: torch.Generator, shape, device) -> torch.Tensor:
    """``jax.nn.initializers.glorot_uniform`` of a 2-D ``(in, out)`` weight."""
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    return ((torch.rand(shape, generator=gen) * 2.0 - 1.0) * limit).to(device)


def orthogonal(gen: torch.Generator, shape, device, scale: float = 1.0) -> torch.Tensor:
    """``jax.nn.initializers.orthogonal`` of a 2-D ``(in, out)`` weight,
    times ``scale``."""
    w = torch.empty(shape[1], shape[0])
    torch.nn.init.orthogonal_(w, generator=gen)
    return (w.T.contiguous() * scale).to(device)


def uniform(gen: torch.Generator, shape, device, lo: float, hi: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) * (hi - lo) + lo).to(device)


def normal(gen: torch.Generator, shape, device, scale: float = 1.0) -> torch.Tensor:
    return (torch.randn(shape, generator=gen) * scale).to(device)


def init_generator(gen) -> torch.Generator:
    """A CPU generator for a net's initial weights, seeded from ``gen`` (a
    generator, whose next draw gives the seed, a ``Draws``' generator, or
    an int seed)."""
    if hasattr(gen, 'given'):                  # a Draws: its generator, if any
        gen = gen.gen
    if isinstance(gen, torch.Generator):
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen, device=gen.device))
    else:
        seed = 0 if gen is None else int(gen)
    return torch.Generator().manual_seed(seed)
