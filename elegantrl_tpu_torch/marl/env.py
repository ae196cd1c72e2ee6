"""Multi-agent environment protocol (CTDE layout), counterpart of
``elegantrl_tpu/marl/env.py``.

- per-agent local observations ``(num_agents, obs_dim)`` feed decentralized
  actors (parameter-shared);
- a global state ``(state_dim,)`` feeds the centralized critic;
- a shared team reward.

The JAX package writes an env for one instance and batches it with
``vmap``; here every function takes a batch of envs on the leading axis,
its tensors on the device the caller names.  Randomness comes from an
explicit ``torch.Generator``, or is injected (``noise=``): tests replay the
JAX draws that way.

Also here, the parameter trees every trainer of ``marl/`` keeps: the JAX
package's nesting (dicts, lists of ``(w, b)`` with ``w`` stored ``(in,
out)``, NamedTuples), as views of one flat float32 buffer per optimised
group, so the optimizer (``agents/base.py:grad_step``, clip by the global
norm then Adam) steps the flat buffer in place and the leaves follow.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Callable, NamedTuple, Sequence

import torch

from ..config import resolve_device
from ..ops.nets import linear_init, orthogonal_init
from ..utils.checkpoint import tree_leaves, tree_unflatten


class MultiAgentEnvDef(NamedTuple):
    """Batched pure functions over an env-state NamedTuple of tensors with the
    env axis first.

    init: (gen, num_envs, device, noise=None) -> env_state
    obs: env_state -> (N, num_agents, obs_dim) local observations
    global_state: env_state -> (N, state_dim) centralized-critic input
    step: (env_state, actions (N, num_agents, action_dim) or (N,
          num_agents) int, gen, noise=None)
          -> (env_state', reward (N,), terminal (N,), truncate (N,))
    """
    env_name: str
    num_agents: int
    obs_dim: int
    state_dim: int
    action_dim: int
    if_discrete: bool
    max_step: int
    init: Callable
    obs: Callable
    global_state: Callable
    step: Callable


def trainer_device(device, owner: str) -> torch.device:
    """A trainer's device: the card for None (``config.resolve_device``,
    which raises without a GPU and names ``device='cpu'``), else the one
    named."""
    return resolve_device(SimpleNamespace(device='cuda' if device is None else device),
                          owner=owner)


def where_done(done: torch.Tensor, fresh, old):
    """The env-state tree with each env's ``fresh`` rows where ``done`` is
    set and its ``old`` rows elsewhere (the masked reset)."""
    def pick(f, o):
        return torch.where(done.reshape((-1,) + (1,) * (o.dim() - 1)), f, o)
    return type(old)(*[pick(f, o) for f, o in zip(fresh, old)])


# ------------------------------------------------------- parameter trees

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, out_std=None):
    """One layer ``(w (in, out), b)`` as the JAX package's ``linear_init``
    (``out_std`` None) or ``orthogonal_init`` draws it, from ``gen``."""
    layer = (linear_init(gen, in_dim, out_dim) if out_std is None
             else orthogonal_init(gen, in_dim, out_dim, std=out_std))
    return layer.weight.detach().t().contiguous(), layer.bias.detach().clone()


def mlp_tree_init(gen: torch.Generator, dims: Sequence[int], out_std=None) -> list:
    """An MLP ``dims[0] -> ... -> dims[-1]`` as the JAX package's
    ``mlp_init``: a list of ``(w (in, out), b)``, the last layer orthogonal
    with gain ``out_std`` when given."""
    n = len(dims) - 1
    return [dense_init(gen, dims[i], dims[i + 1], out_std if i == n - 1 else None)
            for i in range(n)]


def mlp_tree_apply(layers: Sequence, x: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``mlp_apply``: ``x w + b`` per layer, tanh-GELU
    between layers, the last one raw."""
    n = len(layers)
    for i, (w, b) in enumerate(layers):
        x = torch.matmul(x, w) + b
        if i < n - 1:
            x = torch.nn.functional.gelu(x, approximate='tanh')
    return x


def flat_tree(tree, device=None):
    """``(flat, views)``: ``tree``'s leaves copied, in the JAX package's
    flatten order (dict keys sorted), into one float32 buffer on ``device``
    (the leaves' own by default), and the tree rebuilt from views of it."""
    leaves = tree_leaves(tree)
    device = device if device is not None else leaves[0].device
    flat = torch.cat([torch.as_tensor(x, dtype=torch.float32).reshape(-1).to(device)
                      for x in leaves])
    return flat, tree_views(flat, tree)


def tree_views(flat: torch.Tensor, template):
    """Views of ``flat`` shaped as ``template``'s leaves, in its order."""
    views, off = [], 0
    for leaf in tree_leaves(template):
        n = leaf.numel() if isinstance(leaf, torch.Tensor) else int(leaf.size)
        views.append(flat[off:off + n].view(tuple(leaf.shape)))
        off += n
    if off != flat.numel():
        raise ValueError(f'tree_views: the buffer has {flat.numel()} values, the tree {off}')
    return tree_unflatten(template, iter(views))


def tree_grad(loss_fn: Callable, flat: torch.Tensor, template) -> tuple:
    """``(loss, gradient)``: ``loss_fn(views)`` on views of a copy of
    ``flat`` that requires grad, and its gradient as a flat buffer."""
    leaf = flat.detach().clone().requires_grad_(True)
    loss = loss_fn(tree_views(leaf, template))
    grad, = torch.autograd.grad(loss, leaf)
    return loss.detach(), grad


def tree_numpy(tree) -> Any:
    """``tree`` with its tensor leaves as numpy arrays (copies)."""
    return tree_unflatten(tree, iter([x.detach().cpu().numpy().copy()
                                      for x in tree_leaves(tree)]))
