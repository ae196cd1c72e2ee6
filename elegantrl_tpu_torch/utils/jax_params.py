"""Carry PPO weights and optimizer state between the JAX package's layout
and the port's, through numpy.

The JAX ``PPOState`` after ``jax.tree.map(np.asarray, state)`` is

- ``act = {'mlp': [(w, b), (w, b), (w, b)], 'std_log': (1, A)}``, ``w`` as
  ``(in, out)``, without ``std_log`` for a discrete agent;
  ``cri = [(w, b), (w, b), (w, b)]``;
- ``act_opt``/``cri_opt``: optax chain states whose ``[1][0]`` is
  ``ScaleByAdamState(count, mu, nu)`` with ``mu``/``nu`` shaped like the
  params;
- ``norm_avg``, ``norm_std``.

It is read by field name where there is one and by position otherwise,
so nothing of JAX or optax is imported.  :func:`ppo_state_to_numpy`
returns the same nesting with local NamedTuples, leaf for leaf in JAX's
flatten order (dict keys sorted), so tests compare the two trees leaf by
leaf.  :func:`env_state_from_numpy` carries an env state (any NamedTuple
of arrays with the port's field names) across the same way.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..agents.base import AdamState
from ..agents.ppo import PPOState, modules_from_flat


class NumpyPPOState(NamedTuple):
    act: dict
    cri: list
    act_opt: tuple
    cri_opt: tuple
    norm_avg: np.ndarray
    norm_std: np.ndarray


class NumpyAdamState(NamedTuple):
    count: np.ndarray
    mu: Any
    nu: Any


def _field(tree, name: str, index: int):
    return getattr(tree, name) if hasattr(tree, name) else tree[index]


def _flat_act(act) -> np.ndarray:
    parts = [p for w, b in act['mlp'] for p in (np.asarray(w).T, np.asarray(b))]
    if 'std_log' in act:
        parts.append(np.asarray(act['std_log']))
    return np.concatenate([p.reshape(-1) for p in parts]).astype(np.float32)


def _flat_cri(cri) -> np.ndarray:
    parts = [p for w, b in cri for p in (np.asarray(w).T, np.asarray(b))]
    return np.concatenate([p.reshape(-1) for p in parts]).astype(np.float32)


def ppo_state_from_numpy(tree, device) -> PPOState:
    """The port's agent state from a numpy JAX ``PPOState``."""
    act, cri = _field(tree, 'act', 0), _field(tree, 'cri', 1)
    mlp = act['mlp']
    state_dim = np.asarray(mlp[0][0]).shape[0]
    net_dims = tuple(np.asarray(w).shape[1] for w, _ in mlp[:-1])
    action_dim = np.asarray(mlp[-1][0]).shape[1]
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device)  # noqa: E731
    act_flat, cri_flat = t(_flat_act(act)), t(_flat_cri(cri))
    a_mod, c_mod = modules_from_flat(act_flat, cri_flat, state_dim, net_dims, action_dim,
                                     discrete='std_log' not in act)

    def adam(opt, flatten):
        st = opt[1][0]
        mu, nu = _field(st, 'mu', 1), _field(st, 'nu', 2)
        return AdamState(int(np.asarray(_field(st, 'count', 0))),
                         t(flatten(mu)), t(flatten(nu)))

    return PPOState(a_mod, c_mod, act_flat, cri_flat,
                    adam(_field(tree, 'act_opt', 2), _flat_act),
                    adam(_field(tree, 'cri_opt', 3), _flat_cri),
                    t(_field(tree, 'norm_avg', 4)), t(_field(tree, 'norm_std', 5)))


def _unflat_act(flat: torch.Tensor, act_module) -> dict:
    layers = act_module.mlp.layers
    leaves, off = [], 0
    flat = flat.detach().cpu().numpy().copy()   # a snapshot, not a view
    for layer in layers:
        o, i = layer.weight.shape
        w = flat[off:off + o * i].reshape(o, i).T
        off += o * i
        b = flat[off:off + o]
        off += o
        leaves.append((w.copy(), b))
    if act_module.std_log is None:
        return {'mlp': leaves}
    a = layers[-1].weight.shape[0]
    return {'mlp': leaves, 'std_log': flat[off:off + a].reshape(1, a)}


def _unflat_cri(flat: torch.Tensor, cri_module) -> list:
    leaves, off = [], 0
    flat = flat.detach().cpu().numpy().copy()   # a snapshot, not a view
    for layer in cri_module.layers:
        o, i = layer.weight.shape
        w = flat[off:off + o * i].reshape(o, i).T
        off += o * i
        leaves.append((w.copy(), flat[off:off + o]))
        off += o
    return leaves


def ppo_state_to_numpy(state: PPOState) -> NumpyPPOState:
    """The JAX package's nesting of the port's agent state, as numpy."""
    def opt(o, unflat, module):
        adam = NumpyAdamState(np.asarray(o.count, np.int32), unflat(o.mu, module),
                              unflat(o.nu, module))
        return ((), (adam, ()))

    return NumpyPPOState(
        act=_unflat_act(state.act_flat, state.act),
        cri=_unflat_cri(state.cri_flat, state.cri),
        act_opt=opt(state.act_opt, _unflat_act, state.act),
        cri_opt=opt(state.cri_opt, _unflat_cri, state.cri),
        norm_avg=state.norm_avg.detach().cpu().numpy().copy(),
        norm_std=state.norm_std.detach().cpu().numpy().copy())


def env_state_from_numpy(state_class, tree, device):
    """The port's env state ``state_class`` from a JAX env state whose fields
    carry the same names, as tensors on ``device`` (dtypes kept)."""
    return state_class(*[torch.tensor(np.asarray(getattr(tree, name)), device=device)
                         for name in state_class._fields])
