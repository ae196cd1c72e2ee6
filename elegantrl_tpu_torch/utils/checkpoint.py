"""Checkpointing as flat npz archives (counterpart of
``elegantrl_tpu/utils/checkpoint.py``).

A tree is nested dicts (keys in sorted order, as JAX flattens them),
lists, tuples and NamedTuples with tensor, array or number leaves.  Each
leaf is stored under ``"{index:04d}|{path}"``; loading needs a template
tree of the same structure, so nothing is unpickled.
"""

from __future__ import annotations

import os
from typing import Any, Iterator, List, Tuple

import numpy as np
import torch


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, '_fields'):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return []


def _is_leaf(tree) -> bool:
    return not isinstance(tree, (dict, list, tuple)) and tree is not None


def tree_leaves_with_path(tree, prefix: str = '') -> List[Tuple[str, Any]]:
    if _is_leaf(tree):
        return [(prefix, tree)]
    out = []
    for name, child in _children(tree):
        out += tree_leaves_with_path(child, f'{prefix}/{name}' if prefix else name)
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten(template, leaves: Iterator):
    """A tree shaped like ``template`` with leaves taken in order."""
    if _is_leaf(template):
        return next(leaves)
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: tree_unflatten(template[k], leaves) for k in sorted(template)}
    children = [tree_unflatten(c, leaves) for _, c in _children(template)]
    if hasattr(template, '_fields'):
        return type(template)(*children)
    return type(template)(children)


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_tree(path: str, tree: Any) -> None:
    arrays = {f'{i:04d}|{p}': to_numpy(leaf)
              for i, (p, leaf) in enumerate(tree_leaves_with_path(tree))}
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    np.savez_compressed(path, **arrays)


def load_tree(path: str, template: Any) -> Any:
    """Leaves of ``path`` (by index) in ``template``'s structure, as numpy
    arrays of the template leaves' dtypes."""
    with np.load(path) as data:
        keys = sorted(data.files, key=lambda k: int(k.split('|')[0]))
        leaves = [data[k] for k in keys]
    t_leaves = tree_leaves(template)
    if len(leaves) != len(t_leaves):
        raise ValueError(f'{path} has {len(leaves)} leaves, the template has {len(t_leaves)}')
    cast = [np.asarray(v).astype(to_numpy(t).dtype) for v, t in zip(leaves, t_leaves)]
    return tree_unflatten(template, iter(cast))


# the JAX package's names (elegantrl_tpu/utils/checkpoint.py), same signatures
save_pytree = save_tree
load_pytree = load_tree
