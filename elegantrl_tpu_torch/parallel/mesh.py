"""Env-axis data parallelism (counterpart of ``elegantrl_tpu/parallel/mesh.py``).

The JAX package shards the env axis of the training carry over a mesh axis
``'dp'`` and jits the same round: XLA runs the rollout on each shard, gathers
for the update and keeps the parameters replicated, so a run equals the
one-device program over the union of envs.  The port does the same by hand:

- :func:`make_mesh`: the shards, one device each (several shards may share
  a device: ``devices=['cpu', 'cpu']`` on the CPU, or two shards on one
  card), this process's rank, the world size and the global indices of the
  shards this process holds (contiguous blocks of ``size / world``);
- :func:`shard_train_carry`: the env state and obs split along the env axis
  into :class:`Shards`; the agent state, the replay ring and the generator
  whole on the lead device (the first of this process's shards).  The ring
  is held whole in each process, where the JAX package shards it on
  ``num_seqs``: the same contents, more memory;
- :func:`gather_env_axis`: the union from the shards, a concatenation within
  a process and ``torch.distributed.all_gather`` across the processes of a
  mesh made over a process group (NCCL for CUDA tensors, gloo for CPU ones:
  the group's backend);
- :func:`replicate` and :func:`broadcast_agent_state`: the tensors of the
  agent state a shard's rollout reads, copied to a shard on another device,
  and rank 0's state copied into every process after the update;
- :func:`device_scope`: a card made the current device, so that a kernel
  meant for it is set up and launched there (the kernels read
  ``cudaGetDevice``; a launch on another card's stream fails).

The round (``train/runner.py``) launches the fused rollout kernel once per
shard (``ops/fused_rollout.py:make_sharded_fused_rollout``,
``make_sharded_offpolicy_rollout``), then runs the update on the gathered
union.  A mesh of several axes is as many shards as devices, in order; the
JAX package takes no kernel for it, and neither does the port.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils.checkpoint import tree_leaves, tree_unflatten


class Mesh(NamedTuple):
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]              # the size of each axis
    devices: Tuple[torch.device, ...]   # one per shard this process holds, in order
    shards: Tuple[int, ...]             # those shards' global indices
    rank: int = 0
    world_size: int = 1
    distributed: bool = False           # built over a process group: gathers run on it

    @property
    def size(self) -> int:
        """The number of shards across the processes."""
        return math.prod(self.shape)

    @property
    def lead(self) -> torch.device:
        """The device of this process's first shard: the agent state, the
        replay ring and the generator live there."""
        return self.devices[0]


class Shards:
    """This process's shards of one env-axis value (an env state tree or a
    tensor), in shard order, and the mesh they lie on."""

    def __init__(self, parts: Sequence[Any], mesh: Mesh):
        self.parts = tuple(parts)
        self.mesh = mesh

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, j: int):
        return self.parts[j]


def _grouped() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def world() -> Tuple[int, int]:
    """``(rank, world_size)`` of the default process group, ``(0, 1)`` without one."""
    if _grouped():
        import torch.distributed as dist
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_cards() -> list:
    """The cards of this process: every card in a world of one, else the
    one of its local rank (``LOCAL_RANK``, or the rank, modulo the cards)."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: torch.cuda.is_available() is False; pass "
                           "devices=['cpu', ...] to put the shards on the CPU")
    rank, size = world()
    count = torch.cuda.device_count()
    if size == 1:
        return [torch.device('cuda', i) for i in range(count)]
    return [torch.device('cuda', int(os.environ.get('LOCAL_RANK', rank)) % count)]


def mesh_devices(mesh_axes: Optional[Dict[str, int]], device) -> Optional[list]:
    """The ``devices=`` of :func:`make_mesh` for a run on ``device``: None
    (the cards) on CUDA; on the CPU one ``'cpu'`` per shard of this process
    (a size of -1 or None is one per process, as the JAX package's CPU has
    one device)."""
    if torch.device(device).type == 'cuda':
        return None
    _, size = world()
    sizes = [size if v in (None, -1) else int(v) for v in dict(mesh_axes or {}).values()]
    return ['cpu'] * max(1, math.prod(sizes) // size)


def make_mesh(mesh_axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh from ``{'dp': n}`` (n = -1 or None: every device across the
    processes; no axes: ``{'dp': -1}``).  ``devices`` are this process's
    devices, one per shard it may hold (repeats allowed); by default its
    cards (:func:`local_cards`).  A mesh that asks for more devices than
    the processes have raises and names both counts."""
    rank, size = world()
    devs = [torch.device(d) for d in (local_cards() if devices is None else devices)]
    total = size * len(devs)
    mesh_axes = dict(mesh_axes or {}) or {'dp': -1}
    sizes = tuple(total if v in (None, -1) else int(v) for v in mesh_axes.values())
    n = math.prod(sizes)
    if n > total or n < 1:
        raise ValueError(f'make_mesh({mesh_axes}): the mesh asks for {n} devices, the '
                         f'processes have {total} ({size} x {len(devs)}: '
                         f'{[str(d) for d in devs]})')
    if n % size:
        raise ValueError(f'make_mesh({mesh_axes}): {n} shards do not divide over '
                         f'{size} processes')
    per = n // size
    return Mesh(tuple(mesh_axes), sizes, tuple(devs[:per]),
                tuple(range(rank * per, (rank + 1) * per)), rank, size, _grouped())


def _map(fn, tree):
    """``tree`` with ``fn`` applied to its tensor leaves."""
    return tree_unflatten(tree, iter([fn(x) if isinstance(x, torch.Tensor) else x
                                      for x in tree_leaves(tree)]))


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def device_scope(device):
    """``torch.cuda.device(device)`` for a card: the kernels' wrappers set
    up and launch on the current device, so each launch for a card other
    than the current one runs in this scope; nothing for the CPU."""
    device = torch.device(device)
    return torch.cuda.device(device) if device.type == 'cuda' else contextlib.nullcontext()


def split_env_axis(mesh: Mesh, x: Any, dim: int = 0) -> Shards:
    """This process's shards of ``x`` (a tensor or a tree of them whose
    env axis is ``dim``), each a copy on its shard's device; a mesh of one
    shard holds ``x`` itself (moved to its device if elsewhere)."""
    leaves = [v for v in tree_leaves(x) if isinstance(v, torch.Tensor)]
    num = leaves[0].shape[dim]
    if num % mesh.size:
        raise ValueError(f'num_envs={num} does not divide over the mesh\'s {mesh.size} shards '
                         f'(axes {dict(zip(mesh.axis_names, mesh.shape))})')
    if mesh.size == 1:
        return Shards([_map(lambda v: v.to(mesh.lead), x)], mesh)
    n = num // mesh.size
    return Shards([_map(lambda v: v.narrow(dim, r * n, n).to(dev, copy=True), x)
                   for r, dev in zip(mesh.shards, mesh.devices)], mesh)


def gather_env_axis(x: Shards, dim: int = 0) -> Any:
    """The union of the shards on the lead device: this process's shards
    concatenated along ``dim``, then, across processes, every process's
    block (``torch.distributed.all_gather``, in rank order).  Leaves that
    are not tensors come from the first shard.  One shard in one process
    is the union itself, returned without a copy."""
    mesh = x.mesh
    per_part = [tree_leaves(p) for p in x.parts]
    out = []
    for i, first in enumerate(per_part[0]):
        if not isinstance(first, torch.Tensor):
            out.append(first)
            continue
        local = (first.to(mesh.lead) if len(per_part) == 1 else
                 torch.cat([leaves[i].to(mesh.lead) for leaves in per_part], dim))
        if mesh.distributed:      # a world of one too: the collective runs
            import torch.distributed as dist
            wire = local.to(torch.uint8) if local.dtype == torch.bool else local.contiguous()
            blocks = [torch.empty_like(wire) for _ in range(mesh.world_size)]
            dist.all_gather(blocks, wire)
            local = torch.cat(blocks, dim).to(local.dtype)
        out.append(local)
    return tree_unflatten(x.parts[0], iter(out))


def _state_device(state) -> torch.device:
    return next(v.device for v in tree_leaves(state) if isinstance(v, torch.Tensor))


def shard_train_carry(mesh: Mesh, carry: Any, axis: str = 'dp') -> Any:
    """The runner's ``TrainCarry`` in the mesh's layout: env state and obs
    split along the env axis into :class:`Shards`; the agent state, the
    replay ring and the generator, which must lie on the lead device (build
    the carry there), stay whole.  A carry already sharded is gathered
    first, so a carry moves from one mesh to another."""
    if axis not in mesh.axis_names:
        raise ValueError(f'shard_train_carry: axis {axis!r} is not one of the mesh\'s '
                         f'{mesh.axis_names}')
    carry = gather_train_carry(carry)
    for what, dev in (('agent state', _state_device(carry.agent_state)),
                      ('generator', carry.gen.device)):
        if not _same_device(dev, mesh.lead):
            raise ValueError(f'shard_train_carry: the carry\'s {what} is on {dev}, the '
                             f'mesh\'s lead device is {mesh.lead}')
    return carry._replace(env_state=split_env_axis(mesh, carry.env_state),
                          obs=split_env_axis(mesh, carry.obs))


def gather_train_carry(carry: Any) -> Any:
    """The carry in the union's layout (the layout ``train_carry.npz`` is
    saved in); a carry that is not sharded is returned as it is.  Across
    processes every process must call it (an all-gather)."""
    if not isinstance(carry.obs, Shards):
        return carry
    return carry._replace(env_state=gather_env_axis(carry.env_state),
                          obs=gather_env_axis(carry.obs))


def replicate(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> tuple:
    """``tensors`` (those of the agent state a shard's rollout reads) for
    each of this process's shards: the tensors themselves on their own
    device (shards that share it share them), and on every other device
    one copy, made anew at each call without a wait on the host."""
    home = tensors[0].device
    copies = {}
    out = []
    for dev in mesh.devices:
        if _same_device(dev, home):
            out.append(tuple(tensors))
            continue
        key = (dev.type, dev.index or 0)
        if key not in copies:
            copies[key] = tuple(t.to(dev, non_blocking=True) for t in tensors)
        out.append(copies[key])
    return tuple(out)


def broadcast_agent_state(mesh: Mesh, state) -> Any:
    """Rank 0's agent state copied into this process's, tensor by tensor
    and in place (the modules' parameters are views of the flat buffers);
    nothing to do without a process group."""
    if mesh.distributed:
        import torch.distributed as dist
        for v in tree_leaves(state):
            if isinstance(v, torch.Tensor):
                dist.broadcast(v, src=0)
    return state
