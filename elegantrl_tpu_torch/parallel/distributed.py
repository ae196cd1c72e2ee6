"""Multi-process training and elastic restore (counterpart of
``elegantrl_tpu/parallel/distributed.py``).

- :func:`init_distributed`: the process group the mesh's gathers and
  broadcasts run on (``torch.distributed``: NCCL on the cards, gloo on the
  CPU); after it, :func:`~.mesh.make_mesh` spans every process's devices;
- :func:`elastic_restore`: a carry saved by ``train_agent``
  (``train_carry.npz``, in the union's layout) loaded and sharded onto a
  mesh of the devices there are now, which may be more or fewer than when
  it was written: a reshard on restore, not a live migration.
"""

from __future__ import annotations

import atexit
import datetime
from typing import Any, Dict, Optional, Sequence

import torch

from .mesh import make_mesh, shard_train_carry, world


def _init_method(address: str) -> str:
    """``host:port`` as the JAX package's coordinator address, or a URL
    (``tcp://``, ``file://``) as given."""
    return address if '://' in address else f'tcp://{address}'


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> int:
    """Join ``num_processes`` processes into one group through
    ``coordinator_address`` (``host:port``, or an init URL such as
    ``file:///path`` for a rendezvous through a file); nothing to do for
    one process unless ``backend`` is named (a world of one, the most a
    machine with one card gives NCCL).  ``backend``: ``'nccl'`` where CUDA
    is available, else ``'gloo'``.  Each process waits at most 300 s for
    the others.  The group is torn down at the interpreter's exit
    (:func:`shutdown_distributed`, registered here, as
    ``jax.distributed.initialize`` registers its shutdown).  Returns the
    global device count: the cards of a world of one (1 on the CPU), else
    one device per process."""
    size = int(num_processes or 1)
    if size > 1 or backend is not None:
        import torch.distributed as dist
        backend = backend or ('nccl' if torch.cuda.is_available() else 'gloo')
        if coordinator_address is None:
            raise ValueError('init_distributed: a group needs coordinator_address '
                             "('host:port' or 'file:///path')")
        if backend == 'nccl':
            torch.cuda.set_device(int(process_id or 0) % torch.cuda.device_count())
        dist.init_process_group(backend=backend, init_method=_init_method(coordinator_address),
                                world_size=size, rank=int(process_id or 0),
                                timeout=datetime.timedelta(seconds=300))
        atexit.register(shutdown_distributed)
    _, size = world()
    if size == 1:
        return torch.cuda.device_count() if torch.cuda.is_available() else 1
    return size


def shutdown_distributed() -> None:
    """Destroy the process group, if there is one.  A gloo group left to the
    interpreter's teardown can abort the process after its work is done
    (``terminate called without an active exception``: a transport thread
    still joinable when its owner is destroyed), so :func:`init_distributed`
    registers this to run at exit, while the interpreter still runs."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def elastic_restore(checkpoint_path: str, template_carry: Any,
                    mesh_axes: Optional[Dict[str, int]] = None,
                    devices: Optional[Sequence] = None, agent=None):
    """Load a carry saved in the union's layout (``train_carry.npz``) and
    shard it onto a mesh of ``mesh_axes`` over ``devices`` (see
    :func:`~.mesh.make_mesh`); returns ``(carry, mesh)``.  The port's carry
    needs its agent to read the agent state's leaves: ``template_carry`` is
    the ``TrainContext`` of ``build_training`` (its carry and agent), or a
    ``TrainCarry`` with ``agent=``.  The template lies on the new mesh's
    lead device; its generator takes the saved state in place."""
    from ..train.runner import TrainContext, _load_carry
    from .mesh import gather_train_carry, _state_device
    if isinstance(template_carry, TrainContext):
        agent = agent or template_carry.agent
        template_carry = template_carry.carry
    if agent is None:
        raise ValueError('elastic_restore: give the TrainContext as template_carry, or agent=')
    template = gather_train_carry(template_carry)
    carry = _load_carry(checkpoint_path, template, agent, _state_device(template.agent_state))
    mesh = make_mesh(mesh_axes, devices)
    return shard_train_carry(mesh, carry), mesh
