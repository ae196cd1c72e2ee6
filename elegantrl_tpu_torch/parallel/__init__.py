"""Mesh data parallelism, multi-process init with elastic restore, and
population training (counterpart of ``elegantrl_tpu/parallel``)."""
from .mesh import make_mesh, shard_train_carry  # noqa: F401
