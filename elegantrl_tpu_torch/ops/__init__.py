# The plain modules, as the JAX package's ops/__init__.py; the kernel
# modules build their CUDA sources at first launch, never on import.
from . import dists, gae, nets  # noqa: F401
