"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  Libraries
land in ``build/kernels/`` at the repository root (an installed package:
a per-user cache directory, :func:`build_dir`), named by a hash of the
source, the ``.cu`` files it includes, the shared headers (``csrc/*.cuh``)
and the flags, so an edited
source is rebuilt and an unchanged one is reused.  Nothing here runs at import time: the first kernel launch builds
its library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / 'csrc'


def build_dir(package: Path = Path(__file__).resolve().parents[1]) -> Path:
    """Where the libraries go: ``<repo>/build/kernels`` when ``package``
    (the ``elegantrl_tpu_torch`` directory) sits in a checkout, beside the
    ``pyproject.toml`` that names it; else (an installed package) a per-user
    cache directory, ``$XDG_CACHE_HOME`` or ``~/.cache``."""
    root = package.parent
    if (root / 'pyproject.toml').is_file():
        return root / 'build' / 'kernels'
    cache = os.environ.get('XDG_CACHE_HOME') or os.path.join(os.path.expanduser('~'), '.cache')
    return Path(cache) / 'elegantrl_tpu_torch' / 'kernels'


BUILD_DIR = build_dir()
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels are built on a '
                           'machine with the CUDA toolkit')
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f'{name}.cu').read_bytes()
    src += b''.join((CSRC / f.decode()).read_bytes()
                    for f in re.findall(rb'#include "([\w.]+\.cu)"', src))
    headers = b''.join(h.read_bytes() for h in sorted(CSRC.glob('*.cuh')))
    digest = hashlib.sha256(src + headers + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f'lib{name}-{digest}.so'


def _start_build(name: str):
    """Start nvcc for ``csrc/<name>.cu``; returns (process, tmp, final) or
    None when the library is already built."""
    final = library_path(name)
    if final.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp, str(CSRC / f'{name}.cu')]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, final


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile the named sources, all nvcc processes started together.
    Returns each source's compiler output (register and shared-memory use
    from ``-Xptxas -v``); raises on a failed build."""
    started = {n: _start_build(n) for n in names}
    logs = {}
    for name, job in started.items():
        if job is None:
            logs[name] = 'cached'
            continue
        proc, tmp, final = job
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f'nvcc failed for {name}.cu:\n{out}')
        os.replace(tmp, final)
        logs[name] = out
    return logs


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launcher."""
    if status != 0:
        raise RuntimeError(f'{what}: CUDA error {status} at launch')


def check_tensor(what: str, name: str, t, shape, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: the kernels index raw pointers with these assumptions."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f'{what}: {name} must be a contiguous {dtype} tensor of shape '
                         f'{tuple(shape)} on {device}; got {t.dtype} {tuple(t.shape)} '
                         f'on {t.device}{"" if t.is_contiguous() else " (not contiguous)"}')


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer for a ``c_void_p`` argument (NULL for None)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())
