"""The V-trace GAE recursion, the replay gather and the fused 3-layer MLP
forward (counterpart of ``elegantrl_tpu/ops/pallas_kernels.py``).

Each kernel's wrapper stands beside its plain PyTorch version:

- :func:`gae_vtrace_kernel` / :func:`gae_vtrace_reference` (K10): the
  reverse V-trace recursion of ``ops/gae.py:gae_vtrace``;
- :func:`buffer_gather` / :func:`buffer_gather_reference` (K11a): the row
  gather ``buf[ids0 + offset, ids1]`` of the replay ring;
- :func:`fused_mlp3` / :func:`fused_mlp3_reference` (K11b): ``gelu(gelu(x
  W0^T + b0) W1^T + b1) W2^T + b2``, tanh-GELU, weights ``(out, in)`` as the
  port's ``nn.Linear`` layers keep them (the JAX package's are ``(in,
  out)``).

A wrapper runs the plain version for CPU tensors and the hand-written CUDA
kernel (``csrc/kernels.cu``) for CUDA tensors; it raises on anything else
and never falls back.  ``<wrapper>.launches`` counts the calls that launched
the kernel.  The JAX package keeps these kernels beside XLA forms of the
same functions and picks XLA from a TPU measurement; the port takes them on
a card wherever they fit (``config.py:select_kernel``).  K10 and K11a are
bitwise equal to their plain versions; K11b sums its products in another
order than cuBLAS.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..config import select_kernel
from .nets import mlp_apply_leaves

SMEM_LIMIT = 232448   # bytes of shared memory a Hopper block can hold
_BM, _KT, _JT = 32, 32, 64   # K11b's rows per block and weight tile (csrc/kernels.cu)


def select(args, flag: str, fits: bool, device, scope: str) -> bool:
    """``config.py:select_kernel`` for one of this module's switches
    (``use_gae_kernel``, ``use_gather_kernel``, ``use_mlp3_kernel``): the
    JAX package keeps these kernels beside XLA forms of the same functions,
    so the port takes its kernel wherever it fits (``fits`` is both
    predicates); the choice is printed."""
    taken = select_kernel(args, flag, fits, fits, device, scope)
    if taken:
        path = 'kernel' if torch.device(device).type == 'cuda' else 'plain version'
        print(f'| {flag}: {path} on {device} ({scope})', flush=True)
    return taken


# ------------------------------------------------------------ K10 V-trace GAE

def gae_vtrace_reference(rewards: torch.Tensor, undones: torch.Tensor, values: torch.Tensor,
                         next_value: torch.Tensor, gamma: float, lam: float) -> torch.Tensor:
    """``adv[t] = ((r[t] + m[t] next_v) - v[t]) + (m[t] lam) adv[t+1]`` with
    ``m = undone * gamma``, ``next_v`` starting at ``next_value`` and then
    ``v[t]``; time-major ``(H, N)``."""
    masks = undones * gamma
    advantages = torch.empty_like(rewards)
    next_v, adv = next_value, torch.zeros_like(next_value)
    for t in range(rewards.shape[0] - 1, -1, -1):
        adv = rewards[t] + masks[t] * next_v - values[t] + masks[t] * lam * adv
        advantages[t] = adv
        next_v = values[t]
    return advantages


def gae_vtrace_kernel(rewards: torch.Tensor, undones: torch.Tensor, values: torch.Tensor,
                      next_value: torch.Tensor, gamma: float, lam: float) -> torch.Tensor:
    """K10 for CUDA tensors (one launch), the plain version for CPU ones."""
    if rewards.device.type == 'cpu':
        return gae_vtrace_reference(rewards, undones, values, next_value, gamma, lam)
    _cuda_only('gae_vtrace_kernel', rewards)
    from ._cuda_build import check, check_tensor, ptr
    H, N = rewards.shape
    dev = rewards.device
    for name, t in (('rewards', rewards), ('undones', undones), ('values', values)):
        check_tensor('gae_vtrace_kernel', name, t, (H, N), torch.float32, dev)
    check_tensor('gae_vtrace_kernel', 'next_value', next_value, (N,), torch.float32, dev)
    adv = torch.empty((H, N), dtype=torch.float32, device=dev)
    status = _library().gae_vtrace(
        ptr(rewards), ptr(undones), ptr(values), ptr(next_value), ptr(adv), H, N,
        ctypes.c_float(gamma), ctypes.c_float(lam), _stream(dev))
    check(status, 'gae_vtrace_kernel')
    gae_vtrace_kernel.launches += 1
    return adv


gae_vtrace_kernel.launches = 0


# ------------------------------------------------------------ K11a gather

def buffer_gather_reference(buf: torch.Tensor, ids0: torch.Tensor, ids1: torch.Tensor,
                            offset: int = 0) -> torch.Tensor:
    """``buf[ids0 + offset, ids1]``: shape ``ids.shape + buf.shape[2:]``."""
    return buf[ids0 + offset if offset else ids0, ids1]


def buffer_gather(buf: torch.Tensor, ids0: torch.Tensor, ids1: torch.Tensor,
                  offset: int = 0) -> torch.Tensor:
    """K11a for CUDA tensors (one launch per call), the plain version for
    CPU ones.  ``buf (T, N, ...)`` of any dtype, contiguous; ``ids0``,
    ``ids1`` int32 or int64 of one shape, ``0 <= ids0 + offset < T``."""
    if buf.device.type == 'cpu':
        return buffer_gather_reference(buf, ids0, ids1, offset)
    _cuda_only('buffer_gather', buf)
    from ._cuda_build import check
    if buf.dim() < 2 or not buf.is_contiguous():
        raise ValueError(f'buffer_gather: buf must be a contiguous (T, N, ...) tensor; got '
                         f'{tuple(buf.shape)}{"" if buf.is_contiguous() else " (not contiguous)"}')
    if ids0.shape != ids1.shape or ids0.dtype != ids1.dtype \
            or ids0.dtype not in (torch.int32, torch.int64):
        raise ValueError(f'buffer_gather: ids0 and ids1 must be int32 or int64 of one shape; '
                         f'got {ids0.dtype} {tuple(ids0.shape)} and {ids1.dtype} '
                         f'{tuple(ids1.shape)}')
    if ids0.device != buf.device or ids1.device != buf.device:
        raise ValueError(f'buffer_gather: ids on {ids0.device}/{ids1.device}, buf on {buf.device}')
    ids0, ids1 = ids0.contiguous(), ids1.contiguous()
    T, N = buf.shape[:2]
    row = buf.shape[2:]
    out = torch.empty(ids0.shape + row, dtype=buf.dtype, device=buf.device)
    row_bytes = math.prod(row) * buf.element_size()
    word = 4 if row_bytes % 4 == 0 and buf.data_ptr() % 4 == 0 else 1
    status = _library().buffer_gather(
        ctypes.c_void_p(buf.data_ptr()), ctypes.c_void_p(ids0.data_ptr()),
        ctypes.c_void_p(ids1.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ids0.numel(), T, N, row_bytes, int(offset), word, int(ids0.dtype == torch.int64),
        _stream(buf.device))
    check(status, 'buffer_gather')
    buffer_gather.launches += 1
    return out


buffer_gather.launches = 0


# ------------------------------------------------------------ K11b fused MLP3

def mlp3_smem_bytes(state_dim: int, d1: int, d2: int) -> int:
    """K11b's dynamic shared memory per block: x and then the second hidden
    layer, the first hidden layer (32 rows each, odd leading dimensions) and
    one (32 x 64) weight tile.  ``csrc/kernels.cu`` owns the layout
    (``fused_mlp3_smem_bytes``); this copy judges eligibility on the CPU."""
    ld = lambda k: k | 1  # noqa: E731
    return 4 * (_BM * ld(max(state_dim, d2)) + _BM * ld(d1) + _KT * (_JT + 1))


def mlp3_fits(dims) -> bool:
    """Whether K11b takes an MLP of layer widths ``dims = (S, D1, D2, A)``."""
    return len(dims) == 4 and mlp3_smem_bytes(*dims[:3]) <= SMEM_LIMIT


def fused_mlp3_reference(x, w0, b0, w1, b1, w2, b2) -> torch.Tensor:
    """The ``ops/nets.py`` forward of a 3-linear MLP: ``F.linear`` layers
    with tanh-GELU between them."""
    return mlp_apply_leaves((w0, b0, w1, b1, w2, b2), x)


def fused_mlp3(x, w0, b0, w1, b1, w2, b2) -> torch.Tensor:
    """K11b for CUDA tensors (one launch), the plain version for CPU ones.
    ``x (B, S)`` f32 with any B; ``w0 (D1, S)``, ``w1 (D2, D1)``, ``w2 (A,
    D2)`` and their biases, f32 and contiguous.  Forward only: the JAX
    package's kernel has no backward either."""
    if x.device.type == 'cpu':
        return fused_mlp3_reference(x, w0, b0, w1, b1, w2, b2)
    _cuda_only('fused_mlp3', x)
    from ._cuda_build import check, check_tensor, ptr
    B, S = x.shape
    D1, D2, A = w0.shape[0], w1.shape[0], w2.shape[0]
    dev = x.device
    shapes = (('x', x, (B, S)), ('w0', w0, (D1, S)), ('b0', b0, (D1,)),
              ('w1', w1, (D2, D1)), ('b1', b1, (D2,)), ('w2', w2, (A, D2)), ('b2', b2, (A,)))
    for name, t, shape in shapes:
        check_tensor('fused_mlp3', name, t, shape, torch.float32, dev)
    smem = _library().fused_mlp3_smem_bytes(S, D1, D2)
    if smem > SMEM_LIMIT:
        raise ValueError(f'fused_mlp3: widths {(S, D1, D2)} need {smem} bytes of shared memory '
                         f'per block, more than the {SMEM_LIMIT} a Hopper block can hold')
    out = torch.empty((B, A), dtype=torch.float32, device=dev)
    status = _library().fused_mlp3(*[ptr(t) for t in (x, w0, b0, w1, b1, w2, b2, out)],
                                   B, S, D1, D2, A, _stream(dev))
    check(status, 'fused_mlp3')
    fused_mlp3.launches += 1
    return out


fused_mlp3.launches = 0


# ------------------------------------------------------------ library

def _cuda_only(what: str, t: torch.Tensor) -> None:
    if t.device.type != 'cuda':
        raise ValueError(f'{what}: unsupported device {t.device}')


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _library():
    from ._cuda_build import load
    lib = load('kernels')
    if lib.gae_vtrace.argtypes is None:
        vp, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.gae_vtrace.argtypes = [vp] * 5 + [i, i, f, f, vp]
        lib.buffer_gather.argtypes = [vp] * 4 + [ll] * 5 + [i, i, vp]
        lib.fused_mlp3.argtypes = [vp] * 8 + [i] * 5 + [vp]
        lib.fused_mlp3_smem_bytes.argtypes = [i] * 3
        for fn in (lib.gae_vtrace, lib.buffer_gather, lib.fused_mlp3, lib.fused_mlp3_smem_bytes):
            fn.restype = ctypes.c_int
    return lib
