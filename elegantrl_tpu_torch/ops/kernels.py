"""The V-trace GAE recursion, the replay gather and the fused 3-layer MLP
forward (counterpart of ``elegantrl_tpu/ops/pallas_kernels.py``).

Each kernel's wrapper stands beside its plain PyTorch version:

- :func:`gae_vtrace_kernel` / :func:`vtrace_advantages_reference` (K10):
  the PPO advantage step before normalisation
  (``ops/gae.py:vtrace_advantages``): the truncation bootstrap, the reverse
  V-trace recursion of :func:`gae_vtrace_reference` and the reward sums;
- :func:`buffer_gather_fields` / :func:`buffer_gather_fields_reference`
  (K11a): the row gathers ``buf[ids0 + offset, ids1]`` of every field of the
  replay ring in one launch, optionally feature-major; :func:`buffer_gather`
  is its one-field case;
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
import functools
import math
import threading

import torch

from ..config import select_kernel
from .nets import mlp_apply_leaves

SMEM_LIMIT = 232448   # bytes of shared memory a Hopper block can hold


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


def vtrace_advantages_reference(rewards: torch.Tensor, undones: torch.Tensor,
                                unmasks: torch.Tensor, values: torch.Tensor,
                                next_value: torch.Tensor, gamma: float, lam: float):
    """K10's plain version: the truncation bootstrap
    (``ops/gae.py:apply_truncation_bootstrap``: ``r + (1 - unmask) v``,
    ``undone * unmask``), :func:`gae_vtrace_reference` on its result, and
    ``reward_sums = adv + v``; returns ``(adv, reward_sums)``."""
    rewards, undones = rewards + (1.0 - unmasks) * values, undones * unmasks
    advantages = gae_vtrace_reference(rewards, undones, values, next_value, gamma, lam)
    return advantages, advantages + values


def gae_vtrace_kernel(rewards: torch.Tensor, undones: torch.Tensor, unmasks: torch.Tensor,
                      values: torch.Tensor, next_value: torch.Tensor, gamma: float, lam: float):
    """K10 for CUDA tensors (one launch computing what
    :func:`vtrace_advantages_reference` does, bitwise), the plain version
    for CPU ones; returns ``(adv, reward_sums)``."""
    if rewards.device.type == 'cpu':
        return vtrace_advantages_reference(rewards, undones, unmasks, values, next_value,
                                           gamma, lam)
    _cuda_only('gae_vtrace_kernel', rewards)
    from ._cuda_build import check, check_tensor, ptr
    H, N = rewards.shape
    dev = rewards.device
    for name, t in (('rewards', rewards), ('undones', undones), ('unmasks', unmasks),
                    ('values', values)):
        check_tensor('gae_vtrace_kernel', name, t, (H, N), torch.float32, dev)
    check_tensor('gae_vtrace_kernel', 'next_value', next_value, (N,), torch.float32, dev)
    adv = torch.empty((H, N), dtype=torch.float32, device=dev)
    sums = torch.empty((H, N), dtype=torch.float32, device=dev)
    status = _library().gae_vtrace(
        ptr(rewards), ptr(undones), ptr(unmasks), ptr(values), ptr(next_value), ptr(adv),
        ptr(sums), H, N, ctypes.c_float(gamma), ctypes.c_float(lam), _stream(dev))
    check(status, 'gae_vtrace_kernel')
    gae_vtrace_kernel.launches += 1
    return adv, sums


gae_vtrace_kernel.launches = 0


# ------------------------------------------------------------ K11a gather

GATHER_MAX_FIELDS = 8   # fields per launch (csrc/kernels.cu)


def buffer_gather_reference(buf: torch.Tensor, ids0: torch.Tensor, ids1: torch.Tensor,
                            offset: int = 0) -> torch.Tensor:
    """``buf[ids0 + offset, ids1]``: shape ``ids.shape + buf.shape[2:]``."""
    return buf[ids0 + offset if offset else ids0, ids1]


def buffer_gather_fields_reference(fields, ids0: torch.Tensor, ids1: torch.Tensor) -> list:
    """Every field's ``buf[ids0 + offset, ids1]``, for ``fields`` a sequence
    of ``(buf, offset, feature_major)``; a feature-major field (a ``(T, N,
    dim)`` buffer) comes out ``ids.shape[:-1] + (dim, ids.shape[-1])``,
    contiguous, as the kernel writes it."""
    outs = []
    for buf, offset, feature_major in fields:
        out = buffer_gather_reference(buf, ids0, ids1, offset)
        outs.append(out.transpose(-1, -2).contiguous() if feature_major else out)
    return outs


def _gather_launch(what: str, fields, ids0: torch.Tensor, ids1: torch.Tensor) -> list:
    """One K11a launch for every field; the caller counts it."""
    from ._cuda_build import check
    dev = ids0.device
    if ids0.shape != ids1.shape or ids0.dtype != ids1.dtype \
            or ids0.dtype not in (torch.int32, torch.int64) or ids0.dim() < 1:
        raise ValueError(f'{what}: ids0 and ids1 must be int32 or int64 of one shape (at '
                         f'least 1-d); got {ids0.dtype} {tuple(ids0.shape)} and {ids1.dtype} '
                         f'{tuple(ids1.shape)}')
    if ids1.device != dev:
        raise ValueError(f'{what}: ids0 on {dev}, ids1 on {ids1.device}')
    if not 1 <= len(fields) <= GATHER_MAX_FIELDS:
        raise ValueError(f'{what}: 1 to {GATHER_MAX_FIELDS} fields per launch; got {len(fields)}')
    ids0, ids1 = ids0.contiguous(), ids1.contiguous()
    lead, Bl = ids0.shape[:-1], ids0.shape[-1]
    C = math.prod(lead)
    if C > 65535:
        raise ValueError(f'{what}: at most 65535 leading rows of ids; got {C}')
    desc, outs = [], []
    for buf, offset, feature_major in fields:
        if buf.device != dev or buf.dim() < 2 or not buf.is_contiguous():
            raise ValueError(f'{what}: each buf must be a contiguous (T, N, ...) tensor on '
                             f'{dev}; got {tuple(buf.shape)} on {buf.device}'
                             f'{"" if buf.is_contiguous() else " (not contiguous)"}')
        T, N = buf.shape[:2]
        row = buf.shape[2:]
        size = buf.element_size()
        row_bytes = math.prod(row) * size
        if feature_major:
            if buf.dim() != 3 or size != 4:
                raise ValueError(f'{what}: a feature-major field needs a (T, N, dim) buffer of '
                                 f'4-byte elements; got {buf.dtype} {tuple(buf.shape)}')
            out = torch.empty(lead + (row[0], Bl), dtype=buf.dtype, device=dev)
            unit, tps_log2 = 4, 0
            out_c, out_b, out_u = row_bytes * Bl, 4, 4 * Bl
        else:
            out = torch.empty(ids0.shape + row, dtype=buf.dtype, device=dev)
            aligned = buf.data_ptr() | out.data_ptr()
            unit = next(u for u in (16, 4, 1) if row_bytes % u == 0 and aligned % u == 0)
            tps_log2 = min(5, max(0, (row_bytes // unit - 1).bit_length()))
            out_c, out_b, out_u = row_bytes * Bl, row_bytes, unit
        desc += [buf.data_ptr(), out.data_ptr(), T, N, row_bytes, int(offset), out_c, out_b,
                 out_u, unit, tps_log2]
        outs.append(out)
    if ids0.numel() == 0:
        return outs
    lib = _library()
    status = lib.buffer_gather_fields(
        (ctypes.c_longlong * len(desc))(*desc), len(fields), ids0.data_ptr(), ids1.data_ptr(),
        C, Bl, int(ids0.dtype == torch.int64), _stream(dev))
    check(status, what)
    return outs


def buffer_gather_fields(fields, ids0: torch.Tensor, ids1: torch.Tensor) -> list:
    """K11a for CUDA tensors: every field of ``fields``, a sequence of up to
    eight ``(buf, offset, feature_major)``, gathered at the same ids in one
    launch; the plain version for CPU tensors.  ``buf (T, N, ...)`` of any
    dtype, contiguous; ``ids0``, ``ids1`` int32 or int64 of one shape,
    ``0 <= ids0 + offset < T``.  A feature-major field (``(T, N, dim)``, 4-byte
    elements) comes out ``ids.shape[:-1] + (dim, ids.shape[-1])``, the
    layout the update chunks read; the others ``ids.shape + buf.shape[2:]``."""
    if ids0.device.type == 'cpu':
        return buffer_gather_fields_reference(fields, ids0, ids1)
    _cuda_only('buffer_gather_fields', ids0)
    outs = _gather_launch('buffer_gather_fields', fields, ids0, ids1)
    buffer_gather_fields.launches += 1
    return outs


buffer_gather_fields.launches = 0


def buffer_gather(buf: torch.Tensor, ids0: torch.Tensor, ids1: torch.Tensor,
                  offset: int = 0) -> torch.Tensor:
    """K11a for one field (the counterpart of the JAX package's function):
    one launch for CUDA tensors, the plain version for CPU ones."""
    if buf.device.type == 'cpu':
        return buffer_gather_reference(buf, ids0, ids1, offset)
    _cuda_only('buffer_gather', buf)
    out, = _gather_launch('buffer_gather', [(buf, offset, False)], ids0, ids1)
    buffer_gather.launches += 1
    return out


buffer_gather.launches = 0


# ------------------------------------------------------------ K11b fused MLP3

_MLP3_ROWS, _MLP3_CLUSTERS = (64, 32, 16), (1, 2, 4, 8)   # csrc/kernels.cu


def mlp3_smem_bytes(state_dim: int, d1: int, d2: int, action_dim: int, rows: int,
                    cluster: int) -> int:
    """K11b's dynamic shared memory per block, for ``rows`` rows of x per
    cluster of ``cluster`` blocks: the block's weight slices row by row (a
    row of K inputs takes :func:`ldk` floats), the biases, x transposed (its
    space reused by the block's rows of the second hidden layer), the whole
    first hidden layer, the block's part of the output and the split-K
    scratch.  ``csrc/kernels.cu`` owns the layout (``Mlp3Layout``,
    ``fused_mlp3_smem_bytes``); this copy judges eligibility on the CPU."""
    js1, js2, ap = _r4(-(-d1 // cluster)), _r4(-(-d2 // cluster)), _r4(action_dim)
    d1c = cluster * js1
    floats = (js1 * ldk(state_dim) + js1 + js2 * ldk(d1c) + js2 + ap * ldk(js2) + ap
              + max(_r4(state_dim), js2) * rows + d1c * rows + ap * rows + 256 * 16)
    return 4 * floats


def _r4(n: int) -> int:
    return (n + 3) // 4 * 4


def ldk(k: int) -> int:
    """Floats a weight row of ``k`` inputs takes in the cluster kernels'
    shared memory (``csrc/cluster_mlp.cuh:ldk``): ``k`` rounded up to 16
    bytes, plus 16 bytes where that count of 16-byte chunks is even."""
    return _r4(k) + (4 if _r4(k) // 4 % 2 == 0 else 0)


def mlp3_fits(dims) -> bool:
    """Whether K11b takes an MLP of layer widths ``dims = (S, D1, D2, A)``:
    some layout fits a block (then the smallest, 16 rows a cluster, does, and
    every B runs)."""
    return _mlp3_fits(tuple(int(d) for d in dims))


@functools.lru_cache(maxsize=None)
def _mlp3_fits(dims: tuple) -> bool:
    return len(dims) == 4 and any(mlp3_smem_bytes(*dims, rows, c) <= SMEM_LIMIT
                                  for rows in _MLP3_ROWS for c in _MLP3_CLUSTERS)


def fused_mlp3_reference(x, w0, b0, w1, b1, w2, b2) -> torch.Tensor:
    """The ``ops/nets.py`` forward of a 3-linear MLP: ``F.linear`` layers
    with tanh-GELU between them."""
    return mlp_apply_leaves((w0, b0, w1, b1, w2, b2), x)


def fused_mlp3(x, w0, b0, w1, b1, w2, b2, layout=None) -> torch.Tensor:
    """K11b for CUDA tensors (one launch), the plain version for CPU ones.
    ``x (B, S)`` f32 with any B; ``w0 (D1, S)``, ``w1 (D2, D1)``, ``w2 (A,
    D2)`` and their biases, f32 and contiguous.  Forward only: the JAX
    package's kernel has no backward either.  ``layout = (rows, cluster)``
    sets the kernel's rows of x per cluster (64, 32, 16) and blocks per
    cluster (1, 2, 4, 8), a knob for measuring the options; by default the
    kernel picks them from B (``fused_mlp3_config``).  Called once per env
    step on the generic rollout, so the per-call host work is kept small:
    the library and the widths' fit are looked up once, and the checks read
    each tensor's attributes once."""
    if x.device.type == 'cpu':
        return fused_mlp3_reference(x, w0, b0, w1, b1, w2, b2)
    _cuda_only('fused_mlp3', x)
    B, S = x.shape
    D1, D2, A = w0.shape[0], w1.shape[0], w2.shape[0]
    dev = x.device
    tensors = (x, w0, b0, w1, b1, w2, b2)
    shapes = ((B, S), (D1, S), (D1,), (D2, D1), (D2,), (A, D2), (A,))
    for t, shape in zip(tensors, shapes):
        if t.dtype is not torch.float32 or t.device != dev or t.shape != shape \
                or not t.is_contiguous():
            from ._cuda_build import check_tensor
            for name, t_, shape_ in zip(('x', 'w0', 'b0', 'w1', 'b1', 'w2', 'b2'), tensors,
                                        shapes):
                check_tensor('fused_mlp3', name, t_, shape_, torch.float32, dev)
    if not _mlp3_fits((S, D1, D2, A)):
        raise ValueError(f'fused_mlp3: widths {(S, D1, D2, A)} need more than the '
                         f'{SMEM_LIMIT} bytes of shared memory a Hopper block can hold, '
                         'in every layout')
    out = torch.empty((B, A), dtype=torch.float32, device=dev)
    rows, cluster = layout or (0, 0)
    status = _library().fused_mlp3(*[t.data_ptr() for t in tensors], out.data_ptr(),
                                   B, S, D1, D2, A, rows, cluster, _stream(dev))
    if status:
        from ._cuda_build import check
        check(status, 'fused_mlp3')
    fused_mlp3.launches += 1
    return out


fused_mlp3.launches = 0


# ------------------------------------------------------------ library

def _cuda_only(what: str, t: torch.Tensor) -> None:
    if t.device.type != 'cuda':
        raise ValueError(f'{what}: unsupported device {t.device}')


def _stream(dev) -> int:
    """The current stream's handle, by PyTorch's internal getter where this
    build has it, which skips building a ``Stream`` object (K11b runs once
    per env step)."""
    get = getattr(torch._C, '_cuda_getCurrentRawStream', None)
    return get(dev.index) if get is not None else torch.cuda.current_stream(dev).cuda_stream


_LIB = None
_LIB_LOCK = threading.Lock()


def _library():
    """The kernels' library, built and loaded at first use; the first load
    holds a lock, since the policy server (``serve.py``) calls the wrappers
    from a thread per request."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = _load_library()
    return _LIB


def _load_library():
    from ._cuda_build import load
    lib = load('kernels')
    if lib.gae_vtrace.argtypes is None:
        vp, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.gae_vtrace.argtypes = [vp] * 7 + [i, i, f, f, vp]
        lib.buffer_gather_fields.argtypes = [ctypes.POINTER(ll), i, vp, vp, ll, ll, i, vp]
        lib.fused_mlp3.argtypes = [vp] * 8 + [i] * 7 + [vp]
        lib.fused_mlp3_smem_bytes.argtypes = [i] * 6
        lib.fused_mlp3_config.argtypes = [i] * 5
        for fn in (lib.gae_vtrace, lib.buffer_gather_fields, lib.fused_mlp3,
                   lib.fused_mlp3_smem_bytes, lib.fused_mlp3_config):
            fn.restype = ctypes.c_int
    return lib
