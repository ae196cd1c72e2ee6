"""The seven Mosaic lowering probes (counterpart of
``scripts/probe_mosaic_ops.py``).

Each probe there is a minimal Pallas kernel that checked whether Mosaic
lowers one op the fused stock body needed (a dynamic sublane or lane slice,
a (1, N) relayout, a scalar read from VMEM, a scalar carried through a
``fori_loop``).  Here each is a small CUDA kernel (``csrc/probes.cu``) that
computes the same function, beside its plain PyTorch version:

====  ==============================  =========================================
P1    ``sublane_dynslice_value``      ``out (8, L) = sum(tab[day, :])``
P2    ``sublane_dynslice_ref``        the same, the row read from the ref
P3    ``transpose_1xN``               ``out[r, :] = x[0, r]``, ``x (1, R)``
P4    ``dynslice_then_transpose``     ``out[r, :] = tab[day, r]``
P5    ``scalar_from_vmem``            ``day = i[0, 0]``; ``out (8, L) = sum(tab[day, :])``
P6    ``lane_dynslice_ref``           ``out[r, :] = tab[r, day]``, ``tab (R, T)``
P7    ``fori_scalar_carry``           ``out[r, :] = sum_{t<8} tab[day_t, r]``,
                                      ``day_{t+1} = (day_t + 1) % T``
====  ==============================  =========================================

``tab`` is f32, ``day`` an int32 ``(1,)`` tensor and ``i`` an int32 ``(1,
L)`` one, all on the device (the kernels read the index there, as the TPU
kernels read it from SMEM or VMEM); ``L`` is the lane width, 128 in the
script.  The sums run in row order.

Each wrapper runs the plain version for CPU tensors and the kernel for CUDA
ones, raises on anything else and never falls back; ``<wrapper>.launches``
counts kernel launches.  No training path calls a probe: their entry point
is :func:`run_probes`, which ``scripts/torch_probe_ops.py`` drives.
"""

from __future__ import annotations

import ctypes

import torch

T_DEFAULT, R_DEFAULT, LANES = 64, 16, 128   # the script's T, R and B
STEPS = 8                                   # P7's fori_loop trip count
SMEM_LIMIT = 232448

# name -> (probe number, the JAX function's line in scripts/probe_mosaic_ops.py,
# its pallas_call's line)
PROBES = {
    'sublane_dynslice_value': (1, 41, 49),
    'sublane_dynslice_ref': (2, 58, 65),
    'transpose_1xN': (3, 74, 81),
    'dynslice_then_transpose': (4, 89, 98),
    'scalar_from_vmem': (5, 107, 115),
    'lane_dynslice_ref': (6, 124, 131),
    'fori_scalar_carry': (7, 140, 152),
}


# ------------------------------------------------------------ plain versions

def _row(tab: torch.Tensor, day: torch.Tensor) -> torch.Tensor:
    return tab.index_select(0, day.reshape(-1)[:1].long())[0]


def _row_sum(tab, day, lanes):
    s = torch.zeros((), dtype=tab.dtype, device=tab.device)
    row = _row(tab, day)
    for r in range(row.shape[0]):            # row order, as the kernel sums
        s = s + row[r]
    return s.expand(8, lanes).clone()


def sublane_dynslice_value_reference(tab, day, lanes: int = LANES):
    """P1: ``sum(tab[day, :])`` broadcast to ``(8, lanes)``."""
    return _row_sum(tab, day, lanes)


def sublane_dynslice_ref_reference(tab, day, lanes: int = LANES):
    """P2: the same function as P1."""
    return _row_sum(tab, day, lanes)


def transpose_1xN_reference(x, lanes: int = LANES):
    """P3: ``out[r, :] = x[0, r]``, ``(R, lanes)``."""
    return x[0][:, None].expand(x.shape[1], lanes).clone()


def dynslice_then_transpose_reference(tab, day, lanes: int = LANES):
    """P4: ``out[r, :] = tab[day, r]``, ``(R, lanes)``."""
    row = _row(tab, day)
    return row[:, None].expand(row.shape[0], lanes).clone()


def scalar_from_vmem_reference(tab, i, lanes: int = LANES):
    """P5: ``day = i[0, 0]``; ``sum(tab[day, :])`` broadcast to ``(8, lanes)``."""
    return _row_sum(tab, i, lanes)


def lane_dynslice_ref_reference(tab, day, lanes: int = LANES):
    """P6: ``tab (R, T)``; ``out[r, :] = tab[r, day]``, ``(R, lanes)``."""
    col = tab.index_select(1, day.reshape(-1)[:1].long())
    return col.expand(tab.shape[0], lanes).clone()


def fori_scalar_carry_reference(tab, lanes: int = LANES, steps: int = STEPS):
    """P7: ``out[r, :] = sum_{t<steps} tab[day_t, r]``, ``day_0 = 0``,
    ``day_{t+1} = (day_t + 1) % T``."""
    T, R = tab.shape
    acc = torch.zeros(R, dtype=tab.dtype, device=tab.device)
    day = 0
    for _ in range(steps):
        acc = acc + tab[day]
        day = (day + 1) % T
    return acc[:, None].expand(R, lanes).clone()


# ------------------------------------------------------------ wrappers

def _launch(name: str, tab, idx, out_rows: int, T: int, R: int, lanes: int,
            steps: int = 0) -> torch.Tensor:
    from ._cuda_build import check, check_tensor
    which = PROBES[name][0]
    dev = tab.device
    if tab.dtype != torch.float32 or tab.dim() != 2 or not tab.is_contiguous():
        raise ValueError(f'{name}: tab must be a contiguous 2-d float32 tensor; got '
                         f'{tab.dtype} {tuple(tab.shape)}')
    if idx is not None:
        check_tensor(name, 'index', idx, tuple(idx.shape), torch.int32, dev)
        if idx.numel() == 0:
            raise ValueError(f'{name}: the index tensor is empty')
    if which == 1 and 4 * T * R > SMEM_LIMIT:
        raise ValueError(f'{name}: a ({T}, {R}) table needs {4 * T * R} bytes of shared '
                         f'memory, more than the {SMEM_LIMIT} a Hopper block can hold')
    out = torch.empty((out_rows, lanes), dtype=torch.float32, device=dev)
    status = _library().mosaic_probe(
        which, ctypes.c_void_p(tab.data_ptr()),
        ctypes.c_void_p(0 if idx is None else idx.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        T, R, lanes, steps, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    check(status, name)
    return out


def _dispatch(name, reference, tab, *rest):
    if tab.device.type == 'cpu':
        return reference(tab, *rest)
    if tab.device.type != 'cuda':
        raise ValueError(f'{name}: unsupported device {tab.device}')
    return None


def sublane_dynslice_value(tab, day, lanes: int = LANES):
    """P1: the kernel for CUDA tensors, the plain version for CPU ones."""
    out = _dispatch('sublane_dynslice_value', sublane_dynslice_value_reference, tab, day, lanes)
    if out is None:
        out = _launch('sublane_dynslice_value', tab, day, 8, *tab.shape, lanes)
        sublane_dynslice_value.launches += 1
    return out


def sublane_dynslice_ref(tab, day, lanes: int = LANES):
    """P2."""
    out = _dispatch('sublane_dynslice_ref', sublane_dynslice_ref_reference, tab, day, lanes)
    if out is None:
        out = _launch('sublane_dynslice_ref', tab, day, 8, *tab.shape, lanes)
        sublane_dynslice_ref.launches += 1
    return out


def transpose_1xN(x, lanes: int = LANES):
    """P3 (``x`` is ``(1, R)``)."""
    out = _dispatch('transpose_1xN', transpose_1xN_reference, x, lanes)
    if out is None:
        if x.shape[0] != 1:
            raise ValueError(f'transpose_1xN: x must be (1, R); got {tuple(x.shape)}')
        out = _launch('transpose_1xN', x, None, x.shape[1], 1, x.shape[1], lanes)
        transpose_1xN.launches += 1
    return out


def dynslice_then_transpose(tab, day, lanes: int = LANES):
    """P4."""
    out = _dispatch('dynslice_then_transpose', dynslice_then_transpose_reference, tab, day,
                    lanes)
    if out is None:
        out = _launch('dynslice_then_transpose', tab, day, tab.shape[1], *tab.shape, lanes)
        dynslice_then_transpose.launches += 1
    return out


def scalar_from_vmem(tab, i, lanes: int = LANES):
    """P5 (``i`` an int32 vector whose first element is the day)."""
    out = _dispatch('scalar_from_vmem', scalar_from_vmem_reference, tab, i, lanes)
    if out is None:
        out = _launch('scalar_from_vmem', tab, i, 8, *tab.shape, lanes)
        scalar_from_vmem.launches += 1
    return out


def lane_dynslice_ref(tab, day, lanes: int = LANES):
    """P6 (``tab`` is ``(R, T)``)."""
    out = _dispatch('lane_dynslice_ref', lane_dynslice_ref_reference, tab, day, lanes)
    if out is None:
        R, T = tab.shape
        out = _launch('lane_dynslice_ref', tab, day, R, T, R, lanes)
        lane_dynslice_ref.launches += 1
    return out


def fori_scalar_carry(tab, lanes: int = LANES, steps: int = STEPS):
    """P7."""
    out = _dispatch('fori_scalar_carry', fori_scalar_carry_reference, tab, lanes, steps)
    if out is None:
        out = _launch('fori_scalar_carry', tab, None, tab.shape[1], *tab.shape, lanes, steps)
        fori_scalar_carry.launches += 1
    return out


WRAPPERS = {
    'sublane_dynslice_value': (sublane_dynslice_value, sublane_dynslice_value_reference),
    'sublane_dynslice_ref': (sublane_dynslice_ref, sublane_dynslice_ref_reference),
    'transpose_1xN': (transpose_1xN, transpose_1xN_reference),
    'dynslice_then_transpose': (dynslice_then_transpose, dynslice_then_transpose_reference),
    'scalar_from_vmem': (scalar_from_vmem, scalar_from_vmem_reference),
    'lane_dynslice_ref': (lane_dynslice_ref, lane_dynslice_ref_reference),
    'fori_scalar_carry': (fori_scalar_carry, fori_scalar_carry_reference),
}
for _fn, _ in WRAPPERS.values():
    _fn.launches = 0


# ------------------------------------------------------------ inputs, entry point

def probe_inputs(name: str, device, T: int = T_DEFAULT, R: int = R_DEFAULT,
                 gen: torch.Generator = None) -> tuple:
    """The probe's inputs: the script's (``arange`` tables, day 3, ``i`` filled
    with 5) when ``gen`` is None, else integer-valued f32 tables and an
    in-range day drawn from ``gen`` (on the CPU; exact sums in any order)."""
    f32, i32 = torch.float32, torch.int32

    def table(rows, cols):
        if gen is None:
            return torch.arange(rows * cols, dtype=f32).reshape(rows, cols).to(device)
        return torch.randint(-512, 512, (rows, cols), generator=gen).to(f32).to(device)

    def day(fixed):
        d = fixed if gen is None else int(torch.randint(0, T, (1,), generator=gen))
        return torch.tensor([d], dtype=i32, device=device)

    if name == 'transpose_1xN':
        return (table(1, R),)
    if name == 'scalar_from_vmem':
        d = day(5)
        return table(T, R), d.expand(1, LANES).contiguous()
    if name == 'lane_dynslice_ref':
        return table(R, T), day(3)
    if name == 'fori_scalar_carry':
        return (table(T, R),)
    return table(T, R), day(3)


def run_probes(device='cuda') -> dict:
    """Every probe at the script's inputs on ``device``: ``{name: out}``
    (the counterpart of the script's ``__main__``)."""
    return {name: fn(*probe_inputs(name, device)) for name, (fn, _) in WRAPPERS.items()}


def _library():
    from ._cuda_build import load
    lib = load('probes')
    if lib.mosaic_probe.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.mosaic_probe.argtypes = [i, vp, vp, vp, i, i, i, i, vp]
        lib.mosaic_probe.restype = ctypes.c_int
    return lib
