"""Tracing, throughput and speed-of-light accounting (counterpart of
``elegantrl_tpu/utils/profiling.py``).

- :func:`trace` — context manager around ``torch.profiler`` (CPU and, where
  the build has it, CUDA activities) writing a Chrome trace under
  ``log_dir``; :func:`parse_device_trace` reads it back into device totals;
- :func:`force_fetch` — synchronise the device a tree lives on;
- :class:`ThroughputMeter` — env-steps/s and SGD-updates/s accounting;
- :func:`sol_report` — speed-of-light utilisation against the card's
  published peaks (:data:`CHIP_PEAKS`);
- :func:`op_cost` — the FLOPs of a call as ``FlopCounterMode`` counts them
  (the JAX package's ``xla_cost`` reads XLA's cost model instead).
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

from .checkpoint import tree_leaves

# Published dense peaks of the card the port runs on, per card (NVIDIA's
# H100 SXM data sheet; the rates hold at the 700 W limit, and a card set
# below it runs slower under load): FP32 on the CUDA cores, TF32 and bf16 on
# the tensor cores, TFLOP/s; HBM3, GB/s.
CHIP_PEAKS = {
    'H100 SXM': {'f32_tflops': 67.0, 'tf32_tflops': 495.0, 'bf16_tflops': 989.0,
                 'hbm_gbps': 3350.0, 'card': 'NVIDIA H100 80GB HBM3, 700.00 W'},
}

# the trace's device-side event categories (kineto's Chrome trace)
_DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')


def _activities():
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if ProfilerActivity.CUDA in torch.profiler.supported_activities() \
            and torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str, **profile_kwargs):
    """``with trace(log_dir) as prof: ...`` profiles the block with
    ``torch.profiler`` (CPU and CUDA activities; ``profile_kwargs`` pass
    through, e.g. ``with_flops=True``) and writes its Chrome trace to
    ``log_dir/trace_<ns>_<pid>.pt.trace.json`` (loadable in Perfetto or
    ``chrome://tracing``), synchronising the card first so its kernels are
    in the trace."""
    from torch.profiler import profile
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities(), **profile_kwargs) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f'trace_{time.time_ns():020d}_{os.getpid()}.pt.trace.json'))


def force_fetch(tree) -> float:
    """Wait for everything the first tensor leaf of ``tree`` depends on
    (a synchronise of its device) and return its sum as a float."""
    leaves = [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]
    if not leaves:
        return 0.0
    x = leaves[0]
    if x.device.type == 'cuda':
        torch.cuda.synchronize(x.device)
    return float(torch.sum(x.detach().to(torch.float32)))


class ThroughputMeter:
    def __init__(self):
        self.t0 = time.perf_counter()
        self.steps = 0
        self.updates = 0

    def add(self, env_steps: int, sgd_updates: int = 0):
        self.steps += env_steps
        self.updates += sgd_updates

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def report(self) -> Dict[str, float]:
        dt = max(self.elapsed, 1e-9)
        return {'env_steps_per_s': self.steps / dt,
                'sgd_updates_per_s': self.updates / dt,
                'elapsed_s': dt}


def mlp_flops(dims: Sequence[int], batch: int, with_backward: bool = False) -> float:
    """2*B*sum(in*out) forward; x3 for backward."""
    fwd = 2.0 * batch * sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    return fwd * (3.0 if with_backward else 1.0)


@dataclass
class SolReport:
    achieved_tflops: float
    peak_tflops: float
    compute_util: float
    achieved_gbps: float
    peak_gbps: float
    bandwidth_util: float
    bound: str

    def __str__(self):
        return (f"SOL: {self.compute_util*100:.1f}% compute "
                f"({self.achieved_tflops:.2f}/{self.peak_tflops:.0f} TFLOP/s), "
                f"{self.bandwidth_util*100:.1f}% HBM "
                f"({self.achieved_gbps:.1f}/{self.peak_gbps:.0f} GB/s) "
                f"-> {self.bound}-bound")


def op_cost(fn, *args, **kwargs) -> Optional[Dict[str, Optional[float]]]:
    """The FLOPs of ``fn(*args, **kwargs)`` as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them (the products,
    convolutions and attention it has formulas for; elementwise work is not
    counted).  Returns ``{'flops', 'bytes'}`` with None for what it cannot
    count (``bytes`` always; ``flops`` where it counted nothing), or None
    where the call fails under the counter."""
    from torch.utils.flop_counter import FlopCounterMode
    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args, **kwargs)
    except Exception:
        return None
    flops = counter.get_total_flops()
    return {'flops': float(flops) if flops else None, 'bytes': None}


def _union_us(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def parse_device_trace(log_dir: str) -> Optional[Dict[str, object]]:
    """Aggregate the newest ``torch.profiler`` Chrome trace under ``log_dir``
    (``*.pt.trace.json``, or ``.json.gz``) into device-side totals, with
    the JAX package's keys:

    - ``busy_s``: the union of the device's kernel, memcpy and memset
      intervals (kernels on several streams overlap, so their plain sum
      could exceed the span);
    - ``span_s``: first device event's start to last one's end;
      ``busy_frac = busy_s / span_s``, at most 1 by construction;
    - ``seconds_by_op`` and ``count_by_op`` by kernel (or copy) name;
      ``seconds_by_category`` split into kernel, memcpy and memset (plain
      sums, so they may exceed ``busy_s`` where streams overlap);
    - ``bytes``: the bytes of the copies and sets that carry a count, and
      ``flops``: the FLOPs of the ops recorded ``with_flops``; each None
      where the trace holds none (never an estimate).

    Returns None when there is no trace or it holds no device events."""
    paths = glob.glob(os.path.join(log_dir, '**', '*.pt.trace.json'), recursive=True)
    paths += glob.glob(os.path.join(log_dir, '**', '*.pt.trace.json.gz'), recursive=True)
    if not paths:
        return None
    path = max(paths, key=os.path.getmtime)
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rt') as f:
        data = json.load(f)
    events = data['traceEvents'] if isinstance(data, dict) else data
    intervals = []
    by_cat = collections.defaultdict(float)
    by_op = collections.defaultdict(float)
    op_count = collections.defaultdict(int)
    nbytes = flops = None
    for e in events:
        if e.get('ph') != 'X':
            continue
        args = e.get('args') or {}
        if 'flops' in args:
            flops = (flops or 0.0) + float(args['flops'])
        cat = e.get('cat')
        if cat not in _DEVICE_CATEGORIES:
            continue
        ts, dur = float(e.get('ts', 0.0)), float(e.get('dur', 0.0))
        intervals.append((ts, ts + dur))
        by_cat[cat.replace('gpu_', '')] += dur * 1e-6
        name = e.get('name', '?')
        by_op[name] += dur * 1e-6
        op_count[name] += 1
        if cat != 'kernel' and 'bytes' in args:
            nbytes = (nbytes or 0.0) + float(args['bytes'])
    if not intervals:
        return None
    busy_us = _union_us(intervals)
    span_us = max(e for _, e in intervals) - min(s for s, _ in intervals)
    top_ops = dict(sorted(by_op.items(), key=lambda kv: -kv[1]))
    return {'busy_s': busy_us * 1e-6, 'bytes': nbytes, 'flops': flops,
            'span_s': span_us * 1e-6,
            'busy_frac': busy_us / span_us if span_us > 0 else None,
            'seconds_by_category': dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
            'seconds_by_op': top_ops,
            'count_by_op': {k: op_count[k] for k in top_ops}}


def sol_report(flops: float, hbm_bytes: float, seconds: float, chip: str = 'H100 SXM',
               dtype: str = 'f32') -> SolReport:
    """The share of ``chip``'s peak (:data:`CHIP_PEAKS`; ``dtype`` 'f32',
    'tf32' or 'bf16') that ``flops`` and ``hbm_bytes`` in ``seconds``
    reach.  A chip with no entry raises: its bounds would be wrong."""
    if chip not in CHIP_PEAKS:
        raise KeyError(f'sol_report: no peak rates for chip {chip!r}; '
                       f'CHIP_PEAKS has {sorted(CHIP_PEAKS)}')
    peaks = CHIP_PEAKS[chip]
    peak_tf = peaks[f'{dtype}_tflops']
    peak_bw = peaks['hbm_gbps']
    a_tf = flops / seconds / 1e12
    a_bw = hbm_bytes / seconds / 1e9
    cu, bu = a_tf / peak_tf, a_bw / peak_bw
    return SolReport(a_tf, peak_tf, cu, a_bw, peak_bw, bu,
                     'compute' if cu >= bu else 'bandwidth')
