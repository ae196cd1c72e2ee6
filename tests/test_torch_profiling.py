"""``elegantrl_tpu_torch/utils/profiling.py`` on the CPU: the counterparts
of ``tests/test_profiling.py`` (the JAX package's compile cache has none:
the port compiles nothing), ``mlp_flops`` against the JAX package's,
``sol_report`` on the card's entry and an unknown chip raising, and
``parse_device_trace`` on synthetic torch traces (kernels on two streams
that overlap: busy is their union) and on a real CPU-only trace (None)."""
import json
import time

import pytest
import torch

from elegantrl_tpu.utils import profiling as jprof
from elegantrl_tpu_torch.utils.profiling import (CHIP_PEAKS, ThroughputMeter, force_fetch,
                                                 mlp_flops, op_cost, parse_device_trace,
                                                 sol_report, trace)


def test_throughput_meter():
    m = ThroughputMeter()
    m.add(env_steps=1000, sgd_updates=10)
    m.add(env_steps=500)
    time.sleep(0.01)
    r = m.report()
    assert r['env_steps_per_s'] > 0
    assert abs(r['env_steps_per_s'] / r['sgd_updates_per_s'] - 150) < 1e-6


@pytest.mark.parametrize('dims,batch,backward', [((4, 8, 2), 10, False), ((4, 8, 2), 10, True),
                                                 ((3, 128, 128, 1), 4096, True)])
def test_mlp_flops_as_jax(dims, batch, backward):
    assert mlp_flops(dims, batch, backward) == jprof.mlp_flops(dims, batch, backward)


def test_sol_report_on_the_cards_entry():
    assert sorted(CHIP_PEAKS) == ['H100 SXM']
    p = CHIP_PEAKS['H100 SXM']
    assert (p['f32_tflops'], p['tf32_tflops'], p['bf16_tflops'], p['hbm_gbps']) == (
        67.0, 495.0, 989.0, 3350.0)
    assert p['card'] == 'NVIDIA H100 80GB HBM3, 700.00 W'
    r = sol_report(flops=1e12, hbm_bytes=1e9, seconds=0.1)
    assert r.peak_tflops == 67.0 and r.peak_gbps == 3350.0
    assert r.bound == 'compute' and 0 < r.compute_util < 1
    r2 = sol_report(flops=1e9, hbm_bytes=1e11, seconds=0.5, dtype='bf16')
    assert r2.bound == 'bandwidth' and r2.peak_tflops == 989.0 and 'SOL' in str(r2)
    assert sol_report(1e12, 1e9, 1.0, dtype='tf32').peak_tflops == 495.0


def test_sol_report_unknown_chip_raises():
    for chip in ('v5e', 'H100 PCIe', 'cpu'):
        with pytest.raises(KeyError, match='no peak rates'):
            sol_report(1e12, 1e9, 0.1, chip=chip)


def _write_trace(path, events):
    with open(path, 'w') as f:
        json.dump({'traceEvents': events}, f)


def test_parse_device_trace_union_over_two_streams(tmp_path):
    """Kernels on streams 7 and 13 that overlap: busy is the union of the
    intervals (a plain sum would exceed the span), busy_frac <= 1; host
    events do not count; by op and by category as summed."""
    ev = [
        {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::mm', 'pid': 1, 'tid': 1, 'ts': 0.0,
         'dur': 1000.0},
        {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel', 'pid': 1, 'tid': 1,
         'ts': 5.0, 'dur': 10.0},
        # stream 7: [100, 300) and [500, 600); stream 13: [200, 400) overlapping
        {'ph': 'X', 'cat': 'kernel', 'name': 'k_a', 'pid': 0, 'tid': 7, 'ts': 100.0,
         'dur': 200.0, 'args': {'stream': 7}},
        {'ph': 'X', 'cat': 'kernel', 'name': 'k_b', 'pid': 0, 'tid': 13, 'ts': 200.0,
         'dur': 200.0, 'args': {'stream': 13}},
        {'ph': 'X', 'cat': 'kernel', 'name': 'k_a', 'pid': 0, 'tid': 7, 'ts': 500.0,
         'dur': 100.0, 'args': {'stream': 7}},
        # a copy inside the kernels' union, a set after a gap
        {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'Memcpy HtoD', 'pid': 0, 'tid': 7,
         'ts': 250.0, 'dur': 50.0, 'args': {'bytes': 4096}},
        {'ph': 'X', 'cat': 'gpu_memset', 'name': 'Memset (Device)', 'pid': 0, 'tid': 7,
         'ts': 900.0, 'dur': 100.0, 'args': {'bytes': 1024}},
    ]
    _write_trace(tmp_path / 'a.pt.trace.json', ev)
    agg = parse_device_trace(str(tmp_path))
    # union: [100, 400) + [500, 600) + [900, 1000) = 500 us over the span 100..1000
    assert abs(agg['busy_s'] - 500e-6) < 1e-12
    assert abs(agg['span_s'] - 900e-6) < 1e-12
    assert abs(agg['busy_frac'] - 500 / 900) < 1e-12 and agg['busy_frac'] <= 1.0
    # the plain sum of the device events (650 us) is not what busy counts
    assert sum(agg['seconds_by_category'].values()) == pytest.approx(650e-6)
    assert agg['seconds_by_category'] == pytest.approx({'kernel': 500e-6, 'memcpy': 50e-6,
                                                        'memset': 100e-6})
    assert agg['seconds_by_op']['k_a'] == pytest.approx(300e-6)
    assert agg['count_by_op'] == {'k_a': 2, 'k_b': 1, 'Memcpy HtoD': 1, 'Memset (Device)': 1}
    assert agg['bytes'] == 5120.0 and agg['flops'] is None


def test_parse_device_trace_fully_overlapped_streams_stay_at_one(tmp_path):
    ev = [{'ph': 'X', 'cat': 'kernel', 'name': f'k{s}', 'pid': 0, 'tid': s, 'ts': 10.0,
           'dur': 90.0} for s in (7, 13, 21)]
    _write_trace(tmp_path / 'b.pt.trace.json', ev)
    agg = parse_device_trace(str(tmp_path))
    assert agg['busy_frac'] == 1.0 and agg['busy_s'] == pytest.approx(90e-6)


def test_cpu_only_trace_gives_none(tmp_path):
    """A real ``trace`` of CPU work: its file is written, and holds no
    device event, so the reader returns None (as the JAX reader does when
    no device time is traced); an empty directory gives None too."""
    assert parse_device_trace(str(tmp_path)) is None
    with trace(str(tmp_path / 'tb')) as prof:
        a = torch.randn(32, 32)
        force_fetch({'a': a @ a})
    assert prof is not None
    assert len(list((tmp_path / 'tb').glob('*.pt.trace.json'))) == 1
    assert parse_device_trace(str(tmp_path / 'tb')) is None


def test_force_fetch_and_op_cost():
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert force_fetch([x, torch.ones(2)]) == 15.0 and force_fetch({}) == 0.0
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    assert op_cost(torch.matmul, a, b) == {'flops': 2.0 * 8 * 16 * 4, 'bytes': None}
    assert op_cost(torch.add, a, 1.0) == {'flops': None, 'bytes': None}

    def fails(x):
        raise RuntimeError('no')
    assert op_cost(fails, a) is None
