"""Measure the layouts of the thread-block-cluster kernels on one CUDA card:
K11b, the fused MLP3 forward (``ops/csrc/kernels.cu``), K4's stock actor
kernel, K1/K3, the on-policy rollout, and K6/K6′, the off-policy rollout
(``ops/csrc/fused_rollout.cu``).

    python3 scripts/torch_cluster_kernels.py [--phases] [--push-obs]

K11b: at (8, 128, 128, 2) and (8, 256, 256, 4), B = 64, 1000, 4096 and
16,384, every layout that fits (rows of x per cluster 64, 32, 16 x blocks
per cluster 1, 2, 4, 8, through ``fused_mlp3(..., layout=)``): device ms a
call from the profiler over 20 calls (null where the trace came back
without device events), whether it agrees with the plain
version within 1e-5 of its largest output, and the layout the kernel picks
by itself.  K4: the stock rollout (the actor kernel and the critic pass,
Philox noise, H = 128) at 256 and 4096 envs for each cluster size
(``rollout(..., stock_cluster=)``), ms by CUDA events over 5 rollouts, and
the size the kernel picks.  K1/K3: the rollout of every on-policy body
(Philox noise, H = 64, (128, 128)) at 4096, 1024 and 256 envs for each
cluster size that fits (``rollout(..., cluster=)``), ms by CUDA events over
5 rollouts and the size the kernel picks.  K6/K6′: HopperSlip's ddpg and
sac heads and CartPole's dqn head (Philox noise, (128, 128)) at path B's 64
envs x 64 steps, the off-policy ``train_agent`` runs' 128 x 32 and paths A
and C's 1024 x 32 for each cluster size that fits
(``offpolicy_rollout(..., cluster=)``), likewise.  One JSON line per case.

``--push-obs`` also measures K1/K3's other env-step option beside each
cluster size of 2 or more: rank 0 of a cluster alone runs the heads, the
draws and the env step, pushes the next obs tile into every block and a
third cluster barrier follows (the kernel's own design has every block run
the env step from bitwise-equal inputs).  It writes that variant of
``fused_rollout.cu`` into ``build/push_obs/`` (text anchors, as
``--phases``), builds it and reports its ms and whether its outputs equal
the kernel's bitwise.

``--phases`` also times each phase of the kernels: it writes copies of the
two sources with clock64 stamps of block 0's thread 0 between the phases
into ``build/phases/``, builds them with the flags of ``ops/_cuda_build.py``
and runs the same cases on them, printing µs per phase (a call for K11b,
a step for K4, K1/K3 and K6/K6′) at the card's maximum SM clock.  The stamps sit at text
anchors of the sources; a change to those lines needs the anchors here
updated (the script stops with the anchor it did not find).
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

K11B_DIMS = ((8, 128, 128, 2), (8, 256, 256, 4))
K11B_B = (64, 1000, 4096, 16384)
K4_ENVS = (256, 4096)
K11B_PHASES = ['weights_and_x', 'layer0_push', 'cluster_sync', 'w1_wait', 'layer1',
               'layer2_push', 'cluster_sync2', 'output']
K4_PHASES = ['wait_prepare', 'market_obs_normals', 'layer1_push', 'cluster_sync', 'unused',
             'layer2', 'head_push', 'cluster_sync2', 'mean_action', 'env_step']
K1_ENVS = (4096, 1024, 256)
K1_PHASES = ['top_sync', 'layer1_push', 'head_noise', 'cluster_sync', 'layer2', 'heads_push',
             'cluster_sync2', 'head_sums', 'env_step']
K1_TRACE = 16   # K1/K3's slots of g_trace (K4 takes 0-9)
K6_CASES = (('HopperSlip-v0', 'ddpg'), ('HopperSlip-v0', 'sac'), ('CartPole-v1', 'dqn'))
K6_SHAPES = ((64, 64), (128, 32), (1024, 32))
K6_PHASES = ['top_sync', 'layer1_push', 'head_noise', 'cluster_sync', 'layer2', 'heads_push',
             'cluster_sync2', 'head_sums', 'env_step']
K6_TRACE = 32   # K6/K6′'s slots of g_trace
TRACE_SLOTS = 48

STAMP = '''
__device__ unsigned long long g_trace[48];
#define STAMP(i) do { if (threadIdx.x == 0 && blockIdx.x == 0) { \\
  const unsigned long long now_ = clock64(); tr_acc[i] += now_ - tr_last; tr_last = now_; } } while (0)
'''
TRACE_IO = '''
extern "C" int trace_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
}
extern "C" int trace_reset() {
  unsigned long long z[48] = {0};
  return (int)cudaMemcpyToSymbol(g_trace, z, sizeof(z));
}
'''


def _insert(src, anchor, before='', after=''):
    """``src`` with ``before`` and ``after`` around its one ``anchor``."""
    if src.count(anchor) != 1:
        raise SystemExit(f'torch_cluster_kernels: anchor not found once: {anchor!r}')
    return src.replace(anchor, before + anchor + after)


def _replace(src, old, new):
    """``src`` with its one ``old`` replaced by ``new``."""
    if src.count(old) != 1:
        raise SystemExit(f'torch_cluster_kernels: anchor not found once: {old!r}')
    return src.replace(old, new)


def push_obs_source(src_dir, out_dir):
    """Write the variant of ``src_dir``'s fused_rollout.cu whose K1/K3 runs
    the heads, the draws and the env step on rank 0 alone and pushes the obs
    tile (from the stamped copy under ``--phases``, so both carry stamps)."""
    s = open(os.path.join(src_dir, 'fused_rollout.cu')).read()
    s = _insert(s, '  const int AP = Ly.ap, R = Ly.ap + 4;  // rows of a rank\'s part: AP actor '
                   'rows, the value\n',
                after='  const bool env_block = rank == 0;  // runs the heads and the env step\n')
    s = _replace(s, '      xn[s * TE + e] = v;\n',
                 '      for (int q = 0; q < c; ++q) *cluster.map_shared_rank(xn + s * TE + e, q) = v;\n')
    wait = ('  cm::cp_async_wait<0>();\n  cm::cluster_wait();  // every block has started: '
            'h1 rows and head parts may be pushed\n')
    s = _replace(s, '  if (w0 && H > 0) observe(0);\n  if (H > 0) prepare(0, 0);\n' + wait,
                 '  if (env_block && H > 0) prepare(0, 0);\n' + wait
                 + '  if (env_block && w0 && H > 0) observe(0);\n  sync_group();\n')
    s = _replace(s, '    for (int i = threadIdx.x; i < A * TE; i += cm::THREADS) {\n'
                    '      const int a = i / TE, e2 = i % TE;\n      float z;',
                 '    for (int i = threadIdx.x; env_block && i < A * TE; i += cm::THREADS) {\n'
                 '      const int a = i / TE, e2 = i % TE;\n      float z;')
    s = _replace(s, '    for (int i = threadIdx.x; i < (A + 1) * TE; i += cm::THREADS) {\n'
                    '      const int a = i / TE, row = a < A ? a : AP',
                 '    for (int i = threadIdx.x; env_block && i < (A + 1) * TE; i += cm::THREADS) {\n'
                 '      const int a = i / TE, row = a < A ? a : AP')
    s = _replace(s, '    if (w0) {\n      if (live) {\n        const float* ue',
                 '    if (w0 && env_block) {\n      if (live) {\n        const float* ue')
    s = _replace(s, '    } else if (t + 1 < H) {\n      prepare(t + 1, TE);  // the other warps, '
                    'meanwhile\n    }\n',
                 '    } else if (t + 1 < H && env_block) {\n      prepare(t + 1, TE);  // the '
                 'other warps, meanwhile\n    }\n    sync_group();  // the next obs tile, in '
                 'every block\n')
    os.makedirs(out_dir, exist_ok=True)
    open(os.path.join(out_dir, 'fused_rollout.cu'), 'w').write(s)


def instrumented_sources(out_dir):
    """Write the stamped copies of kernels.cu and fused_rollout.cu."""
    csrc = os.path.join(ROOT, 'elegantrl_tpu_torch', 'ops', 'csrc')
    s = open(os.path.join(csrc, 'kernels.cu')).read()
    s = _insert(s, '#include "mlp_grad.cuh"\n', after=STAMP)
    s = _insert(s, '  cm::cluster_arrive();  // this block has started\n',
                after='  unsigned long long tr_acc[12] = {0}, tr_last = clock64();\n')
    s = _insert(s, '  cm::tile_dense<RM>(w0t', before='  STAMP(0);\n')
    s = _insert(s, '  cluster.sync();  // every block\'s rows of h0, in every block\n',
                before='  STAMP(1);\n', after='  STAMP(2);\n')
    s = _insert(s, '  cm::tile_dense<RM>(w1t', before='  STAMP(3);\n')
    s = _insert(s, '  // this block\'s part of the output, pushed', before='  STAMP(4);\n')
    s = _insert(s, '  cluster.sync();  // every block\'s parts of this block\'s rows\n',
                before='  STAMP(5);\n', after='  STAMP(6);\n')
    s = _insert(s, '    out[(size_t)(m0 + r * per + ml) * A + a] = v + b2s[a];\n  }\n',
                after='  STAMP(7);\n  if (threadIdx.x == 0 && blockIdx.x == 0)\n'
                      '    for (int i = 0; i < 8; ++i) atomicAdd(&g_trace[i], tr_acc[i]);\n')
    open(os.path.join(out_dir, 'kernels.cu'), 'w').write(s + TRACE_IO)

    s = open(os.path.join(csrc, 'fused_rollout.cu')).read()
    s = _insert(s, '#include "cluster_mlp.cuh"\n', after=STAMP)
    s = _insert(s, '  cm::cluster_wait();  // every block has started: h1 and the parts may be pushed\n',
                after='  unsigned long long tr_acc[12] = {0}, tr_last = clock64();\n')
    s = _insert(s, '    // W1\'s market columns times the day\'s rows: 8 threads a row, each two\n',
                before='    STAMP(0);\n')
    s = _insert(s, '    cm::tile_dense<TE>(w1l', before='    STAMP(1);\n')
    s = _insert(s, '    cluster.sync();  // every block\'s rows of h1, in every block\n',
                before='    STAMP(2);\n', after='    STAMP(3);\n')
    s = _insert(s, '    cm::tile_dense<TE>(wos', before='    STAMP(5);\n')
    s = _insert(s, '    cluster.sync();  // every block\'s part of the head rows, in every block\n',
                before='    STAMP(6);\n', after='    STAMP(7);\n')
    s = _insert(s, '    day = day + 1 >= body.p.T - 1 ? 0 : day + 1;\n', before='    STAMP(8);\n')
    s = _insert(s, '    if (t + 1 < H) prepare(t + 1, day, TE);  // the other warps, meanwhile\n',
                before='    STAMP(9);\n')
    s = _insert(s, '  if (live && rank == 0) {\n#pragma unroll\n    for (int k = 0; k < F; ++k) env_f_o',
                before='  if (threadIdx.x == 0 && blockIdx.x == 0)\n'
                       '    for (int i = 0; i < 10; ++i) g_trace[i] += tr_acc[i];\n')
    # K1/K3, fused_rollout_kernel<Body>: its stamps go to g_trace[K1_TRACE + i]
    s = _insert(s, '  cm::cluster_wait();  // every block has started: h1 rows and head '
                   'parts may be pushed\n',
                after='  unsigned long long tr_acc[12] = {0}, tr_last = clock64();\n')
    s = _insert(s, '    __syncthreads();  // step t\'s obs tile and noise words; the weights '
                   'at t = 0\n', after='    STAMP(0);\n')
    s = _insert(s, '    // the head\'s noise: the Gaussian\'s normals, or the categorical\'s '
                   'Gumbel\n',
                before='    STAMP(1);\n')
    s = _insert(s, '    sync_group();  // h1: every block\'s rows, in every block\n',
                before='    STAMP(2);\n', after='    STAMP(3);\n')
    s = _insert(s, '    cm::tile_dense<TE>(woa', before='    STAMP(4);\n')
    s = _insert(s, '    sync_group();  // every block\'s parts of the heads, in every block\n',
                before='    STAMP(5);\n', after='    STAMP(6);\n')
    s = _insert(s, '    if (w0) {\n      if (live) {\n        const float* ue',
                before='    STAMP(7);\n')
    s = _insert(s, '      if (t + 1 < H) observe(t + 1);\n', after='      STAMP(8);\n')
    s = _insert(s, '  if (rank == 0 && live) {\n#pragma unroll\n'
                   '    for (int k = 0; k < F; ++k) env_f_o',
                before='  if (threadIdx.x == 0 && blockIdx.x == 0)\n'
                       f'    for (int i = 0; i < 9; ++i) g_trace[{K1_TRACE} + i] += tr_acc[i];\n')
    # K6/K6′, offpolicy_rollout_kernel<Body, HEAD>: g_trace[K6_TRACE + i]
    s = _insert(s, '  cm::cluster_wait();  // every block has started: h1 and head-row parts may '
                   'be pushed\n',
                after='  unsigned long long tr_acc[12] = {0}, tr_last = clock64();\n')
    s = _insert(s, '    __syncthreads();  // step t\'s obs and noise words (the weights at t = 0)\n',
                after='    STAMP(0);\n')
    s = _insert(s, '    const float* hr = sm + Ly.hraw + (t & 1) * Ly.nh4 * G;\n',
                before='    STAMP(1);\n')
    s = _insert(s, '    sync_group();  // every block\'s rows of h1, in every block\n',
                before='    STAMP(2);\n', after='    STAMP(3);\n')
    s = _insert(s, '    // ---- this block\'s part of the head rows\n', before='    STAMP(4);\n')
    s = _insert(s, '    sync_group();  // every block\'s parts of the head rows, in every block\n',
                before='    STAMP(5);\n', after='    STAMP(6);\n')
    s = _insert(s, '    if (w0) {\n      if (live) {  // the head\'s action and the env step\n',
                before='    STAMP(7);\n')
    s = _insert(s, '      if (t + 1 < H) observe(t + 1);  // the next obs tile\n',
                after='      STAMP(8);\n')
    s = _insert(s, '  if (rank == 0 && live) {  // the final env rows\n',
                before='  if (threadIdx.x == 0 && blockIdx.x == 0)\n'
                       f'    for (int i = 0; i < 9; ++i) g_trace[{K6_TRACE} + i] += tr_acc[i];\n')
    open(os.path.join(out_dir, 'fused_rollout.cu'), 'w').write(s + TRACE_IO)


def build_copies(copies):
    """Build the written copies, ``{(dir, name): ...}``, all at once with the
    flags of ``ops/_cuda_build.py``; returns the loaded libraries by key."""
    from elegantrl_tpu_torch.ops import _cuda_build
    csrc = os.path.join(ROOT, 'elegantrl_tpu_torch', 'ops', 'csrc')
    flags = [f for f in _cuda_build.NVCC_FLAGS if f not in ('-Xptxas', '-v')]
    procs = {(d, n): subprocess.Popen([_cuda_build._nvcc(), *flags, '-I', csrc, '-o',
                                       os.path.join(d, f'lib{n}.so'), os.path.join(d, f'{n}.cu')],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for d, n in copies}
    libs = {}
    for (d, n), p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f'nvcc failed for {os.path.join(d, n)}.cu:\n{log}')
        libs[(d, n)] = ctypes.CDLL(os.path.join(d, f'lib{n}.so'))
    return libs


ROLLOUT_LIBRARIES = ('onpolicy_rollout', 'offpolicy_rollout')   # fused_rollout.cu's halves


def with_library(lib, fn):
    """``fn()`` with the wrappers loading ``lib`` (a whole ``fused_rollout``
    library) for both halves of the rollout kernels' library."""
    from elegantrl_tpu_torch.ops import _cuda_build
    load, build = _cuda_build.load, _cuda_build.build
    _cuda_build.load = lambda name: lib if name in ROLLOUT_LIBRARIES else load(name)
    _cuda_build.build = lambda names: {n: 'patched' for n in names}
    try:
        return fn()
    finally:
        _cuda_build.load, _cuda_build.build = load, build


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--phases', action='store_true')
    parser.add_argument('--push-obs', action='store_true')
    opts = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('torch_cluster_kernels: this needs a CUDA card')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit,clocks.max.sm',
                          '--format=csv,noheader,nounits'], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    mhz = float(smi.split(',')[-1])
    src = os.path.join(ROOT, 'elegantrl_tpu_torch', 'ops', 'csrc')
    stamped = os.path.join(ROOT, 'build', 'phases')
    pushed = os.path.join(ROOT, 'build', 'push_obs')
    copies = []
    if opts.phases:
        os.makedirs(stamped, exist_ok=True)
        instrumented_sources(stamped)
        copies += [(stamped, 'kernels'), (stamped, 'fused_rollout')]
        src = stamped
    if opts.push_obs:
        push_obs_source(src, pushed)
        copies.append((pushed, 'fused_rollout'))
    built = build_copies(copies)
    libs = push_lib = None
    if opts.phases:   # the wrappers load the stamped copies
        from elegantrl_tpu_torch.ops import _cuda_build
        libs = {n: built[(stamped, n)] for n in ('kernels', 'fused_rollout')}
        _cuda_build.load = lambda name: libs['fused_rollout' if name in ROLLOUT_LIBRARIES
                                             else name]
        _cuda_build.build = lambda names: {n: 'patched' for n in names}
    if opts.push_obs:
        push_lib = built[(pushed, 'fused_rollout')]
    from torch.profiler import ProfilerActivity, profile
    from elegantrl_tpu_torch import Config
    from elegantrl_tpu_torch.agents.ppo import make_ppo
    from elegantrl_tpu_torch.envs import StockTradingVecEnv
    from elegantrl_tpu_torch.ops import fused_rollout as fr, kernels as kn
    from elegantrl_tpu_torch.ops.nets import mlp_init
    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False

    def phases(lib, names, calls, first=0):
        buf = (ctypes.c_ulonglong * TRACE_SLOTS)()
        lib.trace_read(buf)
        return {k: v / calls / mhz for k, v in zip(names, buf[first:])}

    def reset(lib):
        if lib is not None:
            lib.trace_reset()

    def device_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and 'fused_mlp3' in e.name)
        return us / 1e3 / reps if us > 0 else None   # None: the trace came back empty

    def events_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    for dims in K11B_DIMS:
        for B in K11B_B:
            g = torch.Generator(device=dev).manual_seed(B)
            leaves = [p.detach().to(dev).contiguous() for p in
                      mlp_init(torch.Generator().manual_seed(B), dims, out_std=0.1).leaves()]
            x = torch.randn((B, dims[0]), generator=g, device=dev)
            want = kn.fused_mlp3_reference(x, *leaves)
            tol = 1e-5 * float(want.abs().max())
            layouts = {}
            for rows in (64, 32, 16):
                for c in (1, 2, 4, 8):
                    if kn.mlp3_smem_bytes(*dims, rows, c) > kn.SMEM_LIMIT:
                        continue
                    def fn(rows=rows, c=c):
                        return kn.fused_mlp3(x, *leaves, layout=(rows, c))
                    ok = float((fn() - want).abs().max()) <= tol
                    reset(libs and libs['kernels'])
                    entry = dict(device_ms=device_ms(fn, 20), agrees=ok)
                    if libs:
                        entry['phases_us'] = phases(libs['kernels'], K11B_PHASES, 21)
                    layouts[f'{rows}x{c}'] = entry
            auto = kn._library().fused_mlp3_config(B, *dims)
            print(json.dumps(dict(kernel='fused_mlp3', dims=dims, B=B,
                                  picked=f'{auto // 16}x{auto % 16}', layouts=layouts)),
                  flush=True)

    env_def = StockTradingVecEnv(num_envs=1)._def
    body = env_def.kernel_body
    S, A = body.state_dim, body.action_dim
    st = make_ppo((128, 128), S, A, Config()).init(0, dev)
    g = torch.Generator(device=dev).manual_seed(41)
    st = st._replace(norm_avg=torch.rand(S, generator=g, device=dev) * 0.4 - 0.2,
                     norm_std=torch.rand(S, generator=g, device=dev) + 0.7)
    net = (st.act_flat, st.cri_flat, st.norm_avg, st.norm_std)
    seed = torch.tensor([20260, -77], dtype=torch.int32, device=dev)
    for n in K4_ENVS:
        f0, _ = body.pack(env_def.init(g, n, dev))
        f0 = f0.contiguous()
        i0 = torch.zeros((1, n), dtype=torch.int32, device=dev)
        sizes = {}
        for c in (1, 2, 4, 8):
            def fn(c=c):
                return fr.rollout(*net, f0, i0, net_dims=(128, 128), horizon_len=128,
                                  reward_scale=1.0, body=body, seed=seed, stock_cluster=c)
            entry = dict(ms=events_ms(fn, 5))
            if libs:
                reset(libs['fused_rollout'])
                fn()
                torch.cuda.synchronize()
                entry['phases_us_per_step'] = phases(libs['fused_rollout'], K4_PHASES, 128)
            sizes[str(c)] = entry
        print(json.dumps(dict(kernel='stock_rollout', envs=n, horizon=128,
                              ms_covers='the actor kernel and the critic pass',
                              picked=fr._library().stock_rollout_cluster(n, 128, 128, 0, 0),
                              cluster_sizes=sizes)), flush=True)
    for body in fr.KERNEL_ENV_BODIES.values():
        S, A = body.state_dim, body.action_dim
        st = make_ppo((128, 128), S, A, Config(), discrete=body.discrete).init(0, dev)
        g = torch.Generator(device=dev).manual_seed(41)
        st = st._replace(norm_avg=torch.rand(S, generator=g, device=dev) * 0.4 - 0.2,
                         norm_std=torch.rand(S, generator=g, device=dev) + 0.7)
        net = (st.act_flat, st.cri_flat, st.norm_avg, st.norm_std)
        for n in K1_ENVS:
            f0, _ = body.pack(body_init(body, g, n, dev))
            f0 = f0.contiguous()
            i0 = (torch.arange(n, device=dev, dtype=torch.int32) * 37 % 200)[None].contiguous()
            sizes = {}
            for c in fr.ROLLOUT_CLUSTERS:
                if fr.rollout_smem_bytes(body, (128, 128), c) > fr.SMEM_LIMIT:
                    continue

                def fn(c=c):
                    return fr.rollout(*net, f0, i0, net_dims=(128, 128), horizon_len=64,
                                      reward_scale=1.0, body=body, seed=seed, cluster=c)
                entry = dict(ms=events_ms(fn, 5))
                if push_lib is not None and c > 1:
                    def push(fn=fn):
                        return with_library(push_lib, fn)
                    entry['push_obs_ms'] = events_ms(push, 5)
                    entry['push_obs_bitwise'] = all(torch.equal(a, b)
                                                    for a, b in zip(fn(), push()))
                if libs:
                    reset(libs['fused_rollout'])
                    fn()
                    torch.cuda.synchronize()
                    entry['phases_us_per_step'] = phases(libs['fused_rollout'], K1_PHASES, 64,
                                                         K1_TRACE)
                sizes[str(c)] = entry
            print(json.dumps(dict(kernel=f'fused_rollout[{body.env_name}]', envs=n, horizon=64,
                                  picked=fr._library().fused_rollout_cluster(
                                      body.kernel_id, n, 128, 128, 0, 0),
                                  cluster_sizes=sizes)), flush=True)
    from elegantrl_tpu_torch.ops.nets import init_flat
    for env_name, head in K6_CASES:
        body = fr.KERNEL_ENV_BODIES[env_name]
        S, A = body.state_dim, body.action_dim
        nets = ([((S, 128, 128, A), 0.1)] if head in ('ddpg', 'dqn')
                else [((S, 128, 128), None), ((128, 2 * A), 0.1)])
        flat = init_flat(torch.Generator().manual_seed(7), nets, dev)
        g = torch.Generator(device=dev).manual_seed(41)
        kw = dict(body=body, head=head, net_dims=(128, 128), reward_scale=1.0, noise_std=0.1,
                  explore_rate=0.25, std_clip=(-16.0, 2.0), seed=seed)
        for n, h in K6_SHAPES:
            f0, i0 = body.pack(body_init(body, g, n, dev))
            f0, i0 = f0.contiguous(), i0.contiguous()
            sizes = {}
            for c in fr.ROLLOUT_CLUSTERS:
                if fr.offpolicy_smem_bytes(body, (128, 128), head, c) > fr.SMEM_LIMIT:
                    continue

                def fn(c=c):
                    return fr.offpolicy_rollout(flat, f0, i0, horizon_len=h, cluster=c, **kw)
                entry = dict(ms=events_ms(fn, 10))
                if libs:
                    reset(libs['fused_rollout'])
                    fn()
                    torch.cuda.synchronize()
                    entry['phases_us_per_step'] = phases(libs['fused_rollout'], K6_PHASES, h,
                                                         K6_TRACE)
                sizes[str(c)] = entry
            print(json.dumps(dict(kernel=f'offpolicy_rollout[{env_name},{head}]', envs=n,
                                  horizon=h, picked=fr._library().offpolicy_rollout_cluster(
                                      body.kernel_id, fr.OFFPOLICY_HEADS[head], n, 128, 128, 0, 0),
                                  cluster_sizes=sizes)), flush=True)
    print(json.dumps({'device': torch.cuda.get_device_name(0), 'nvidia_smi': smi}))


def body_init(body, g, n, dev):
    """Fresh states of ``n`` envs of a kernel body's env, from ``g``."""
    from elegantrl_tpu_torch import envs
    cls = {'Pendulum-v1': envs.PendulumEnv, 'CartPole-v1': envs.CartPoleEnv,
           'HopperSlip-v0': envs.HopperEnv, 'PointChasingVecEnv': envs.PointChasingVecEnv,
           'PointChasingDiscreteEnv': envs.PointChasingDiscreteEnv}[body.env_name]
    return cls(num_envs=1)._def.init(g, n, dev)


if __name__ == '__main__':
    main()
