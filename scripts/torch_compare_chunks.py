"""Hold the off-policy update chunks, K11b, K4, the on-policy rollout (K1,
K3) and the PPO update (K2, K5) of this checkout against another checkout's
on the same inputs, on one CUDA card.

    python3 scripts/torch_compare_chunks.py OTHER_ROOT [--only chunks k11b k4 k1 k3 k2]

OTHER_ROOT is the root of another checkout of the repository, for example
the parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists (``build/``).  Each side runs in its own process (both
packages are named ``elegantrl_tpu_torch``), in the order other, this,
this, other, and builds its own kernels.  Every run makes the same inputs
from fixed seeds: the DQN-family chunk's four nets at path B's shape (B =
128, (128, 128)) and DQN / D3QN at ``dqn_lunarlander``'s ((256, 256), B =
256); the DDPG/TD3 chunk, TD3 (E = 8) and DDPG, with and without PER's
importance weights, and the SAC/ModSAC chunk (E = 4 / 8) at path A's and
C's shape (B = 1024, (128, 128), S = 6, A = 2); one chunk of C = 16 with
the last 4 steps invalid.  For each chunk it prints one JSON line: whether
the two checkouts' updated buffers and objectives are bitwise equal (the
first run of each side), and each run's ms a chunk (CUDA events over 10
chunks after 2 warm-up ones).  ``k11b``: the fused MLP3 forward at the
LunarLander widths, (8, 128, 128, 2) at B = 64 and 16,384, (8, 256, 256, 4)
and the critic's (8, 128, 128, 1) at B = 64 (ms a call by CUDA events over
50 calls, and the device ms from the profiler over 20).  ``k4``: the stock
rollout (the actor kernel and the critic pass) at ``ppo_stock``'s 256 and
``ppo_stock_4k``'s 4096 envs, H = 128, injected and Philox noise, from day
T - 61 (ms a rollout over 5).  ``k1``: the Pendulum rollout at 4096 envs,
H = 64, (128, 128); ``k3``: the CartPole rollout likewise and the HopperSlip,
PointChasing and PointChasingDiscrete ones at 1024 envs, injected and Philox
noise (ms a rollout over 10).  ``k2``: the PPO update at B = 512, (128, 128):
Pendulum U = 1 and 32, CartPole (discrete) U = 1, ``ppo_lunarlander_cont``'s
S = 8, A = 2, U = 8 and ``ppo_stock``'s S = 151, A = 15, U = 2 (ms a call
over 20).  Where two designs sum in other orders the
outputs are not bitwise equal; each line also gives the largest difference.
``--only`` picks the groups (all by default).  Needs one card; the last
line names it.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile

C, VALID = 16, 12
CASES = ([('dqn', t, d, 4, 2, 128, (128, 128)) for t, d in
          ((False, False), (True, False), (False, True), (True, True))]
         + [('dqn', t, d, 8, 4, 256, (256, 256)) for t, d in ((False, False), (True, True))]
         + [('ddpg', td3, per, 6, 2, 1024, (128, 128)) for td3 in (True, False)
            for per in (False, True)]
         + [('sac', modsac, None, 6, 2, 1024, (128, 128)) for modsac in (False, True)])


def case_name(kind, a, b, S, A, B, net):
    if kind == 'dqn':
        name = {(False, False): 'dqn', (True, False): 'doubledqn', (False, True): 'duelingdqn',
                (True, True): 'd3qn'}[(a, b)]
    elif kind == 'ddpg':
        name = ('td3' if a else 'ddpg') + ('_per' if b else '')
    else:
        name = 'modsac' if a else 'sac'
    return f'{name}{list(net)},B={B}'


GROUPS = ('chunks', 'k11b', 'k4', 'k1', 'k3', 'k2')
K11B_CASES = (((8, 128, 128, 2), 64), ((8, 128, 128, 2), 16384), ((8, 256, 256, 4), 64),
              ((8, 128, 128, 1), 64))
K4_ENVS = (256, 4096)
K2_CASES = (('pendulum', 3, 1, False, 1), ('pendulum', 3, 1, False, 32),
            ('cartpole', 4, 2, True, 1), ('lunar', 8, 2, False, 8), ('stock', 151, 15, False, 2))


def cuda_ms(torch, fn, reps, warmup):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps, kernel_name):
    """Device ms a call of the kernels named ``kernel_name``, profiled."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(ev.time_range.elapsed_us() for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and kernel_name in ev.name) / 1e3 / reps


def run_k11b(torch, dev):
    from elegantrl_tpu_torch.ops import kernels as kn
    from elegantrl_tpu_torch.ops.nets import mlp_init
    results = {}
    for dims, B in K11B_CASES:
        g = torch.Generator(device=dev).manual_seed(B)
        leaves = [p.detach().to(dev).contiguous() for p in
                  mlp_init(torch.Generator().manual_seed(B), dims, out_std=0.1).leaves()]
        x = torch.randn((B, dims[0]), generator=g, device=dev)
        out = kn.fused_mlp3(x, *leaves)

        def fn():
            return kn.fused_mlp3(x, *leaves)
        results[f'fused_mlp3{list(dims)},B={B}'] = dict(
            outs=[out.cpu()], ms=cuda_ms(torch, fn, 50, 3),
            device_ms=device_ms(torch, fn, 20, 'fused_mlp3'))
    return results


def run_k4(torch, dev):
    from elegantrl_tpu_torch import Config
    from elegantrl_tpu_torch.agents.ppo import make_ppo
    from elegantrl_tpu_torch.envs import StockTradingVecEnv
    from elegantrl_tpu_torch.ops import fused_rollout as fr
    env_def = StockTradingVecEnv(num_envs=1)._def
    body = env_def.kernel_body
    S, A, NR = body.state_dim, body.action_dim, body.n_reset
    T = body.tables.close.shape[0]
    st = make_ppo((128, 128), S, A, Config()).init(0, dev)
    g = torch.Generator(device=dev).manual_seed(41)
    st = st._replace(norm_avg=torch.rand(S, generator=g, device=dev) * 0.4 - 0.2,
                     norm_std=torch.rand(S, generator=g, device=dev) + 0.7)
    with torch.no_grad():
        st.act.std_log.fill_(-0.5)
    net = (st.act_flat, st.cri_flat, st.norm_avg, st.norm_std)
    seed = torch.tensor([20260, -77], dtype=torch.int32, device=dev)
    results = {}
    for n in K4_ENVS:
        f0, _ = body.pack(env_def.init(g, n, dev))
        f0 = f0.contiguous()
        i0 = torch.full((1, n), T - 61, dtype=torch.int32, device=dev)
        nz = torch.cat([torch.randn((128, A, n), generator=g, device=dev),
                        torch.rand((128, NR, n), generator=g, device=dev)], 1).contiguous()
        for mode, extra in (('injected', dict(noise=nz)), ('philox', dict(seed=seed))):
            def fn():
                return fr.rollout(*net, f0, i0, net_dims=(128, 128), horizon_len=128,
                                  reward_scale=2.0 ** -8, body=body, **extra)
            out = fn()
            results[f'stock_rollout[{n} envs,{mode}]'] = dict(
                outs=[x.cpu() for x in out], ms=cuda_ms(torch, fn, 5, 1))
    return results


def run_onpolicy_rollouts(torch, dev, groups):
    """K1 (``k1``) and K3 (``k3``): every on-policy kernel body from seeded
    env rows, staggered step counters and noise."""
    from elegantrl_tpu_torch import Config
    from elegantrl_tpu_torch.agents.ppo import make_ppo
    from elegantrl_tpu_torch.ops import fused_rollout as fr
    cases = [(fr.PENDULUM_BODY, 4096)] if 'k1' in groups else []
    if 'k3' in groups:
        cases += [(fr.CARTPOLE_BODY, 4096), (fr.HOPPER_BODY, 1024), (fr.CHASING_BODY, 1024),
                  (fr.CHASING_DISCRETE_BODY, 1024)]
    seed = torch.tensor([20260, -77], dtype=torch.int32, device=dev)
    results = {}
    for body, n in cases:
        S, A = body.state_dim, body.action_dim
        st = make_ppo((128, 128), S, A, Config(), discrete=body.discrete).init(0, dev)
        g = torch.Generator(device=dev).manual_seed(41)
        st = st._replace(norm_avg=torch.rand(S, generator=g, device=dev) * 0.4 - 0.2,
                         norm_std=torch.rand(S, generator=g, device=dev) + 0.7)
        f0 = (torch.rand((body.n_f32, n), generator=g, device=dev) * 0.1).contiguous()
        if body is fr.HOPPER_BODY:
            f0[1], f0[5] = 0.9, 0.55
        if body in (fr.CHASING_BODY, fr.CHASING_DISCRETE_BODY):
            f0[4:6], f0[8] = -8.0, 11.3
        i0 = (torch.arange(n, device=dev, dtype=torch.int32) * 37 % 200)[None].contiguous()
        head = (torch.rand if body.discrete else torch.randn)((64, A, n), generator=g, device=dev)
        nz = torch.cat([head, torch.rand((64, body.n_step + body.n_reset, n), generator=g,
                                         device=dev)], 1).contiguous()
        net = (st.act_flat, st.cri_flat, st.norm_avg, st.norm_std)
        for mode, extra in (('injected', dict(noise=nz)), ('philox', dict(seed=seed))):
            def fn():
                return fr.rollout(*net, f0, i0, net_dims=(128, 128), horizon_len=64,
                                  reward_scale=1.0, body=body, **extra)
            out = fn()
            results[f'fused_rollout[{body.env_name},{n} envs,{mode}]'] = dict(
                outs=[x.cpu() for x in out], ms=cuda_ms(torch, fn, 10, 2))
    return results


def run_k2(torch, dev):
    """K2 and K5: the PPO update's cases of ``K2_CASES`` from seeded blocks."""
    from elegantrl_tpu_torch import Config
    from elegantrl_tpu_torch.agents.ppo import make_ppo
    from elegantrl_tpu_torch.ops.fused_update import ppo_update
    results, B = {}, 512
    for tag, S, A, discrete, U in K2_CASES:
        st = make_ppo((128, 128), S, A, Config(), discrete=discrete).init(0, dev)
        g = torch.Generator(device=dev).manual_seed(100 + U)
        if discrete:
            ab = torch.nn.functional.one_hot(torch.randint(0, A, (U, B), generator=g, device=dev),
                                             A).float().transpose(1, 2).contiguous()
        else:
            ab = torch.randn((U, A, B), generator=g, device=dev)
        block = [torch.randn((U, S, B), generator=g, device=dev), ab,
                 torch.randn((U, B), generator=g, device=dev) * 0.3 - 1.2,
                 torch.randn((U, B), generator=g, device=dev),
                 torch.randn((U, B), generator=g, device=dev),
                 (torch.rand((U, B), generator=g, device=dev) > 0.05).float()]
        base = [st.act_flat, st.cri_flat, st.act_opt.mu + 1e-4, st.act_opt.nu + 1e-8,
                st.cri_opt.mu + 1e-4, st.cri_opt.nu + 1e-8]
        hyper = dict(net_dims=(128, 128), ratio_clip=0.25, lr=6e-5, clip_grad=3.0,
                     lambda_entropy=0.01 if discrete else 0.001, discrete=discrete)
        bufs = [b.clone() for b in base]
        objs = ppo_update(*bufs, 5, 5, st.norm_avg, st.norm_std, *block, **hyper)
        outs = [x.cpu() for x in bufs + [objs]]
        bufs = [b.clone() for b in base]
        ms = cuda_ms(torch, lambda: ppo_update(*bufs, 5, 5, st.norm_avg, st.norm_std, *block,
                                               **hyper), 20, 2)
        results[f'ppo_update[{tag},S={S},A={A},U={U}]'] = dict(outs=outs, ms=ms)
    return results


def run_side(root, out_path, groups):
    """Run every case of ``groups`` with the package under ``root``; save the
    outputs and the times to ``out_path``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from elegantrl_tpu_torch.ops import fused_offpolicy_update as fo
    from elegantrl_tpu_torch.ops.nets import (ddpg_param_shapes, dqn_param_shapes,
                                              sac_act_shapes, sac_cri_shapes)
    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False

    def buffers(g, n):
        p = torch.randn(n, generator=g, device=dev) * 0.05
        return [p, p + 0.01 * torch.randn(n, generator=g, device=dev),
                1e-3 * torch.randn(n, generator=g, device=dev),
                1e-6 * torch.rand(n, generator=g, device=dev)]

    def rows(g, B):
        return [torch.randn((C, B), generator=g, device=dev),
                (torch.rand((C, B), generator=g, device=dev) > 0.05).float(),
                (torch.rand((C, B), generator=g, device=dev) > 0.02).float()]

    def inputs(kind, a, b, S, A, B, net):
        """(wrapper, buffers, blocks, bcv of n valid steps, hyper)."""
        g = torch.Generator(device=dev).manual_seed(41)
        idx = torch.arange(C, device=dev)
        if kind == 'dqn':
            base = buffers(g, sum(math.prod(x) for x in dqn_param_shapes(S, net, A, a, b)))
            oh = torch.nn.functional.one_hot(torch.randint(0, A, (C, B), generator=g, device=dev),
                                             A).float().transpose(1, 2).contiguous()
            blocks = [torch.randn((C, S, B), generator=g, device=dev),
                      torch.randn((C, S, B), generator=g, device=dev), oh, *rows(g, B)]
            return (fo.dqn_chunk, base, blocks, lambda n: fo.dqn_bcv(5, idx, n),
                    dict(net_dims=net, twin=a, duel=b, gamma=0.99, tau=5e-3, lr=1e-3,
                         clip_grad=3.0))
        if kind == 'ddpg':
            E = 8 if a else 1
            act, cri = ddpg_param_shapes(S, net, A, E)
            pa, ta, mua, nua = buffers(g, sum(math.prod(x) for x in act))
            pc, tc, muc, nuc = buffers(g, sum(math.prod(x) for x in cri))
            blocks = [torch.randn((C, S, B), generator=g, device=dev),
                      torch.randn((C, S, B), generator=g, device=dev),
                      torch.rand((C, A, B), generator=g, device=dev) * 2 - 1, *rows(g, B),
                      0.1 * torch.randn((C, A, B), generator=g, device=dev)]
            iw = 0.2 + torch.rand((C, B), generator=g, device=dev) if b else None
            return (fo.ddpg_chunk, [pa, pc, ta, tc, mua, muc, nua, nuc], blocks,
                    lambda n: fo.ddpg_bcv(9, 4, idx, n, idx % 2 == 0, (idx + 1) // 2 + 1),
                    dict(net_dims=net, td3=a, num_ensembles=E, gamma=0.99, tau=5e-3, lr=3e-4,
                         clip_grad=3.0, iw=iw))
        E = 8 if a else 4
        pa, ta, mua, nua = buffers(g, sum(math.prod(x) for x in sac_act_shapes(S, net, A, a)))
        pc, tc, muc, nuc = buffers(g, sum(math.prod(x) for x in sac_cri_shapes(S, A, net, E)))
        misc = torch.tensor([-1.0, 1e-3, 1e-6, 9.0, 5.0], device=dev)
        blocks = [torch.randn((C, S, B), generator=g, device=dev),
                  torch.randn((C, S, B), generator=g, device=dev),
                  torch.rand((C, A, B), generator=g, device=dev) * 2 - 1, *rows(g, B),
                  torch.randn((C, A, B), generator=g, device=dev),
                  torch.randn((C, A, B), generator=g, device=dev)]
        return (fo.sac_chunk, [pa, pc, ta if a else None, tc, mua, muc, nua, nuc, misc], blocks,
                lambda n: fo.sac_bcv(9, 9, idx, n),
                dict(net_dims=net, modsac=a, num_ensembles=E, gamma=0.99, tau=5e-3, lr=3e-4,
                     clip_grad=3.0, target_entropy=-math.log(A) if a else math.log(A),
                     std_clip=(-20.0, 2.0) if a else (-16.0, 2.0)))

    results = {}
    if 'k11b' in groups:
        results.update(run_k11b(torch, dev))
    if 'k4' in groups:
        results.update(run_k4(torch, dev))
    if 'k1' in groups or 'k3' in groups:
        results.update(run_onpolicy_rollouts(torch, dev, groups))
    if 'k2' in groups:
        results.update(run_k2(torch, dev))
    for case in (CASES if 'chunks' in groups else ()):
        fn, base, blocks, bcv, hyper = inputs(*case)
        bufs = [None if x is None else x.clone() for x in base]
        objs = fn(*bufs, *blocks, bcv(VALID), **hyper)
        outs = [x for x in bufs if x is not None] + list(objs if isinstance(objs, tuple)
                                                         else (objs,))
        bufs = [None if x is None else x.clone() for x in base]
        full = bcv(C)
        for _ in range(2):
            fn(*bufs, *blocks, full, **hyper)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(10):
            fn(*bufs, *blocks, full, **hyper)
        end.record()
        torch.cuda.synchronize()
        results[case_name(*case)] = dict(outs=[x.cpu() for x in outs],
                                         ms=start.elapsed_time(end) / 10)
    torch.save(results, out_path)


def max_diff(torch, mine, theirs):
    """Largest absolute difference over the float outputs (None if shapes differ)."""
    if len(mine) != len(theirs) or any(a.shape != b.shape for a, b in zip(mine, theirs)):
        return None
    return max([float((a.double() - b.double()).abs().max()) for a, b in zip(mine, theirs)
                if a.dtype.is_floating_point and a.numel()] or [0.0])


def main():
    if len(sys.argv) >= 4 and sys.argv[1] == '--side':
        run_side(sys.argv[2], sys.argv[3], sys.argv[4:])
        return
    parser = argparse.ArgumentParser(usage=__doc__)
    parser.add_argument('other')
    parser.add_argument('--only', nargs='+', choices=GROUPS, default=list(GROUPS))
    opts = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('torch_compare_chunks: this needs a CUDA card')
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sides = {'other': opts.other, 'this': here}
    runs = {'other': [], 'this': []}
    with tempfile.TemporaryDirectory() as tmp:
        for k, side in enumerate(('other', 'this', 'this', 'other')):
            path = os.path.join(tmp, f'{k}.pt')
            subprocess.run([sys.executable, os.path.abspath(__file__), '--side', sides[side],
                            path, *opts.only], check=True)
            runs[side].append(torch.load(path))
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    for name in runs['this'][0]:
        mine, theirs = runs['this'][0][name]['outs'], runs['other'][0][name]['outs']
        equal = len(mine) == len(theirs) and all(torch.equal(a, b) for a, b in zip(mine, theirs))
        line = {'case': name, 'bitwise_equal': equal,
                'max_abs_diff': max_diff(torch, mine, theirs),
                'ms_other': [r[name]['ms'] for r in runs['other']],
                'ms_this': [r[name]['ms'] for r in runs['this']]}
        if 'device_ms' in runs['this'][0][name]:
            line['device_ms_other'] = [r[name]['device_ms'] for r in runs['other']]
            line['device_ms_this'] = [r[name]['device_ms'] for r in runs['this']]
        print(json.dumps(line), flush=True)
    print(json.dumps({'device': torch.cuda.get_device_name(0), 'nvidia_smi': smi}))


if __name__ == '__main__':
    main()
