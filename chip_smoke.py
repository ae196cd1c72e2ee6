"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``elegantrl_tpu_torch``'s main paths on the card (PPO on Pendulum-v1,
discrete PPO on CartPole-v1, TD3, SAC and TD3 with prioritised replay on
HopperSlip-v0, DQN on CartPole-v1, PPO on StockTradingEnv-v2 at ``ppo_stock``
and ``ppo_stock_4k``, PPO on LunarLanderContinuous-v2 and DQN on
LunarLander-v2) and holds each hand-written kernel against its plain
PyTorch version:

1. device: name and power limit (``nvidia-smi``); TF32 off;
2. build: ``nvcc`` for ``sm_90a`` on every ``ops/csrc/*.cu``, all at once;
3. fused rollout, Pendulum + Gaussian head, against ``rollout_reference`` at
   full width (4096 envs, H=64, (128, 128)), injected noise and Philox noise,
   two runs bitwise equal, and its time at each cluster size that fits
   (``k1_cluster_ms``);
4. its Philox draws, statistically (262,144 normals, reset ranges);
5. fused PPO update, continuous head, against ``ppo_update_reference`` at
   U=1 and U=32, B=512, and at ``ppo_lunarlander_cont``'s S = 8, A = 2, U =
   8 and at (512, 512) (``k2_vs_plain_wide``); each twice bitwise equal, its
   phases from block 0's stamps (``ppo_phase_ms``) and the profiler's count
   of CUDA kernels a call (one, whatever U is);
6. fused rollout for CartPole + categorical, HopperSlip + Gaussian,
   PointChasing + Gaussian and PointChasingDiscrete + categorical, each
   against ``rollout_reference`` at full width, both noise modes, with a
   one-step check on every state the rollout visits, two runs bitwise equal
   and the time at each cluster size at 4096 and 1024 envs; Pendulum and
   CartPole likewise at (256, 256) (``k13_vs_plain_wide``); the Gumbel-max
   sample and the chasing reset's normals, statistically;
7. fused PPO update, discrete head, at U=1 and U=32, B=512, A=2 and A=9
   (and K2 at the stock widths), with the checks of 5;
8. the Pendulum main path: ``build_training`` at the bench config (4096
   envs, H=64, B=512, repeat 8, (128, 128)), one small round against the
   same round on the CPU, then 10 timed rounds with the launch counts reset
   just before them; the card refuses every plain path where the JAX
   package takes a kernel;
9. the CartPole main path, ``AgentDiscretePPO`` at the same sizes, likewise;
10. the entry point: ``train_agent`` for PPO on Pendulum and discrete PPO on
    CartPole (two evaluation periods each) and, shorter, A2C on Pendulum,
    PPO on HopperSlip, PPO on PointChasing and discrete A2C on
    PointChasingDiscrete, so every agent class and env body has run on the
    card through the entry point;
11. the off-policy family (``offpolicy_phases``): the off-policy rollout
    kernel's fifteen (body, head) instantiations, the ddpg, sac and modsac
    heads on the three continuous bodies and the DQN heads on the two
    discrete ones, against their plain version (``k6_vs_plain``, both noise
    modes), the DQN-family update chunk's four variants (``k9_vs_plain``),
    the DDPG/TD3 chunk (``k7_vs_plain``; ``k7_vs_plain_wide``: TD3 at (256,
    256) with B = 512 and DDPG at (1024, 1024) with B = 128, workloads the
    JAX package sends to its chunk) and the SAC/ModSAC chunk
    (``k8_vs_plain``) against theirs, each chunk one cooperative launch
    whose invalid steps leave every buffer bit-identical, whose two runs
    are bitwise equal and whose phases block 0 stamps (``phase_ms``); the
    three off-policy main paths at full
    width, TD3 on HopperSlip (1024 envs, H=32, ring 4000 rows, batch 1024,
    repeat 4), DQN on CartPole (64 envs, H=64, ring 20,000 rows, batch 128,
    repeat 1) and SAC on HopperSlip (path A's sizes, E = 4), each with a
    small round against the CPU, the ring filled by kernel rollouts inserted
    without updates, then 10 timed rounds; ``train_agent`` for every
    off-policy agent class (SAC and ModSAC on all three continuous bodies,
    SAC on Pendulum at batch 64 through the PyTorch update); the card
    refusing the plain update;
12. prioritised replay and the rest of the off-policy family: the PER
    variant of the DDPG/TD3 chunk (K7') against its plain version for TD3 and
    DDPG on a real PER draw (``k7per_vs_plain``); the priority tree on the
    card against the CPU with duplicate ids (``per_tree_vs_cpu``); path D,
    TD3 with PER on HopperSlip at path A's sizes, a small round against the
    CPU and 10 timed rounds; ``train_agent`` for TD3 and DDPG with PER at
    ``td3_pendulum_per``'s shape (K7'), DQN and SAC with PER, TD3 with
    ``lambda_fit_cum_r``, EmbedDQN, EnsembleDQN and the five H-term agents
    (each PyTorch path said so), and an ``if_save_buffer`` run resumed with
    ``continue_train``;
13. StockTradingEnv-v2 (``stock_phases``): K4, the stock body of both rollout
    kernels (the on-policy one as the stock actor kernel, a lane group on a
    thread-block cluster, plus a critic pass), against its plain version at
    ``ppo_stock``'s 256 and ``ppo_stock_4k``'s 4096 envs and a ragged 300,
    H = 128, both noise modes, two runs bitwise equal, with a one-step check
    from every visited state whose lot flips must each sit at a lot edge,
    and the kernel's time at each cluster size (``k4_vs_plain``); the ddpg, sac and modsac heads on the stock body
    (``k4_offpolicy_vs_plain``); the reset's and the head's Philox draws
    (``k4_philox``); the ``ppo_stock`` main path (a small round against the
    CPU, then 10 timed rounds: 10 K4 rollouts, 10 critic passes, 10 K2
    updates) and the ``ppo_stock_4k`` one (10 K4 rollouts and critic passes,
    the autograd update, 0 K2); ``train_agent`` for PPO (the evaluator
    reporting ``cumulative_returns``), TD3, SAC and ModSAC on the stock env;
14. LunarLander and the kernels of ``ops/kernels.py`` (``lunar_phases``):
    K10, the V-trace recursion, bitwise against its plain loop at 256 x 64,
    64 x 4096 and 37 x 1000 (``k10_vs_plain``); K11a, the replay gather, one
    launch for all six fields of a chunk (states and next states in the
    (C, S, B) layout), bitwise against ``buf[ids0, ids1]`` at
    ``dqn_lunarlander``'s row chunk and path D's chunk, int64 and int32 ids,
    with six such calls and the transposes as the library yardstick, and
    its one-field case (``k11a_vs_plain``); K11b, the fused 3-layer MLP
    forward on thread-block clusters, within 1e-5 of the largest plain
    output at (8, 128, 128, 2), (8, 256, 256, 4) and (8, 128, 128, 1) for B =
    1, 64, 65, 1000, 4096 and 16,384, two runs bitwise equal, call and
    device time (``k11b_vs_plain``); K2 at S = 8, A = 2,
    U = 8 (``k2_vs_plain_lunar``) and K9 at (256, 256), B = 256
    (``k9_vs_plain_lunar``, with the other K9 checks); the
    ``ppo_lunarlander_cont`` and ``dqn_lunarlander`` main paths, 10 rounds
    each (the DQN ring filled with transitions drawn from a seed), with
    every kernel's launches counted; ``train_agent`` for PPO (through
    ``train_agent_single_process``), DQN and D3QN on LunarLander, and
    ``valid_agent`` on the saved D3QN agent against the trained state's
    greedy episodes;
15. the seven Mosaic probes (``probe_phases``): each kernel of
    ``ops/probes.py`` exactly equal to the JAX script's values (888, 1400,
    448, ...) and to its plain version at the script's inputs and at seeded
    random integer-valued tables and days (``probes_vs_plain``), then the
    probes' entry point ``scripts/torch_probe_ops.py`` with the counts reset;
16. the kernels line and the device line.

Each phase prints one JSON line; any failure raises and exits non-zero.
Needs one CUDA card and the CUDA toolkit; imports nothing of JAX.
"""

import json
import math
import subprocess
import sys
import tempfile
import time

NUM_ENVS, HORIZON, BATCH, REPEAT, NET_DIMS = 4096, 64, 512, 8.0, (128, 128)
ROUNDS = 10

# Published dense peaks of the H100 SXM part (NVIDIA data sheet, 700 W):
# FP32 on the CUDA cores, TFLOP/s, and HBM bandwidth, TB/s.
H100_SXM_PEAKS = (67.0, 3.35)


def emit(**kw):
    print(json.dumps(kw), flush=True)


def scalars(metrics):
    """A round's scalar metrics (a discrete agent's also carry its action
    histogram, a vector)."""
    return {k: v for k, v in metrics.items() if v.dim() == 0}


def peaks_for(name):
    """The card's peaks; the SXM H100 reports itself as 'H100 ... HBM3' or
    'H100 SXM'.  Any other card has no entry, and the bounds would be wrong."""
    if 'H100' in name and ('HBM3' in name or 'SXM' in name) \
            and not any(k in name for k in ('PCIe', 'NVL')):
        return 'H100 SXM', H100_SXM_PEAKS
    raise SystemExit(f'chip_smoke: no peak rates for {name!r}; the bounds need its '
                     'FP32 and memory rates')


def cuda_ms(torch, fn, reps, warmup=1):
    """Mean ms per call of ``fn`` on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled_ms(torch, fn, reps, kernel_name):
    """Mean device ms per call of the kernels whose name holds
    ``kernel_name``, from ``torch.profiler`` over ``reps`` calls (after one
    warm-up); raises when the trace holds none (no device time traced)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(ev.time_range.elapsed_us() for ev in prof.events()
                if ev.device_type == torch.autograd.DeviceType.CUDA and kernel_name in ev.name)
    assert total > 0, f'the profiler traced no device time for {kernel_name}'
    return total / 1e3 / reps


def device_kernels(torch, fn, reps=3):
    """The names of the CUDA kernels ``reps`` calls of ``fn`` launch (memsets
    and copies left out), from ``torch.profiler``; a trace that came back
    with no device event at all is taken once more."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        device = [ev.name for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA]
        if device:
            break
    return [n for n in device if not n.startswith(('Memset', 'Memcpy', '[memory]'))]


# ---------------------------------------------------------------- off-policy

OFF_NET = (128, 128)
# the two off-policy main paths, the JAX package's profiled round shapes
# (scripts/profile_sol.py: td3_hopper_shape, dqn_cartpole_shape)
PATH_A = dict(envs=1024, horizon=32, buffer=4000, batch=1024, repeat=4.0, lr=3e-4,
              updates=15)
PATH_B = dict(envs=64, horizon=64, buffer=20000, batch=128, repeat=1.0, lr=1e-3,
              updates=156)
# path C, SAC on HopperSlip: the JAX package's sac_hopper_shape (E = 4)
PATH_C = dict(envs=1024, horizon=32, buffer=4000, batch=1024, repeat=4.0, lr=3e-4,
              updates=15)
# path D, TD3 with prioritised replay on HopperSlip at path A's sizes (K7')
PATH_D = dict(PATH_A)
K6_PAIRS = (('Pendulum-v1', 'ddpg'), ('HopperSlip-v0', 'ddpg'), ('PointChasingVecEnv', 'ddpg'),
            ('CartPole-v1', 'dqn'), ('CartPole-v1', 'dqn_enc'), ('CartPole-v1', 'dqn_duel'),
            ('PointChasingDiscreteEnv', 'dqn'), ('PointChasingDiscreteEnv', 'dqn_enc'),
            ('PointChasingDiscreteEnv', 'dqn_duel'),
            ('Pendulum-v1', 'sac'), ('HopperSlip-v0', 'sac'), ('PointChasingVecEnv', 'sac'),
            ('Pendulum-v1', 'modsac'), ('HopperSlip-v0', 'modsac'),
            ('PointChasingVecEnv', 'modsac'))
# the update chunks' main-path variant for each rollout head
CHUNK_VARIANT = {'ddpg': 'td3', 'dqn': 'dqn', 'sac': 'sac'}


def std_clip(head):
    """The runner's log_std clip of the rollout's SAC heads."""
    return (-20.0, 2.0) if head == 'modsac' else (-16.0, 2.0)


def offpolicy_smem_pairs():
    """The off-policy kernels' shared memory as each .cu computes it and as
    the Python copy that judges eligibility on the CPU does."""
    from elegantrl_tpu_torch.ops import fused_offpolicy_update as fo, fused_rollout as fr
    out = {}
    for env_name, head in K6_PAIRS:
        body = fr.KERNEL_ENV_BODIES[env_name]
        S, A = body.state_dim, body.action_dim
        out[f'offpolicy_rollout[{env_name},{head}]'] = (
            fr._library().offpolicy_rollout_smem_bytes(S, A, *OFF_NET, fr.OFFPOLICY_HEADS[head]),
            fr.offpolicy_smem_bytes(S, OFF_NET, A, head))
    out['dqn_update'] = (fo._dqn_library().dqn_update_smem_bytes(), fo.DQN_SMEM_BYTES)
    out['ddpg_update'] = (fo._ddpg_library().ddpg_update_smem_bytes(), fo.DDPG_SMEM_BYTES)
    out['sac_update'] = (fo._sac_library().sac_update_smem_bytes(), fo.SAC_SMEM_BYTES)
    # and the phase names that read the kernels' traces, one per phase
    out['dqn_update phases'] = (fo._dqn_library().dqn_update_phases(), len(fo.DQN_PHASES))
    out['ddpg_update phases'] = (fo._ddpg_library().ddpg_update_phases(), len(fo.DDPG_PHASES))
    out['sac_update phases'] = (fo._sac_library().sac_update_phases(), len(fo.SAC_PHASES))
    return out


def stock_smem_pairs():
    """The stock body's kernels' shared memory as the .cu computes it and as
    the Python copies that judge eligibility on the CPU do."""
    from elegantrl_tpu_torch.ops import fused_rollout as fr
    lib, S, A = fr._library(), 151, 15
    out = {f'stock_rollout[cluster={c}]': (lib.stock_rollout_smem_bytes(*OFF_NET, c),
                                           fr.actor_smem_bytes(S, OFF_NET, A, c))
           for c in (1, 2, 4, 8)}
    out[f'critic_values[S={S}]'] = (lib.critic_values_smem_bytes(S, *OFF_NET),
                                    fr.critic_smem_bytes(S, OFF_NET))
    for head in fr.CONTINUOUS_HEADS:
        out[f'offpolicy_rollout[StockTradingEnv-v2,{head}]'] = (
            lib.offpolicy_rollout_smem_bytes(S, A, *OFF_NET, fr.OFFPOLICY_HEADS[head]),
            fr.offpolicy_smem_bytes(S, OFF_NET, A, head))
    return out


def offpolicy_phases(torch, dev, name, smi, bound, seed):
    """The off-policy phases; returns their entries of the kernels line."""
    import contextlib
    import io
    import numpy as np
    from elegantrl_tpu_torch import Config, build_training, train_agent
    from elegantrl_tpu_torch.agents import (AgentD3QN, AgentDDPG, AgentDDPGHterm,
                                            AgentDoubleDQN, AgentDQN, AgentDuelingDQN,
                                            AgentEmbedDQN, AgentEnsembleDQN, AgentModSAC,
                                            AgentModSACHterm, AgentPPOHterm, AgentSAC,
                                            AgentSACHterm, AgentTD3, AgentTD3Hterm)
    from elegantrl_tpu_torch.agents.off_policy import offpolicy_update_times
    from elegantrl_tpu_torch.envs import (CartPoleEnv, HopperEnv, PendulumEnv,
                                          PointChasingDiscreteEnv, PointChasingVecEnv)
    from elegantrl_tpu_torch.ops import fused_offpolicy_update as fo, fused_rollout as fr
    from elegantrl_tpu_torch.ops import kernels as kn
    from elegantrl_tpu_torch.ops.nets import (ddpg_param_shapes, dqn_param_shapes, init_flat,
                                              sac_act_shapes, sac_cri_shapes, split_flat)
    from elegantrl_tpu_torch.ops.per import SegmentTree
    from elegantrl_tpu_torch.train.replay_buffer import ReplayBuffer
    D1, D2 = OFF_NET
    env_classes = {'Pendulum-v1': PendulumEnv, 'HopperSlip-v0': HopperEnv,
                   'PointChasingVecEnv': PointChasingVecEnv, 'CartPole-v1': CartPoleEnv,
                   'PointChasingDiscreteEnv': PointChasingDiscreteEnv}
    rollout_src = 'elegantrl_tpu_torch/ops/csrc/fused_rollout.cu'
    counters = (fr.offpolicy_rollout, fo.dqn_chunk, fo.ddpg_chunk, fo.sac_chunk)

    def reset_counts():
        for fn in counters:
            fn.launches = 0
        kn.buffer_gather_fields.launches = 0
        fr.offpolicy_rollout.launches_by_kernel.clear()
        for fn in counters[1:]:
            for k in fn.launches_by_variant:
                fn.launches_by_variant[k] = 0

    def read_counts():
        """The rollout launches by (env, head), and the chunks of every update
        variant."""
        chunks = {}
        for fn in counters[1:]:
            chunks.update(fn.launches_by_variant)
        return dict(fr.offpolicy_rollout.launches_by_kernel), chunks

    def cuda_ms_(fn, reps, warmup=1):
        return cuda_ms(torch, fn, reps, warmup)

    def flat_for(body, head, seed_):
        """The head's net as the agents initialise it, from a seed."""
        S, A = body.state_dim, body.action_dim
        heads = {'sac': [((D2, 2 * A), 0.1)], 'modsac': [((D2, A), 0.1)] * 2,
                 'dqn_duel': [((D2, A), 0.1), ((D2, 1), 0.1)]}.get(head, [((D2, A), 0.1)])
        nets = ([((S, D1, D2, A), 0.1)] if head in ('ddpg', 'dqn')
                else [((S, D1, D2), None)] + heads)
        return init_flat(torch.Generator().manual_seed(seed_), nets, dev)

    def k6_noise(body, head, gen, h, n):
        A, n_env = body.action_dim, body.n_step + body.n_reset
        if head in fr.CONTINUOUS_HEADS:
            return torch.cat([torch.randn((h, A, n), generator=gen, device=dev),
                              torch.rand((h, n_env, n), generator=gen, device=dev)], 1).contiguous()
        return torch.rand((h, 2 + n_env, n), generator=gen, device=dev)

    def k6_fields_differ(got, want, tol):
        """(H, N): a flag or discrete action differs, or a float output by more
        than ``tol``; and the largest float difference."""
        bad = torch.zeros_like(got.rewards, dtype=torch.bool)
        worst = torch.zeros_like(got.rewards)
        for f in got._fields[:5]:
            a, b = getattr(got, f), getattr(want, f)
            if f in ('terminals', 'truncates') or not a.dtype.is_floating_point:
                bad |= a != b
            else:
                d = (a - b).abs()
                worst = torch.maximum(worst, d.amax(-1) if d.dim() == 3 else d)
        return bad | (worst > tol), worst

    def k6_bound(body, head, n, h, n_params):
        S, A = body.state_dim, body.action_dim
        out_rows = {'dqn_duel': A + 1, 'sac': 2 * A, 'modsac': 2 * A}.get(head, A)
        flop = 2 * (S * D1 + D1 * D2 + D2 * out_rows) * n * h
        rows = body.n_f32 + body.n_i32
        a_out = A if head in fr.CONTINUOUS_HEADS else 1
        nbytes = 4 * (n_params + 2 + 2 * rows * n + n * h * (S + a_out + 3))
        return bound(flop, nbytes)

    # ---- k6_vs_plain: each instantiation at its main path's envs and horizon
    # Tolerances as for the on-policy bodies (k3_vs_plain): whole trajectories
    # in both noise modes, a lane parts from its twin at the first step where
    # an output differs by more than 2e-2 or a flag or discrete action
    # differs, at most 1% of lanes part (at least one lane may: path B has
    # only 64); one step from every visited state
    # (injected noise) agrees to 1e-4 with discrete actions and flags equal,
    # but for at most 8 samples within rounding of a hard threshold (an argmax
    # near-tie, CartPole's limits, a touchdown), counted and left out.
    k6 = {}
    for env_name, head in K6_PAIRS:
        body = fr.KERNEL_ENV_BODIES[env_name]
        path = PATH_A if head in fr.CONTINUOUS_HEADS else PATH_B
        n, h = path['envs'], path['horizon']
        tag = f'fused_rollout[{env_name},{head}]'
        g = torch.Generator(device=dev).manual_seed(31)
        flat = flat_for(body, head, 7)
        env_def = env_classes[env_name](num_envs=1)._def
        f0, i0 = body.pack(env_def.init(g, n, dev))
        i0 = (torch.arange(n, device=dev, dtype=torch.int32) * 37 % env_def.spec.max_step)[None]
        if body is fr.HOPPER_BODY:
            f0[1, :16], f0[3, :16] = 0.27, -3.0
        f0, i0 = f0.contiguous(), i0.contiguous()
        nz = k6_noise(body, head, g, h, n)
        kw = dict(body=body, head=head, net_dims=OFF_NET, reward_scale=1.0, noise_std=0.1,
                  explore_rate=0.25, std_clip=std_clip(head))
        report = {}
        for mode, extra in (('injected', dict(noise=nz)), ('philox', dict(seed=seed))):
            trace = []
            got = fr.offpolicy_rollout(flat, f0, i0, horizon_len=h, **kw, **extra)
            want = fr.offpolicy_rollout_reference(flat, f0, i0, horizon_len=h, env_trace=trace,
                                                  **kw, **extra)
            torch.cuda.synchronize()
            differ, worst = k6_fields_differ(got, want, 2e-2)
            parted = differ.any(0)
            share = float(parted.float().mean())
            kept = ~parted
            end = torch.maximum((got.env_f - want.env_f).abs().amax(0),
                                (got.env_i != want.env_i).any(0).float())
            assert int(parted.sum()) <= max(1, int(0.01 * n)), (tag, mode, share)
            assert float(end[kept].max()) <= 2e-2, (tag, mode, float(end[kept].max()))
            assert all(bool(torch.isfinite(getattr(got, f).float()).all()) for f in got._fields)
            report[mode] = dict(lanes_parted=int(parted.sum()), share_parted=share,
                                max_abs_diff_kept=float(worst[:, kept].max()),
                                terminals=int(got.terminals.sum()),
                                truncates=int(got.truncates.sum()))
            if mode == 'injected':
                inj_trace = trace
        f_all = torch.cat([f for f, _ in inj_trace], dim=1).contiguous()
        i_all = torch.cat([i for _, i in inj_trace], dim=1).contiguous()
        nz_all = nz.transpose(0, 1).reshape(1, nz.shape[1], h * n).contiguous()
        got = fr.offpolicy_rollout(flat, f_all, i_all, horizon_len=1, noise=nz_all, **kw)
        want = fr.offpolicy_rollout_reference(flat, f_all, i_all, horizon_len=1, noise=nz_all,
                                              **kw)
        torch.cuda.synchronize()
        flip, _ = k6_fields_differ(got, want, float('inf'))
        flip = (flip[0] | (got.env_i != want.env_i).any(0)
                | ((got.env_f - want.env_f).abs().amax(0) > 0.25))
        n_flip = int(flip.sum())
        assert n_flip <= 8, (tag, n_flip)
        one = {}
        for f in got._fields:
            a, b = getattr(got, f), getattr(want, f)
            if a.dtype.is_floating_point:
                d = (a - b).abs()
                one[f] = float((d[:, ~flip] if f == 'env_f' else d[0][~flip]).max())
        assert all(v <= 1e-4 for v in one.values()), (tag, one)
        ms = cuda_ms_(lambda: fr.offpolicy_rollout(flat, f0, i0, horizon_len=h, seed=seed, **kw),
                      reps=20, warmup=2)
        plain_ms = cuda_ms_(lambda: fr.offpolicy_rollout_reference(flat, f0, i0, horizon_len=h,
                                                                   seed=seed, **kw), reps=2)
        b_ms, b_by = k6_bound(body, head, n, h, flat.numel())
        emit(phase='k6_vs_plain', kernel=tag, envs=n, horizon=h, trajectory=report,
             one_step=one, one_step_threshold_flips=n_flip, ms=ms, plain_ms=plain_ms,
             bound_ms=b_ms, bound_by=b_by,
             tolerance={'trajectory': 2e-2, 'lanes_parted': max(1, int(0.01 * n)),
                        'one_step': 1e-4, 'threshold_flips': 8})
        k6[(env_name, head)] = dict(name=tag, ms=ms, plain_ms=plain_ms,
                                    max_abs_err=max(one.values()), bound_ms=b_ms, bound_by=b_by)

    # the DQN heads' exploration: with zero weights and the bias favouring
    # action 0, an action other than 0 comes only from exploring; over
    # 1,048,576 Philox draws the exploring share is within 0.01 of
    # explore_rate and each action's frequency within 0.005 of its share
    explore = {}
    for env_name in ('CartPole-v1', 'PointChasingDiscreteEnv'):
        body = fr.KERNEL_ENV_BODIES[env_name]
        A = body.action_dim
        n_w = sum(math.prod(x) for x in fr.offpolicy_head_shapes(body.state_dim, OFF_NET, A,
                                                                  'dqn'))
        flat = torch.zeros(n_w, device=dev)
        flat[n_w - A] = 1.0                                   # bo[0]: greedy action 0
        n, h = 16384, 64
        f0 = torch.zeros((body.n_f32, n), device=dev)
        if body is fr.CHASING_DISCRETE_BODY:
            f0[4:6], f0[8] = -16.0, 22.6
        out = fr.offpolicy_rollout(flat, f0, torch.zeros((1, n), dtype=torch.int32, device=dev),
                                   body=body, head='dqn', net_dims=OFF_NET, horizon_len=h,
                                   reward_scale=1.0, explore_rate=0.25, seed=seed)
        freq = torch.bincount(out.actions.reshape(-1).long(), minlength=A).float() / (n * h)
        share = float((1.0 - freq[0]) * A / (A - 1))
        want = torch.full((A,), 0.25 / A, device=dev)
        want[0] += 0.75
        dfreq = float((freq - want).abs().max())
        assert abs(share - 0.25) <= 0.01 and dfreq <= 0.005, (env_name, share, dfreq)
        explore[env_name] = dict(explore_share=share, max_freq_diff=dfreq)
    emit(phase='k6_exploration', draws=16384 * 64, explore_rate=0.25, heads=explore,
         bounds='share 0.01, frequency 0.005')

    # ---- k9_vs_plain and k7_vs_plain: one chunk of C = 16, the last 4 steps
    # invalid.  Tolerance: per buffer, the kernel's update (new - old) within
    # 5e-3 of the largest plain update of that buffer; objectives within 1e-3
    # relative on the valid steps (16 steps of f32 rounding in another order);
    # the invalid steps leave every buffer bit-identical (the same chunk
    # without them, on the card).
    C, VALID = 16, 12

    def chunk_check(fn, ref, base, blocks, bcv_of, hyper, shapes):
        runs = {}
        for f in (fn, ref):
            bufs = [b.clone() for b in base]
            objs = f(*bufs, *blocks, bcv_of(VALID), **hyper)
            torch.cuda.synchronize()
            runs[f.__name__] = (bufs, objs)
        (kb, ko), (pb, po) = runs[fn.__name__], runs[ref.__name__]
        rel = [float(((k - b) - (p - b)).abs().max() / (p - b).abs().max().clamp_min(1e-30))
               for k, p, b in zip(kb, pb, base)]
        leaf_rel = [[float((dk - dp).abs().max() / dp.abs().max().clamp_min(1e-30))
                     for dk, dp in zip(split_flat(k - b, sh), split_flat(p - b, sh))]
                    for k, p, b, sh in zip(kb, pb, base, shapes)]
        err = max(float(((k - b) - (p - b)).abs().max()) for k, p, b in zip(kb, pb, base))
        obj_rel = float(((ko - po).abs() / po.abs().clamp_min(1e-6))[:VALID].max())
        short = [b.clone() for b in base]
        fn(*short, *[x[:VALID] for x in blocks], bcv_of(VALID)[:VALID], **hyper)
        torch.cuda.synchronize()
        identical = all(torch.equal(a, b) for a, b in zip(short, kb))
        assert all(r <= 5e-3 for r in rel), rel
        assert obj_rel <= 1e-3, obj_rel
        assert identical
        bufs = [b.clone() for b in base]
        ms = cuda_ms_(lambda: fn(*bufs, *blocks, bcv_of(C), **hyper), reps=10, warmup=2)
        plain = cuda_ms_(lambda: ref(*bufs, *blocks, bcv_of(C), **hyper), reps=2)
        return dict(rel_update_diff=rel, leaf_rel_update_diff=leaf_rel, max_abs_err=err,
                    objective_rel_diff=obj_rel,
                    invalid_steps_bit_identical=identical, ms=ms, plain_ms=plain)

    def warm_buffers(gen, n, count):
        p = torch.randn(n, generator=gen, device=dev) * 0.05
        return [p, p + 0.01 * torch.randn(n, generator=gen, device=dev),
                1e-3 * torch.randn(n, generator=gen, device=dev),
                1e-6 * torch.rand(n, generator=gen, device=dev)][:count]

    def runs_and_trace(fn, base, blocks, bcv, hyper, n_phases):
        """One cooperative launch a chunk: two runs of it bitwise equal (the
        second traced), and block 0's phase stamps."""
        runs, trace = [], torch.zeros((C, n_phases + 1), dtype=torch.int64, device=dev)
        for tr in (None, trace):
            bufs = [None if b is None else b.clone() for b in base]
            objs = fn(*bufs, *blocks, bcv, **hyper, trace=tr)
            torch.cuda.synchronize()
            runs.append([b for b in bufs if b is not None]
                        + list(objs if isinstance(objs, tuple) else (objs,)))
        return all(torch.equal(a, b) for a, b in zip(*runs)), trace

    def k9_check(S, A, B, net, twin, duel, phase):
        """K9 against its plain version for one variant at (S, A, B, net)."""
        n1, n2 = net
        variant = fo.dqn_variant(twin, duel)
        g = torch.Generator(device=dev).manual_seed(41)
        P = sum(math.prod(x) for x in dqn_param_shapes(S, net, A, twin, duel))
        base = warm_buffers(g, P, 4)
        index = torch.randint(0, A, (C, B), generator=g, device=dev)
        blocks = [torch.randn((C, S, B), generator=g, device=dev),
                  torch.randn((C, S, B), generator=g, device=dev),
                  torch.nn.functional.one_hot(index, A).float().transpose(1, 2).contiguous(),
                  torch.randn((C, B), generator=g, device=dev),
                  (torch.rand((C, B), generator=g, device=dev) > 0.05).float(),
                  (torch.rand((C, B), generator=g, device=dev) > 0.02).float()]
        idx = torch.arange(C, device=dev)
        hyper = dict(net_dims=net, twin=twin, duel=duel, gamma=0.99, tau=5e-3, lr=1e-3,
                     clip_grad=3.0)
        res = chunk_check(fo.dqn_chunk, fo.dqn_chunk_reference, base, blocks,
                          lambda valid: fo.dqn_bcv(5, idx, valid), hyper,
                          [dqn_param_shapes(S, net, A, twin, duel)] * 4)
        det, trace = runs_and_trace(fo.dqn_chunk, base, blocks, fo.dqn_bcv(5, idx, C), hyper,
                                    len(fo.DQN_PHASES))
        assert det, ('K9: two runs differ', variant, net)
        res.update(two_runs_bitwise_equal=det, launches_per_chunk=1,
                   phase_ms=fo.dqn_phase_ms(trace))
        nh = A * (1 + twin) + (1 + twin) * duel
        fwd = 2 * B * (S * n1 + n1 * n2 + n2 * nh)
        b_ms, b_by = bound(4 * fwd * C, 4 * (8 * P + C * B * (2 * S + A + 3) + 3 * C + 2 * C))
        res.update(bound_ms=b_ms, bound_by=b_by)
        emit(phase=phase, variant=variant, C=C, valid=VALID, B=B, S=S, A=A, net_dims=net,
             **res, tolerance={'update': 5e-3, 'objectives': 1e-3})
        return variant, res

    k9 = dict(k9_check(4, 2, PATH_B['batch'], OFF_NET, twin, duel, 'k9_vs_plain')
              for twin, duel in ((False, False), (True, False), (False, True), (True, True)))
    # dqn_lunarlander's and d3qn_lunarlander's chunk: (256, 256), B = 256, S = 8, A = 4
    k9_lunar = dict(k9_check(8, 4, 256, (256, 256), twin, duel, 'k9_vs_plain_lunar')
                    for twin, duel in ((False, False), (True, True)))

    def k7_check(S, A, B, net, td3, E, phase):
        """K7 against its plain version, one variant at (S, A, B, net, E)."""
        n1, n2 = net
        variant = 'td3' if td3 else 'ddpg'
        g = torch.Generator(device=dev).manual_seed(43)
        act_shapes, cri_shapes = ddpg_param_shapes(S, net, A, E)
        Pa, Pc = (sum(math.prod(x) for x in sh) for sh in (act_shapes, cri_shapes))
        pa, ta, mua, nua = warm_buffers(g, Pa, 4)
        pc, tc, muc, nuc = warm_buffers(g, Pc, 4)
        base = [pa, pc, ta, tc, mua, muc, nua, nuc]
        blocks = [torch.randn((C, S, B), generator=g, device=dev),
                  torch.randn((C, S, B), generator=g, device=dev),
                  torch.rand((C, A, B), generator=g, device=dev) * 2 - 1,
                  torch.randn((C, B), generator=g, device=dev),
                  (torch.rand((C, B), generator=g, device=dev) > 0.05).float(),
                  (torch.rand((C, B), generator=g, device=dev) > 0.02).float(),
                  0.1 * torch.randn((C, A, B), generator=g, device=dev)]
        idx = torch.arange(C, device=dev)
        bcv_of = lambda valid: fo.ddpg_bcv(9, 4, idx, valid, idx % 2 == 0,  # noqa: E731
                                           (idx + 1) // 2 + 1)
        hyper = dict(net_dims=net, td3=td3, num_ensembles=E, gamma=0.99, tau=5e-3, lr=3e-4,
                     clip_grad=3.0)
        res = chunk_check(fo.ddpg_chunk, fo.ddpg_chunk_reference, base, blocks, bcv_of, hyper,
                          [act_shapes, cri_shapes] * 4)
        det, trace = runs_and_trace(fo.ddpg_chunk, base, blocks, bcv_of(C), hyper,
                                    len(fo.DDPG_PHASES))
        assert det, ('K7: two runs differ', variant, net)
        res.update(two_runs_bitwise_equal=det, launches_per_chunk=1,
                   phase_ms=fo.ddpg_phase_ms(trace))
        f_a = 2 * B * (S * n1 + n1 * n2 + n2 * A)
        f_c = 2 * B * ((S + A) * n1 + n1 * n2 + n2 * E)
        b_ms, b_by = bound((4 * f_a + 5 * f_c) * C,
                           4 * (8 * (Pa + Pc) + C * B * (2 * S + 2 * A + 3) + 7 * C + 2 * C))
        res.update(bound_ms=b_ms, bound_by=b_by)
        emit(phase=phase, variant=variant, E=E, C=C, valid=VALID, B=B, S=S, A=A, net_dims=net,
             do_act='alternating', **res, tolerance={'update': 5e-3, 'objectives': 1e-3})
        return variant, res

    k7 = dict(k7_check(6, 2, PATH_A['batch'], OFF_NET, td3, 8 if td3 else 1, 'k7_vs_plain')
              for td3 in (False, True))
    # ---- k7_vs_plain_wide: the workloads the JAX package sends to its chunk
    # that the port raised on before the persistent design (shared memory
    # grew with the widths): TD3 (E = 8) at (256, 256) with B = 512, DDPG at
    # (1024, 1024) with B = 128
    for net, B_, td3 in (((256, 256), 512, True), ((1024, 1024), 128, False)):
        k7_check(6, 2, B_, net, td3, 8 if td3 else 1, 'k7_vs_plain_wide')

    # ---- k7per_vs_plain: K7', the PER variant of the DDPG/TD3 chunk, against
    # its plain version at path A's shapes, TD3 (E = 8) and DDPG (E = 1), the
    # last 4 steps invalid; the blocks and the importance weights are a real
    # PER draw (ReplayBuffer.per_ids, as sample_for_per draws) from a filled
    # ring of 1024 envs x 64 rows with priorities 0.5 ... 7.5.  Tolerances as
    # k7_vs_plain; the per-sample TD errors of every step within 1e-5 of the
    # largest plain |td|; the invalid steps leave every buffer bit-identical.
    k7per = {}
    S, A, B, NE = 6, 2, PATH_A['batch'], PATH_A['envs']
    g = torch.Generator(device=dev).manual_seed(53)
    prb = ReplayBuffer(64, S, A, num_seqs=NE, if_use_per=True, device=dev)
    pbuf = prb.update(prb.init(), (
        torch.randn((64, NE, S), generator=g, device=dev),
        torch.rand((64, NE, A), generator=g, device=dev) * 2 - 1,
        torch.randn((64, NE), generator=g, device=dev),
        (torch.rand((64, NE), generator=g, device=dev) > 0.05).float(),
        (torch.rand((64, NE), generator=g, device=dev) > 0.02).float()))
    prb.tree.update(pbuf.per_tree, torch.arange(64, device=dev),
                    torch.randint(1, 16, (64, NE), generator=g, device=dev) * 0.5)
    ids0, ids1, iw = prb.per_ids(pbuf, B, torch.rand((C, NE, B // NE), generator=g, device=dev))
    x_, a_, r_, ud_, um_, nx_, _ = prb.gather(pbuf, ids0, ids1)
    per_blocks = [x_.transpose(1, 2).contiguous(), nx_.transpose(1, 2).contiguous(),
                  a_.transpose(1, 2).contiguous(), r_.contiguous(), ud_.contiguous(),
                  um_.contiguous(), 0.1 * torch.randn((C, A, B), generator=g, device=dev)]
    iw = iw.contiguous()
    for td3 in (False, True):
        variant = 'td3_per' if td3 else 'ddpg_per'
        E = 8 if td3 else 1
        act_shapes, cri_shapes = ddpg_param_shapes(S, OFF_NET, A, E)
        Pa, Pc = (sum(math.prod(x) for x in sh) for sh in (act_shapes, cri_shapes))
        pa, ta, mua, nua = warm_buffers(g, Pa, 4)
        pc, tc, muc, nuc = warm_buffers(g, Pc, 4)
        base = [pa, pc, ta, tc, mua, muc, nua, nuc]
        idx = torch.arange(C, device=dev)
        bcv_of = lambda valid: fo.ddpg_bcv(9, 4, idx, valid, idx % 2 == 0,  # noqa: E731
                                           (idx + 1) // 2 + 1)
        hyper = dict(net_dims=OFF_NET, td3=td3, num_ensembles=E, gamma=0.99, tau=5e-3, lr=3e-4,
                     clip_grad=3.0, iw=iw)
        runs = {}
        for fn in (fo.ddpg_chunk, fo.ddpg_chunk_reference):
            bufs = [b.clone() for b in base]
            objs, td = fn(*bufs, *per_blocks, bcv_of(VALID), **hyper)
            torch.cuda.synchronize()
            runs[fn.__name__] = (bufs, objs, td)
        (kb, ko, kt), (pb, po, pt) = runs['ddpg_chunk'], runs['ddpg_chunk_reference']
        rel = [float(((k - b) - (p - b)).abs().max() / (p - b).abs().max().clamp_min(1e-30))
               for k, p, b in zip(kb, pb, base)]
        err = max(float(((k - b) - (p - b)).abs().max()) for k, p, b in zip(kb, pb, base))
        obj_rel = float(((ko - po).abs() / po.abs().clamp_min(1e-6))[:VALID].max())
        td_rel = float((kt - pt).abs().max() / pt.abs().max())
        short = [b.clone() for b in base]
        fo.ddpg_chunk(*short, *[x[:VALID] for x in per_blocks], bcv_of(VALID)[:VALID],
                      **dict(hyper, iw=iw[:VALID].contiguous()))
        torch.cuda.synchronize()
        identical = all(torch.equal(a, b) for a, b in zip(short, kb))
        det, trace = runs_and_trace(fo.ddpg_chunk, base, per_blocks, bcv_of(C), hyper,
                                    len(fo.DDPG_PHASES))
        assert all(r <= 5e-3 for r in rel), (variant, rel)
        assert obj_rel <= 1e-3, (variant, obj_rel)
        assert td_rel <= 1e-5, (variant, td_rel)
        assert identical, variant
        assert det, ('K7\': two runs differ', variant)
        bufs = [b.clone() for b in base]
        ms = cuda_ms_(lambda: fo.ddpg_chunk(*bufs, *per_blocks, bcv_of(C), **hyper), reps=10,
                      warmup=2)
        plain = cuda_ms_(lambda: fo.ddpg_chunk_reference(*bufs, *per_blocks, bcv_of(C), **hyper),
                         reps=2)
        f_a = 2 * B * (S * D1 + D1 * D2 + D2 * A)
        f_c = 2 * B * ((S + A) * D1 + D1 * D2 + D2 * E)
        # K7's operations and bytes, plus the importance weights in and the
        # TD errors out
        b_ms, b_by = bound((4 * f_a + 5 * f_c) * C,
                           4 * (8 * (Pa + Pc) + C * B * (2 * S + 2 * A + 3) + 7 * C + 2 * C
                                + 2 * C * B))
        res = dict(rel_update_diff=rel, max_abs_err=max(err, float((kt - pt).abs().max())),
                   objective_rel_diff=obj_rel, td_rel_diff=td_rel,
                   invalid_steps_bit_identical=identical, two_runs_bitwise_equal=det,
                   launches_per_chunk=1, phase_ms=fo.ddpg_phase_ms(trace), ms=ms, plain_ms=plain,
                   bound_ms=b_ms, bound_by=b_by)
        emit(phase='k7per_vs_plain', variant=variant, E=E, C=C, valid=VALID, B=B, S=S, A=A,
             iw_from=f'ReplayBuffer.per_ids on a filled ring of {NE} envs x 64 rows',
             iw_range=[float(iw.min()), float(iw.max())], do_act='alternating', **res,
             tolerance={'update': 5e-3, 'objectives': 1e-3, 'td': 1e-5})
        k7per[variant] = res

    # ---- k8_vs_plain: SAC (E = 4) and ModSAC (E = 8) at path C's shapes, one
    # chunk from update 0 (ModSAC's gate skips some steps), the last 4 steps
    # invalid.  Tolerances as k7: buffers, leaves and the temperature's state
    # within 5e-3 of the largest plain update, objectives 1e-3 relative on
    # the valid steps; the counts and the gate column exactly; the invalid
    # steps leave every buffer bit-identical.
    k8 = {}
    S, A, B = 6, 2, PATH_C['batch']
    for modsac, E in ((False, 4), (True, 8)):
        variant = 'modsac' if modsac else 'sac'
        g = torch.Generator(device=dev).manual_seed(47)
        act_shapes, cri_shapes = sac_act_shapes(S, OFF_NET, A, modsac), sac_cri_shapes(
            S, A, OFF_NET, E)
        Pa, Pc = (sum(math.prod(x) for x in sh) for sh in (act_shapes, cri_shapes))
        pa, ta, mua, nua = warm_buffers(g, Pa, 4)
        pc, tc, muc, nuc = warm_buffers(g, Pc, 4)
        misc = torch.tensor([-1.0, 1e-3, 1e-6, 9.0, 5.0], device=dev)
        base = [pa, pc, ta if modsac else None, tc, mua, muc, nua, nuc, misc]
        blocks = [torch.randn((C, S, B), generator=g, device=dev),
                  torch.randn((C, S, B), generator=g, device=dev),
                  torch.rand((C, A, B), generator=g, device=dev) * 2 - 1,
                  torch.randn((C, B), generator=g, device=dev),
                  (torch.rand((C, B), generator=g, device=dev) > 0.05).float(),
                  (torch.rand((C, B), generator=g, device=dev) > 0.02).float(),
                  torch.randn((C, A, B), generator=g, device=dev),
                  torch.randn((C, A, B), generator=g, device=dev)]
        idx = torch.arange(C, device=dev)
        hyper = dict(net_dims=OFF_NET, modsac=modsac, num_ensembles=E, gamma=0.99, tau=5e-3,
                     lr=3e-4, clip_grad=3.0,
                     target_entropy=-math.log(A) if modsac else math.log(A),
                     std_clip=std_clip('modsac' if modsac else 'sac'))
        runs = {}
        for fn in (fo.sac_chunk, fo.sac_chunk_reference):
            bufs = [None if b is None else b.clone() for b in base]
            objs = fn(*bufs, *blocks, fo.sac_bcv(9, 9, idx, VALID), **hyper)
            torch.cuda.synchronize()
            runs[fn.__name__] = (bufs, objs)
        (kb, ko), (pb, po) = runs['sac_chunk'], runs['sac_chunk_reference']
        pairs = [(k, p, b, sh) for k, p, b, sh in zip(kb, pb, base, [act_shapes, cri_shapes] * 4)
                 if b is not None]
        rel = [float(((k - b) - (p - b)).abs().max() / (p - b).abs().max().clamp_min(1e-30))
               for k, p, b, _ in pairs]
        leaf_rel = [[float((dk - dp).abs().max() / dp.abs().max().clamp_min(1e-30))
                     for dk, dp in zip(split_flat(k - b, sh), split_flat(p - b, sh))]
                    for k, p, b, sh in pairs]
        err = max(float(((k - b) - (p - b)).abs().max()) for k, p, b, _ in pairs)
        dm = (kb[8] - misc)[:3] - (pb[8] - misc)[:3]
        temp_rel = [float(dm[i].abs() / (pb[8][i] - misc[i]).abs().clamp_min(1e-30))
                    for i in range(3)]
        obj_rel = float(((ko - po).abs() / po.abs().clamp_min(1e-6))[:VALID, :2].max())
        counts = dict(kernel=kb[8][3:].tolist(), plain=pb[8][3:].tolist())
        gate = ko[:, 2].tolist()
        short = [None if b is None else b.clone() for b in base]
        fo.sac_chunk(*short, *[x[:VALID] for x in blocks], fo.sac_bcv(9, 9, idx, VALID)[:VALID],
                     **hyper)
        torch.cuda.synchronize()
        identical = all(torch.equal(a, b) for a, b in zip(short, kb) if a is not None)
        det, trace = runs_and_trace(fo.sac_chunk, base, blocks, fo.sac_bcv(9, 9, idx, C), hyper,
                                    len(fo.SAC_PHASES))
        assert det, ('K8: two runs differ', variant)
        assert all(r <= 5e-3 for r in rel + temp_rel), (variant, rel, temp_rel)
        assert obj_rel <= 1e-3, (variant, obj_rel)
        assert counts['kernel'] == counts['plain'] and torch.equal(ko[:, 2], po[:, 2]), (
            variant, counts, gate, po[:, 2].tolist())
        assert (0.0 in gate[:VALID]) == modsac and gate[VALID:] == [0.0] * (C - VALID), gate
        assert identical
        bufs = [None if b is None else b.clone() for b in base]
        bcv_c = fo.sac_bcv(9, 9, idx, C)
        ms = cuda_ms_(lambda: fo.sac_chunk(*bufs, *blocks, bcv_c, **hyper), reps=5, warmup=1)
        plain = cuda_ms_(lambda: fo.sac_chunk_reference(*bufs, *blocks, bcv_c, **hyper), reps=1)
        # per sample: 5 actor and 6 ensemble forward-equivalents (two actor
        # forwards and the target ensemble for the label and alpha; the online
        # ensemble forward and backward; the actor forward, the fresh target
        # ensemble forward and backward to its inputs, the actor backward)
        f_a = 2 * B * (S * D1 + D1 * D2 + D2 * 2 * A)
        f_c = 2 * B * ((S + A) * D1 + E * (D1 * D2 + D2))
        b_ms, b_by = bound((5 * f_a + 6 * f_c) * C,
                           4 * (8 * (Pa + Pc) + C * B * (2 * S + 3 * A + 3) + 7 * C + 3 * C + 10))
        res = dict(rel_update_diff=rel, leaf_rel_update_diff=leaf_rel, max_abs_err=err,
                   temperature_rel_diff=temp_rel, objective_rel_diff=obj_rel, counts=counts,
                   do_act=gate, invalid_steps_bit_identical=identical,
                   two_runs_bitwise_equal=det, launches_per_chunk=1,
                   phase_ms=fo.sac_phase_ms(trace), ms=ms, plain_ms=plain, bound_ms=b_ms,
                   bound_by=b_by)
        emit(phase='k8_vs_plain', variant=variant, E=E, C=C, valid=VALID, B=B, S=S, A=A, **res,
             tolerance={'update': 5e-3, 'temperature': 5e-3, 'objectives': 1e-3})
        k8[variant] = res

    # ---- the main paths
    td3_hopper = (AgentTD3, HopperEnv, 'HopperSlip-v0', 6, 2, False, 1000)
    dqn_cartpole = (AgentDQN, CartPoleEnv, 'CartPole-v1', 4, 2, True, 500)
    sac_hopper = (AgentSAC,) + td3_hopper[1:]

    def off_args(task, num_envs, horizon, batch, repeat, buffer_size, lr, **hyper):
        agent_class, env_class, env_name, S_, A_, discrete, max_step = task
        a = Config(agent_class, env_class,
                   {'env_name': env_name, 'num_envs': num_envs, 'max_step': max_step,
                    'state_dim': S_, 'action_dim': A_, 'if_discrete': discrete})
        a.horizon_len, a.batch_size, a.repeat_times = horizon, batch, repeat
        a.buffer_size, a.learning_rate, a.net_dims, a.random_seed = buffer_size, lr, OFF_NET, 0
        for k, v in hyper.items():
            setattr(a, k, v)
        return a

    def small_round_vs_cpu(task, head, num_envs, horizon, batch, repeat, phase, **hyper):
        """A small round on the card (the rollout kernel, the update chunk)
        against the same round on the CPU (their plain versions): the same
        weights, env state, rollout noise, minibatch rows (under PER the
        stratified uniforms) and the update's noise (TD3's smoothing noise;
        SAC's next-action and policy-gradient noise).  Tolerance: objectives
        1e-3 relative, updates 2e-2 of each buffer's largest."""
        body = fr.KERNEL_ENV_BODIES[task[2]]
        A_ = body.action_dim
        g3 = torch.Generator().manual_seed(3)
        nz = k6_noise_cpu(body, head, g3, horizon, num_envs)
        U = offpolicy_update_times(horizon, repeat, batch)
        rows = (torch.rand((U, num_envs, batch // num_envs), generator=g3)
                if hyper.get('if_use_per') else
                torch.randint(0, horizon - 1, (U, batch // num_envs), generator=g3))
        unoise = {'ddpg': 0.1 * torch.randn((U, batch, A_), generator=g3),
                  'sac': torch.randn((U, 2, batch, A_), generator=g3)}.get(head)
        small, start = {}, None
        for device in ('card', 'cpu'):
            a = off_args(task, num_envs, horizon, batch, repeat, 4 * horizon, 1e-3, **hyper)
            device = str(dev) if device == 'card' else device
            a.device = device
            ctx = build_training(a)
            assert ctx.fused_rollout
            carry0 = ctx.carry
            if start is None:
                start = (ctx.agent.state_to_numpy(carry0.agent_state),
                         [x.cpu() for x in carry0.env_state])
            else:
                carry0 = carry0._replace(
                    agent_state=ctx.agent.state_from_numpy(start[0], device),
                    env_state=type(carry0.env_state)(*start[1]))
            before = [x.clone() for x in carry0.agent_state if isinstance(x, torch.Tensor)]
            c, m = ctx.round_fn(carry0, noise=nz.to(device).contiguous(), ids=rows.to(device),
                                update_noise=None if unoise is None else unoise.to(device))
            m = scalars(m)
            after = [x for x in c.agent_state if isinstance(x, torch.Tensor)]
            small[device] = ({k: float(v) for k, v in m.items()},
                             [(x - b).cpu() for x, b in zip(after, before)])
        (mg, dg), (mc, dc) = small[str(dev)], small['cpu']
        obj_rel = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-6) for k in mc}
        upd_rel = [float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
                   for x, y in zip(dg, dc)]
        assert all(r <= 1e-3 for r in obj_rel.values()), obj_rel
        assert all(r <= 2e-2 for r in upd_rel), upd_rel
        emit(phase=phase, envs=num_envs, horizon=horizon, batch=batch, updates=U,
             objective_rel_diff=obj_rel, update_rel_diff=upd_rel)

    def k6_noise_cpu(body, head, gen, h, n):
        A_, n_env = body.action_dim, body.n_step + body.n_reset
        if head in fr.CONTINUOUS_HEADS:
            return torch.cat([torch.randn((h, A_, n), generator=gen),
                              torch.rand((h, n_env, n), generator=gen)], 1)
        return torch.rand((h, 2 + n_env, n), generator=gen)

    def timed_rounds(task, head, path, phase, kernel_ms, variant=None, **hyper):
        a = off_args(task, path['envs'], path['horizon'], path['batch'], path['repeat'],
                     path['buffer'], path['lr'], **hyper)
        ctx = build_training(a)
        body = fr.KERNEL_ENV_BODIES[task[2]]
        carry, rb = ctx.carry, ctx.rb
        # fill the ring: kernel rollouts inserted without updates
        flat = carry.agent_state.act if head in fr.CONTINUOUS_HEADS else carry.agent_state.q
        f, i = (x.contiguous() for x in body.pack(carry.env_state))
        buf, fills, t0 = carry.buf_state, 0, time.time()
        while buf.size < rb.max_size:
            s_ = torch.randint(-2 ** 31, 2 ** 31 - 1, (2,), generator=carry.gen, device=dev,
                               dtype=torch.int32)
            out = fr.offpolicy_rollout(flat, f, i, body=body, head=head, net_dims=OFF_NET,
                                       horizon_len=path['horizon'], reward_scale=1.0,
                                       noise_std=0.05, explore_rate=0.25, seed=s_)
            buf = rb.update(buf, (out.states, out.actions, out.rewards, 1.0 - out.terminals,
                                  1.0 - out.truncates))
            f, i, fills = out.env_f, out.env_i, fills + 1
        torch.cuda.synchronize()
        fill_s = time.time() - t0
        U = offpolicy_update_times(buf.size, path['repeat'], path['batch'])
        assert U == path['updates'], (U, path['updates'])
        carry = carry._replace(buf_state=buf, env_state=body.unpack(f, i),
                               obs=body.obs(f, i).T)
        carry, _ = ctx.round_fn(carry)                        # warm-up round
        p0 = [x.clone() for x in carry.agent_state if isinstance(x, torch.Tensor)]
        torch.cuda.synchronize()
        reset_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = []
        for _ in range(ROUNDS):
            carry, m = ctx.round_fn(carry)
            m = scalars(m)
            metrics.append(torch.stack([m[k].float() for k in sorted(m)]))
        end.record()
        torch.cuda.synchronize()
        by_kernel, by_chunk = read_counts()
        round_ms = start.elapsed_time(end) / ROUNDS
        mvals = torch.stack(metrics).cpu()
        moved = max(float((x - y).abs().max()) for x, y in zip(
            [x for x in carry.agent_state if isinstance(x, torch.Tensor)], p0))
        chunks = -(-U // 16)
        update_counts = {k: v for k, v in by_chunk.items() if v}
        assert by_kernel == {f'{task[2]},{head}': ROUNDS}, by_kernel
        assert update_counts == {variant or CHUNK_VARIANT[head]: ROUNDS * chunks}, update_counts
        assert fr.offpolicy_rollout.launches == ROUNDS
        # K11a: one launch gathers every field of a chunk
        gathers = kn.buffer_gather_fields.launches
        assert gathers == ROUNDS * chunks, (phase, gathers, ROUNDS * chunks)
        assert bool(torch.isfinite(mvals).all()), mvals
        assert moved > 0.0
        emit(phase=phase, agent=task[0].__name__, env=task[2], envs=path['envs'],
             horizon=path['horizon'], ring_rows=rb.max_size, batch=path['batch'],
             repeat=path['repeat'], net_dims=OFF_NET, updates_per_round=U,
             ring_filled_by=f'{fills} kernel rollouts inserted without updates ({fill_s:.3f} s)',
             rounds=ROUNDS, launches={'fused_rollout': by_kernel, 'update_chunks': update_counts,
                                      'buffer_gather_fields': gathers},
             round_ms=round_ms,
             env_steps_per_s=path['envs'] * path['horizon'] / (round_ms / 1e3),
             updates_per_s=U / (round_ms / 1e3), **kernel_ms,
             metrics=dict(zip(sorted(m), mvals[-1].tolist())), max_param_change=moved,
             device=name, nvidia_smi=smi)
        return by_kernel, update_counts

    small_round_vs_cpu(td3_hopper, 'ddpg', 256, 16, 1024, 128.0, 'main_path_td3_hopper_small_vs_cpu',
                       gamma=0.99)
    launches_a = timed_rounds(td3_hopper, 'ddpg', PATH_A, 'main_path_td3_hopper', dict(
        fused_rollout_ms=k6[('HopperSlip-v0', 'ddpg')]['ms'],
        ddpg_update_ms=k7['td3']['ms'], ddpg_update_plain_ms=k7['td3']['plain_ms']), gamma=0.99)
    small_round_vs_cpu(dqn_cartpole, 'dqn', 64, 16, 128, 16.0,
                       'main_path_dqn_cartpole_small_vs_cpu')
    launches_b = timed_rounds(dqn_cartpole, 'dqn', PATH_B, 'main_path_dqn_cartpole', dict(
        fused_rollout_ms=k6[('CartPole-v1', 'dqn')]['ms'],
        dqn_update_ms=k9['dqn']['ms'], dqn_update_plain_ms=k9['dqn']['plain_ms']),
        explore_rate=0.25)
    small_round_vs_cpu(sac_hopper, 'sac', 256, 16, 1024, 128.0, 'main_path_sac_hopper_small_vs_cpu',
                       gamma=0.99)
    launches_c = timed_rounds(sac_hopper, 'sac', PATH_C, 'main_path_sac_hopper', dict(
        fused_rollout_ms=k6[('HopperSlip-v0', 'sac')]['ms'],
        sac_update_ms=k8['sac']['ms'], sac_update_plain_ms=k8['sac']['plain_ms']), gamma=0.99)

    # ---- per_tree_vs_cpu: the priority tree on the card against the CPU at
    # path D's sizes (4000 rows x 1024 sequences), on priorities that float32
    # sums exactly (0.5 ... 7.5): the insert's priority 10, a scattered update
    # of 1024 pairs, 64 of them one (seq, id) pair, a stratified sample, min_leaf,
    # then the fused path's chunk: 16 minibatches drawn at once against the
    # tree at its start (ReplayBuffer.per_ids) and the fold of 12 valid steps'
    # priorities, step by step.  Ids, leaves and sums must be equal.
    M_, N_ = PATH_D['buffer'], PATH_D['envs']
    gc = torch.Generator().manual_seed(59)
    fresh = torch.randint(1, 16, (M_, N_), generator=gc) * 0.5
    d0, d1 = torch.randint(0, M_, (N_,), generator=gc), torch.randint(0, N_, (N_,), generator=gc)
    lo, hi = N_ // 4, N_ // 4 + N_ // 16           # duplicates of pair 7 (64 at full size)
    d0[lo:hi], d1[lo:hi] = d0[7], d1[7]
    dprob = torch.randint(1, 16, (N_,), generator=gc) * 0.5
    u1, uc = torch.rand((N_, 1), generator=gc), torch.rand((C, N_, 1), generator=gc)
    fold = torch.randint(1, 16, (C, N_), generator=gc) * 0.5
    trees = []
    for where in (dev, torch.device('cpu')):
        rb_ = ReplayBuffer(M_, 1, 1, num_seqs=N_, if_use_per=True, device=where)
        t_ = rb_.tree
        tree = t_.update(t_.init(where), torch.arange(M_, device=where), fresh.to(where))
        tree = t_.update_scattered(tree, d0.to(where), d1.to(where), dprob.to(where))
        winner = float(tree[1][int(d1[7]), int(d0[7])])
        ids, prios = t_.sample(tree, 1, u1.to(where))
        mn = t_.min_leaf(tree, M_ - 7)
        buf_ = rb_.init()._replace(per_tree=tree, size=M_)
        c0, c1, cw = rb_.per_ids(buf_, N_, uc.to(where))
        for u in range(VALID):
            t_.update_scattered(tree, c0[u], c1[u], fold[u].to(where))
        trees.append([x.cpu() for x in (ids, prios, mn, c0, c1, cw, *tree)] + [winner])
    kt_, ct_ = trees
    names = ('sample_ids', 'sample_prios', 'min_leaf', 'chunk_ids0', 'chunk_ids1', 'chunk_iw',
             'sums', 'leaves')
    equal = {n: bool(torch.equal(a, b)) for n, a, b in zip(names, kt_, ct_)}
    iw_rel = float(((kt_[5] - ct_[5]).abs() / ct_[5]).max())
    assert all(v for n, v in equal.items() if n != 'chunk_iw'), equal
    assert kt_[-1] == ct_[-1] == float(dprob[hi - 1]), (kt_[-1], ct_[-1])
    assert iw_rel <= 1e-6, iw_rel
    emit(phase='per_tree_vs_cpu', rows=M_, seqs=N_, duplicates=hi - lo, chunk=C, valid=VALID,
         equal=equal, duplicate_winner=kt_[-1], last_duplicate=float(dprob[hi - 1]),
         importance_weight_rel_diff=iw_rel, tolerance={'ids, leaves, sums': 'equal',
                                                        'importance weights': 1e-6})

    # ---- path D: TD3 with prioritised replay on HopperSlip at path A's sizes,
    # through K7' (one chunk of 15 valid updates per round) and the tree's ops
    small_round_vs_cpu(td3_hopper, 'ddpg', 256, 16, 1024, 128.0,
                       'main_path_td3_per_hopper_small_vs_cpu', gamma=0.99, if_use_per=True)
    launches_d = timed_rounds(td3_hopper, 'ddpg', PATH_D, 'main_path_td3_per_hopper', dict(
        fused_rollout_ms=k6[('HopperSlip-v0', 'ddpg')]['ms'],
        ddpg_update_ms=k7per['td3_per']['ms'], ddpg_update_plain_ms=k7per['td3_per']['plain_ms'],
        tree_leaves_mb=PATH_D['envs'] * SegmentTree(PATH_D['buffer'], 1).cap * 4 / 1e6),
        variant='td3_per', gamma=0.99,
        if_use_per=True)

    # ---- no plain update on the card: the kernel-eligible batch with the
    # kernel refused raises, for TD3, DQN and SAC
    refused = {}
    for task, batch in ((td3_hopper, 1024), (dqn_cartpole, 128), (sac_hopper, 1024)):
        a = off_args(task, 256, 16, batch, 1.0, 64, 1e-3, use_fused_update=False)
        try:
            build_training(a)
            raise AssertionError(f'build_training took the plain update on the card: {task[0]}')
        except ValueError as e:
            assert str(e).startswith('use_fused_update=False'), e
            refused[task[0].__name__] = str(e)[:80]
    emit(phase='no_plain_path_on_card', offpolicy_refused=refused)

    # ---- the entry point for every off-policy agent class; SAC at batch 64
    # runs the PyTorch update, and every SAC and ModSAC rollout pair runs
    pendulum = (AgentTD3, PendulumEnv, 'Pendulum-v1', 3, 1, False, 200)
    chasing = (AgentDDPG, PointChasingVecEnv, 'PointChasingVecEnv', 8, 2, False, 1024)
    cart = (None, CartPoleEnv, 'CartPole-v1', 4, 2, True, 500)
    chasing_disc = (None, PointChasingDiscreteEnv, 'PointChasingDiscreteEnv', 8, 9, True, 1024)
    runs = [(pendulum, 128), (chasing, 128), ((AgentDQN,) + cart[1:], 64),
            ((AgentDQN,) + chasing_disc[1:], 128), ((AgentDoubleDQN,) + cart[1:], 128),
            ((AgentDoubleDQN,) + chasing_disc[1:], 128), ((AgentDuelingDQN,) + cart[1:], 128),
            ((AgentD3QN,) + chasing_disc[1:], 128),
            ((AgentSAC,) + pendulum[1:], 64), ((AgentSAC,) + td3_hopper[1:], 128),
            ((AgentSAC,) + chasing[1:], 128), ((AgentModSAC,) + pendulum[1:], 128),
            ((AgentModSAC,) + td3_hopper[1:], 128), ((AgentModSAC,) + chasing[1:], 128)]
    entry_rollout, entry_update = {}, {}
    for task, batch in runs:
        with tempfile.TemporaryDirectory() as cwd:
            a = off_args(task, 128, 32, batch, 1.0, 4096, 1e-3, cwd=cwd, eval_times=2)
            a.eval_per_step = 128 * 32 * 2
            a.break_step = a.eval_per_step
            reset_counts()
            text = io.StringIO()
            t0 = time.time()
            with contextlib.redirect_stdout(text):
                res = train_agent(a)
            by_kernel, by_chunk = read_counts()
            pytorch_update = 'use_fused_update: PyTorch path' in text.getvalue()
            assert res['recorder'].shape[0] == 2 and math.isfinite(res['max_r'])
            assert pytorch_update == (batch == 64), (task[0].__name__, batch)
            assert (sum(by_chunk.values()) == 0) == (batch == 64), (task[0].__name__, by_chunk)
            assert sum(by_kernel.values()) > 0, (task[0].__name__, by_kernel)
            for k, v in by_kernel.items():
                entry_rollout[k] = entry_rollout.get(k, 0) + v
            for k, v in by_chunk.items():
                entry_update[k] = entry_update.get(k, 0) + v
            emit(phase='train_agent', agent=task[0].__name__, env=task[2], envs=128, batch=batch,
                 evaluations=int(res['recorder'].shape[0]), total_step=int(res['total_step']),
                 max_r=float(res['max_r']), seconds=round(time.time() - t0, 3),
                 update_path='pytorch (the JAX package runs this batch as XLA ops)'
                 if pytorch_update else 'kernel', rollout_launches=by_kernel,
                 update_chunks={k: v for k, v in by_chunk.items() if v})

    # ---- the entry point for this slice's switches and agents: TD3 and DDPG
    # with PER at td3_pendulum_per's shape (8 envs, (64, 64), batch 256, K7'),
    # DQN and SAC with PER and TD3 with lambda_fit_cum_r (PyTorch updates, as
    # the JAX package runs them), EmbedDQN and EnsembleDQN (PyTorch rollout
    # and update), the five H-term agents (off-policy: the rollout kernel's
    # heads and a PyTorch update; PPO-H: PyTorch rollout and update); then
    # an if_save_buffer run and a continue_train that resumes its carry with
    # the PER tree as saved
    pend64 = dict(net_dims=(64, 64), gamma=0.97)
    ppo_pend = (AgentPPOHterm,) + pendulum[1:]
    slice_runs = [
        ((AgentTD3,) + pendulum[1:], 8, 100, 256, dict(if_use_per=True, **pend64), 'td3_per'),
        ((AgentDDPG,) + pendulum[1:], 8, 100, 256, dict(if_use_per=True, **pend64), 'ddpg_per'),
        ((AgentDQN,) + cart[1:], 128, 32, 128, dict(if_use_per=True), None),
        ((AgentSAC,) + pendulum[1:], 8, 100, 256, dict(if_use_per=True, **pend64), None),
        (td3_hopper, 128, 32, 128, dict(lambda_fit_cum_r=0.1), None),
        ((AgentEmbedDQN,) + cart[1:], 128, 32, 128, {}, None),
        ((AgentEnsembleDQN,) + cart[1:], 128, 32, 128, {}, None),
        ((AgentDDPGHterm,) + td3_hopper[1:], 128, 32, 128, {}, None),
        ((AgentTD3Hterm,) + td3_hopper[1:], 128, 32, 128, {}, None),
        ((AgentSACHterm,) + td3_hopper[1:], 128, 32, 128, {}, None),
        ((AgentModSACHterm,) + td3_hopper[1:], 128, 32, 128, {}, None),
        (ppo_pend, 128, 32, 128, {}, None)]
    slice_update = {}
    for task, envs_, horizon_, batch, hyper, variant in slice_runs:
        with tempfile.TemporaryDirectory() as cwd:
            a = off_args(task, envs_, horizon_, batch, 1.0, 4096, 1e-3, cwd=cwd, eval_times=2,
                         **hyper)
            a.eval_per_step = envs_ * horizon_ * 2
            a.break_step = a.eval_per_step
            reset_counts()
            text = io.StringIO()
            t0 = time.time()
            with contextlib.redirect_stdout(text):
                res = train_agent(a)
            by_kernel, by_chunk = read_counts()
            out = text.getvalue()
            name_ = task[0].__name__
            kernel_rollout = name_ not in ('AgentEmbedDQN', 'AgentEnsembleDQN', 'AgentPPOHterm')
            assert res['recorder'].shape[0] == 2 and math.isfinite(res['max_r']), name_
            assert (sum(by_kernel.values()) > 0) == kernel_rollout, (name_, by_kernel)
            assert ('use_fused_rollout: PyTorch path' in out) != kernel_rollout, name_
            if variant is None:
                assert sum(by_chunk.values()) == 0, (name_, by_chunk)
                assert 'use_fused_update: PyTorch path' in out, name_
            else:
                assert by_chunk[variant] > 0 and sum(by_chunk.values()) == by_chunk[variant], (
                    name_, by_chunk)
            for k, v in by_chunk.items():
                slice_update[k] = slice_update.get(k, 0) + v
            emit(phase='train_agent', agent=name_, env=task[2], envs=envs_, batch=batch,
                 switches={k: v for k, v in hyper.items() if k != 'net_dims'},
                 net_dims=hyper.get('net_dims', OFF_NET),
                 evaluations=int(res['recorder'].shape[0]), total_step=int(res['total_step']),
                 max_r=float(res['max_r']), seconds=round(time.time() - t0, 3),
                 rollout_path='kernel' if kernel_rollout else 'pytorch (said so)',
                 update_path=variant or 'pytorch (said so)', rollout_launches=by_kernel,
                 update_chunks={k: v for k, v in by_chunk.items() if v})

    with tempfile.TemporaryDirectory() as cwd:
        def resumable(resume):
            a = off_args((AgentTD3,) + pendulum[1:], 8, 100, 256, 1.0, 4096, 1e-3, cwd=cwd,
                         eval_times=1, if_use_per=True, if_save_buffer=True,
                         continue_train=resume, **pend64)
            a.eval_per_step = a.break_step = 800
            return a
        with contextlib.redirect_stdout(io.StringIO()):
            train_agent(resumable(False))
        with np.load(f'{cwd}/replay_buffer.npz') as d:
            saved_leaves, saved_size = d['per_leaves'], int(d['size'])
        with contextlib.redirect_stdout(io.StringIO()):
            ctx = build_training(resumable(True))
        buf = ctx.carry.buf_state
        resumed = ctx.rb.tree.leaves(buf.per_tree).cpu().numpy()
        assert buf.size == saved_size and np.array_equal(resumed, saved_leaves)
        assert np.any(saved_leaves[:, :saved_size] != 10.0)
        emit(phase='save_buffer_and_resume', agent='AgentTD3', if_use_per=True, rows=saved_size,
             per_tree_resumed_unchanged=True)

    # ---- the kernels line's entries
    kernels = []
    main_rollouts = {**launches_a[0], **launches_b[0], **launches_c[0]}
    for (env_name, head), k in k6.items():
        tag = f'{env_name},{head}'
        main = main_rollouts.get(tag)
        kernels.append({'name': k['name'], 'route': 'cuda', 'source': rollout_src,
                        'replaces': ('elegantrl_tpu/ops/pallas_rollout.py:1060'
                                     if head in ('sac', 'modsac')
                                     else 'elegantrl_tpu/ops/pallas_rollout.py:1006'),
                        'launches': main if main else entry_rollout.get(tag, 0),
                        'max_abs_err': k['max_abs_err'], 'ms': k['ms'],
                        'plain_ms': k['plain_ms'], 'bound_ms': k['bound_ms'],
                        'bound_by': k['bound_by'], 'library_ms': None})
    for variant, k in k9.items():
        n = launches_b[1].get(variant, 0) or entry_update.get(variant, 0)
        kernels.append({'name': f'dqn_update[{variant}]', 'route': 'cuda',
                        'source': 'elegantrl_tpu_torch/ops/csrc/dqn_update.cu',
                        'replaces': 'elegantrl_tpu/ops/pallas_update.py:387', 'launches': n,
                        'max_abs_err': k['max_abs_err'], 'ms': k['ms'], 'plain_ms': k['plain_ms'],
                        'bound_ms': k['bound_ms'], 'bound_by': k['bound_by'],
                        'library_ms': None})
    for variant, k in k7.items():
        n = launches_a[1].get(variant, 0) or entry_update.get(variant, 0)
        kernels.append({'name': f'ddpg_update[{variant}]', 'route': 'cuda',
                        'source': 'elegantrl_tpu_torch/ops/csrc/ddpg_update.cu',
                        'replaces': 'elegantrl_tpu/ops/pallas_update.py:585', 'launches': n,
                        'max_abs_err': k['max_abs_err'], 'ms': k['ms'], 'plain_ms': k['plain_ms'],
                        'bound_ms': k['bound_ms'], 'bound_by': k['bound_by'],
                        'library_ms': None})
    for variant, k in k7per.items():
        n = launches_d[1].get(variant, 0) or slice_update.get(variant, 0)
        kernels.append({'name': f'ddpg_update[{variant}]', 'route': 'cuda',
                        'source': 'elegantrl_tpu_torch/ops/csrc/ddpg_update.cu',
                        'replaces': 'elegantrl_tpu/ops/pallas_update.py:585', 'launches': n,
                        'max_abs_err': k['max_abs_err'], 'ms': k['ms'], 'plain_ms': k['plain_ms'],
                        'bound_ms': k['bound_ms'], 'bound_by': k['bound_by'],
                        'library_ms': None})
    for variant, k in k8.items():
        n = launches_c[1].get(variant, 0) or entry_update.get(variant, 0)
        kernels.append({'name': f'sac_update[{variant}]', 'route': 'cuda',
                        'source': 'elegantrl_tpu_torch/ops/csrc/sac_update.cu',
                        'replaces': 'elegantrl_tpu/ops/pallas_update.py:800', 'launches': n,
                        'max_abs_err': k['max_abs_err'], 'ms': k['ms'], 'plain_ms': k['plain_ms'],
                        'bound_ms': k['bound_ms'], 'bound_by': k['bound_by'],
                        'library_ms': None})
    return kernels, k9_lunar


# ------------------------------------------------------------- StockTrading

STOCK_NET = (128, 128)
# the ppo_stock and ppo_stock_4k recipes (scripts/torch_verify_learning.py)
PPO_STOCK = dict(envs=256, horizon=128, batch=512, repeat=8.0, lr=2e-4)
PPO_STOCK_4K = dict(envs=4096, horizon=128, batch=4096, repeat=64.0, lr=2e-4)
# the off-policy heads on the stock body at path A's envs and horizon
STOCK_OFF = dict(envs=1024, horizon=32)


def stock_phases(torch, dev, name, smi, bound, seed, k2_stock):
    """The StockTradingEnv-v2 phases (K4: the stock body of both rollout
    kernels); returns their entries of the kernels line, K2's at the stock
    widths (``k2_stock``, checked in main) among them."""
    import contextlib
    import io
    import numpy as np
    from elegantrl_tpu_torch import Config, build_training, train_agent
    from elegantrl_tpu_torch.agents import AgentModSAC, AgentPPO, AgentSAC, AgentTD3
    from elegantrl_tpu_torch.agents.ppo import make_ppo
    from elegantrl_tpu_torch.envs import StockTradingVecEnv
    from elegantrl_tpu_torch.ops import fused_offpolicy_update as fo, fused_rollout as fr
    from elegantrl_tpu_torch.ops.fused_update import ppo_update
    from elegantrl_tpu_torch.ops.nets import init_flat
    from elegantrl_tpu_torch.utils.jax_params import ppo_state_from_numpy, ppo_state_to_numpy

    env_def = StockTradingVecEnv(num_envs=1)._def
    body = env_def.kernel_body
    S, A, NR = body.state_dim, body.action_dim, body.n_reset
    T = body.tables.close.shape[0]
    D1, D2 = STOCK_NET
    src = 'elegantrl_tpu_torch/ops/csrc/fused_rollout.cu'
    task = (AgentPPO, StockTradingVecEnv, 'StockTradingEnv-v2', S, A, False, T - 1)

    def start_rows(n, day, g):
        """Reset rows (random cash and lots) with every lane at ``day``."""
        f, _ = body.pack(env_def.init(g, n, dev))
        return f.contiguous(), torch.full((1, n), day, dtype=torch.int32, device=dev)

    def noise(g, h, n):
        return torch.cat([torch.randn((h, A, n), generator=g, device=dev),
                          torch.rand((h, NR, n), generator=g, device=dev)], 1).contiguous()

    def lots_differ(a, b):
        """(H, S, N) stored obs -> (H, N): the share rows tanh(shares 2^-10)
        differ by more than 1e-6, which one lot moves them by below ~5000
        shares (sech^2(x) / 1024) and a last-bit difference of tanh does not."""
        return ((a[:, 1:1 + A] - b[:, 1:1 + A]).abs() > 1e-6).any(1)

    def reset_z(u):
        """The reset's S normals from its 17 uniform rows, as the body draws
        them (the cos row of the 8 pairs, then the sin row)."""
        p = (A + 1) // 2
        r = torch.sqrt(-2.0 * torch.log(1.0 - u[1:1 + p]))
        ang = 2 * math.pi * u[1 + p:1 + 2 * p]
        return torch.cat([r * torch.cos(ang), r * torch.sin(ang)])[:A]

    def explain_flips(got1, want1, env_a, u_reset):
        """One step from the same rows: the samples whose lots differ, and
        whether each is explained by a last-bit difference at a lot edge.  The
        first stock whose lots differ (after it the cash differs too) must
        have a * max_stock within 1e-3 of an integer or |a| within 1e-6 of
        the 0.1 dead zone, or, where the step reset the lane, its normal
        within 1e-4 of 1 or 2 (floor(|z|) decides the lots)."""
        lots_g, lots_w = got1.env_f[1:1 + A], want1.env_f[1:1 + A]
        flip = (lots_g != lots_w).any(0)
        k = torch.argmax((lots_g != lots_w).int(), 0)                   # first differing stock
        x = 100.0 * env_a
        near_edge = (((x - torch.round(x)).abs() < 1e-3)
                     | ((env_a.abs() - 0.1).abs() < 1e-6))
        z = reset_z(u_reset).abs()
        near_z = ((z - 1).abs() < 1e-4) | ((z - 2).abs() < 1e-4)
        term = got1.terminals[0].bool()
        pick = lambda m: m.gather(0, k[None])[0]  # noqa: E731
        explained = torch.where(term, pick(near_z), pick(near_edge))
        return flip, explained

    def one_step(got1, want1, flip):
        """Largest differences over the samples without a lot flip."""
        ok = ~flip
        out = {}
        for f in got1._fields:
            a, b = getattr(got1, f), getattr(want1, f)
            if not a.dtype.is_floating_point or f in ('terminals', 'truncates'):
                assert torch.equal(a, b), f
                continue
            if f == 'env_f':     # cash and totals near 1e6: relative to the value
                out[f] = float(((a - b).abs() / b.abs().clamp_min(1.0))[:, ok].max())
            elif f in ('states', 'actions'):
                d = (a - b).abs()
                out[f] = float((d[:, :, ok] if d.dim() == 3 and d.shape[-1] == ok.numel()
                                else d[:, ok]).max())
            else:
                out[f] = float((a - b).abs()[..., ok].max())
        return out

    def onpolicy_bound(n, h, n_act, n_cri):
        """K4 on-policy: the actor (rollout) and critic (pass) over every
        env-step, each net's W1 market columns once per step (the day, and
        so the market rows of the obs, is the same on every lane); bytes:
        weights, the env rows in and out, one market row of each table per
        step, the stored outputs written once.  Also the bound that counts
        both nets in full per env-step, and the critic pass's alone."""
        L, M = 1 + A, S - 1 - A
        flop_a = 2 * (L * D1 + D1 * D2 + D2 * A) * n * h + 2 * M * D1 * h
        flop_c = 2 * (L * D1 + D1 * D2 + D2) * n * h + 2 * M * D1 * h
        flop_full = 2 * (S * D1 + D1 * D2 + D2 * A) * n * h + 2 * (S * D1 + D1 * D2 + D2) * n * h
        rows = body.n_f32 + body.n_i32
        nbytes = 4 * (n_act + n_cri + 2 * S + 2 * rows * n + h * M + n * h * (S + A + 5))
        return bound(flop_a + flop_c, nbytes), bound(flop_full, nbytes), bound(
            2 * (S * D1 + D1 * D2 + D2) * n * h, 4 * (n_cri + 2 * S + n * h * (S + 1)))

    # ---- k4_vs_plain: the on-policy stock rollout (the actor-only kernel and
    # the critic pass) at ppo_stock's 256 envs and at ppo_stock_4k's 4096,
    # H = 128, (128, 128), from day T - 61 so that every lane ends its
    # episode and resets once.
    # Tolerances.  One step from every state the plain rollout visits
    # (injected noise), kernel and plain version on the same rows: lots are
    # equal but where a last-bit difference of the action (the libraries'
    # tanh, sums in another order) sits at a lot edge; every such flip must
    # be explained (explain_flips) and is counted; elsewhere values,
    # log-probabilities, actions and rewards agree to 1e-4, the env rows to
    # 1e-6 of their value (cash near 1e6, one ulp ~6e-8 of it), stored
    # states to 1e-5, flags and days exactly.  Whole trajectories: the flags
    # and the market rows are the shared day's, equal on every lane; a lane
    # parts from its twin at its first lot flip, and stays apart (a lot
    # moves the cash); the lanes parted and their first steps are reported,
    # at most a quarter may part (a wrong kernel parts nearly all), and the
    # other lanes agree to 2e-2 and end with equal lots.  Two runs of the
    # kernel are bitwise equal.  A ragged N (300: a last group of 12 lanes)
    # runs the same checks.  The kernel's time at each cluster size it can
    # take (cluster_ms: the actor kernel and the critic pass) records the
    # options; the kernel picks its own.
    st = make_ppo(STOCK_NET, S, A, Config()).init(0, dev)
    g = torch.Generator(device=dev).manual_seed(41)
    st = st._replace(norm_avg=torch.rand(S, generator=g, device=dev) * 0.4 - 0.2,
                     norm_std=torch.rand(S, generator=g, device=dev) + 0.7)
    with torch.no_grad():
        st.act.std_log.fill_(-0.5)
    net = (st.act_flat, st.cri_flat, st.norm_avg, st.norm_std)
    k4 = {}
    for recipe, path in (('ppo_stock', PPO_STOCK), ('ppo_stock_4k', PPO_STOCK_4K),
                         ('ragged_300', dict(PPO_STOCK, envs=300))):
        n, h = path['envs'], path['horizon']
        f0, i0 = start_rows(n, T - 61, g)
        nz = noise(g, h, n)
        bkw = dict(net_dims=STOCK_NET, reward_scale=2.0 ** -8, body=body)
        report = {}
        for mode, extra in (('injected', dict(noise=nz)), ('philox', dict(seed=seed))):
            trace = []
            got = fr.rollout(*net, f0, i0, horizon_len=h, **bkw, **extra)
            again = fr.rollout(*net, f0, i0, horizon_len=h, **bkw, **extra)
            want = fr.rollout_reference(*net, f0, i0, horizon_len=h, env_trace=trace, **bkw,
                                        **extra)
            torch.cuda.synchronize()
            assert all(torch.equal(getattr(got, f), getattr(again, f)) for f in got._fields), (
                'K4 runs differ', recipe, mode)
            assert torch.equal(got.terminals, want.terminals) and torch.equal(
                got.truncates, want.truncates), 'K4 flags differ'
            assert int(got.terminals.sum()) == n
            assert torch.equal(got.states[:, 1 + A:], want.states[:, 1 + A:]), 'market rows'
            lot_diff = lots_differ(got.states, want.states)                      # (H, N)
            out_diff = torch.maximum((got.actions - want.actions).abs().amax(1),
                                     (got.logprobs - want.logprobs).abs()) > 2e-2
            parted_at = torch.where((lot_diff | out_diff).any(0),
                                    torch.argmax((lot_diff | out_diff).int(), 0), -1)
            parted = parted_at >= 0
            kept = ~parted
            share = float(parted.float().mean())
            assert share <= 0.25, (mode, share)
            assert torch.equal(got.env_f[1:1 + A][:, kept], want.env_f[1:1 + A][:, kept])
            rel_end = ((got.env_f - want.env_f).abs() / want.env_f.abs().clamp_min(1.0))
            assert float(rel_end[:, kept].max()) <= 1e-5, float(rel_end[:, kept].max())
            assert all(bool(torch.isfinite(getattr(got, f).float()).all()) for f in got._fields)
            firsts = parted_at[parted].float()
            report[mode] = dict(lanes_parted=int(parted.sum()), share_parted=share,
                                first_parting_steps=(firsts.sort().values[:8].int().tolist()
                                                     if parted.any() else []),
                                cause='lot flips' if bool(lot_diff.any()) or not parted.any()
                                else 'outputs', terminals=int(got.terminals.sum()))
            if mode == 'injected':
                inj = (trace, nz)
        trace, nz_ = inj
        f_all = torch.cat([f for f, _ in trace], dim=1).contiguous()
        i_all = torch.cat([i for _, i in trace], dim=1).contiguous()
        nz_all = nz_.transpose(0, 1).reshape(1, nz_.shape[1], h * n).contiguous()
        got1 = fr.rollout(*net, f_all, i_all, horizon_len=1, noise=nz_all, **bkw)
        want1 = fr.rollout_reference(*net, f_all, i_all, horizon_len=1, noise=nz_all, **bkw)
        torch.cuda.synchronize()
        flip, explained = explain_flips(got1, want1, torch.tanh(want1.actions[0]),
                                        nz_all[0, A:])
        assert bool(explained[flip].all()), ('unexplained lot flips', int((~explained[flip]).sum()))
        one = one_step(got1, want1, flip)
        tol = {'values': 1e-4, 'logprobs': 1e-4, 'actions': 1e-4, 'rewards': 1e-4,
               'states': 1e-5, 'env_f': 1e-6}
        assert all(one[f] <= t for f, t in tol.items()), one
        # the critic pass alone against its plain version, on the stored states
        v = fr.critic_values(st.cri_flat, st.norm_avg, st.norm_std, got.states,
                             net_dims=STOCK_NET)
        v_ref = fr.critic_values_reference(st.cri_flat, st.norm_avg, st.norm_std, got.states,
                                           net_dims=STOCK_NET)
        # and on a slice whose H N (693) is no multiple of the 64-sample tile
        odd = got.states[:7, :, :99].contiguous()
        critic_err = max(float((v - v_ref).abs().max()), float((
            fr.critic_values(st.cri_flat, st.norm_avg, st.norm_std, odd, net_dims=STOCK_NET)
            - fr.critic_values_reference(st.cri_flat, st.norm_avg, st.norm_std, odd,
                                         net_dims=STOCK_NET)).abs().max()))
        assert critic_err <= 1e-4, critic_err
        ms = cuda_ms(torch, lambda: fr.rollout(*net, f0, i0, horizon_len=h, seed=seed, **bkw),
                     reps=10, warmup=2)
        plain_ms = cuda_ms(torch, lambda: fr.rollout_reference(*net, f0, i0, horizon_len=h,
                                                               seed=seed, **bkw), reps=1)
        c_ms = cuda_ms(torch, lambda: fr.critic_values(st.cri_flat, st.norm_avg, st.norm_std,
                                                       got.states, net_dims=STOCK_NET),
                       reps=10, warmup=2)
        c_plain = cuda_ms(torch, lambda: fr.critic_values_reference(
            st.cri_flat, st.norm_avg, st.norm_std, got.states, net_dims=STOCK_NET), reps=2)
        cluster = fr._library().stock_rollout_cluster(n, D1, D2, 0)
        cluster_ms = {c: cuda_ms(torch, lambda: fr.rollout(*net, f0, i0, horizon_len=h, seed=seed,
                                                           stock_cluster=c, **bkw),
                                 reps=5, warmup=1) for c in (1, 2, 4, 8)}
        (b_ms, b_by), (full_ms, _), (cb_ms, cb_by) = onpolicy_bound(
            n, h, st.act_flat.numel(), st.cri_flat.numel())
        emit(phase='k4_vs_plain', kernel='fused_rollout[StockTradingEnv-v2,gaussian]',
             recipe=recipe, envs=n,
             horizon=h, trajectory=report, one_step=one, one_step_samples=h * n,
             one_step_lot_flips=int(flip.sum()), lot_flips_explained=int(explained[flip].sum()),
             two_runs_bitwise_equal=True, cluster=cluster, cluster_ms=cluster_ms,
             critic_pass_max_abs_err=critic_err, ms=ms, actor_ms=ms - c_ms, plain_ms=plain_ms,
             bound_ms=b_ms, bound_by=b_by, bound_ms_full_obs=full_ms, critic_ms=c_ms,
             critic_plain_ms=c_plain, critic_bound_ms=cb_ms, critic_bound_by=cb_by,
             ms_covers='the actor-only rollout kernel and the critic pass',
             tolerance=dict(tol, share_parted=0.25, kept_lanes=2e-2))
        k4[recipe] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=max(one['values'], one['logprobs'],
                                                                one['actions'], one['rewards']),
                     bound_ms=b_ms, bound_by=b_by, bound_ms_full_obs=full_ms, cluster=cluster,
                     critic=dict(ms=c_ms, plain_ms=c_plain, max_abs_err=critic_err,
                                 bound_ms=cb_ms, bound_by=cb_by))

    # ---- k4_philox: the internal draws.  Every lane at the last day but one
    # ends its episode at step 0 and resets from Philox uniforms: cash in
    # [0.75, 1.25) x 1e6 with mean within 5e3 of 1e6 (four standard errors at
    # 16,384 lanes), lots 0 / 128 / 256 with the probabilities of |z| < 1,
    # < 2, >= 2 (0.6827, 0.2718, 0.0455) within 0.005 over 245,760 draws; the
    # Gaussian head's normals, recovered from the stored actions of the 4096-
    # lane Philox rollout, have mean and std within 0.01 of 0 and 1.
    n = 16384
    f0, i0 = start_rows(n, T - 2, g)
    out = fr.rollout(*net, f0, i0, horizon_len=1, reward_scale=1.0, net_dims=STOCK_NET,
                     body=body, seed=seed)
    assert bool(out.terminals.all())
    cash, lots = out.env_f[0], out.env_f[1:1 + A] / 128
    freq = torch.stack([(lots == k).float().mean() for k in range(3)])
    dfreq = float((freq - torch.tensor([0.6827, 0.2718, 0.0455], device=dev)).abs().max())
    assert float(cash.min()) >= 7.5e5 and float(cash.max()) < 1.25e6
    assert abs(float(cash.mean()) - 1e6) < 5e3 and dfreq < 0.005, (float(cash.mean()), dfreq)
    f0, i0 = start_rows(4096, 0, g)
    out = fr.rollout(*net, f0, i0, horizon_len=128, reward_scale=1.0, net_dims=STOCK_NET,
                     body=body, seed=seed)
    with torch.no_grad():
        xs = out.states.transpose(1, 2)
        mean = st.act((xs - st.norm_avg) / (st.norm_std + 1e-4))
        z = ((out.actions.transpose(1, 2) - mean) / torch.exp(st.act.std_log)).reshape(-1)
    zm, zs = float(z.mean()), float(z.std())
    assert abs(zm) < 0.01 and abs(zs - 1) < 0.01, (zm, zs)
    emit(phase='k4_philox', reset_lanes=n, cash_range=[float(cash.min()), float(cash.max())],
         cash_mean=float(cash.mean()), lot_freq=freq.tolist(), max_lot_freq_diff=dfreq,
         head_normals=dict(draws=z.numel(), mean=zm, std=zs),
         bounds='cash mean 5e3, lot frequency 0.005, normals 0.01')

    # ---- k4_offpolicy_vs_plain: the ddpg, sac and modsac heads on the stock
    # body at 1024 envs x 32 steps from day T - 17 (every lane resets once);
    # the tolerances of k4_vs_plain
    k4_off = {}
    for head in ('ddpg', 'sac', 'modsac'):
        n, h = STOCK_OFF['envs'], STOCK_OFF['horizon']
        heads = {'sac': [((D2, 2 * A), 0.1)], 'modsac': [((D2, A), 0.1)] * 2}.get(head)
        nets = [((S, D1, D2, A), 0.1)] if head == 'ddpg' else [((S, D1, D2), None)] + heads
        flat = init_flat(torch.Generator().manual_seed(7), nets, dev)
        f0, i0 = start_rows(n, T - 17, g)
        nz = noise(g, h, n)
        kw = dict(body=body, head=head, net_dims=STOCK_NET, reward_scale=1.0, noise_std=0.1,
                  explore_rate=0.25, std_clip=(-20.0, 2.0) if head == 'modsac' else (-16.0, 2.0))
        report = {}
        for mode, extra in (('injected', dict(noise=nz)), ('philox', dict(seed=seed))):
            trace = []
            got = fr.offpolicy_rollout(flat, f0, i0, horizon_len=h, **kw, **extra)
            want = fr.offpolicy_rollout_reference(flat, f0, i0, horizon_len=h, env_trace=trace,
                                                  **kw, **extra)
            torch.cuda.synchronize()
            assert torch.equal(got.terminals, want.terminals) and int(got.terminals.sum()) == n
            assert torch.equal(got.states[..., 1 + A:], want.states[..., 1 + A:])
            lot_diff = lots_differ(got.states.transpose(1, 2), want.states.transpose(1, 2))
            out_diff = (got.actions - want.actions).abs().amax(-1) > 2e-2
            bad = lot_diff | out_diff
            parted = bad.any(0)
            share = float(parted.float().mean())
            assert share <= 0.25, (head, mode, share)
            assert torch.equal(got.env_f[1:1 + A][:, ~parted], want.env_f[1:1 + A][:, ~parted])
            report[mode] = dict(lanes_parted=int(parted.sum()), share_parted=share)
            if mode == 'injected':
                inj = trace
        f_all = torch.cat([f for f, _ in inj], dim=1).contiguous()
        i_all = torch.cat([i for _, i in inj], dim=1).contiguous()
        nz_all = nz.transpose(0, 1).reshape(1, nz.shape[1], h * n).contiguous()
        got1 = fr.offpolicy_rollout(flat, f_all, i_all, horizon_len=1, noise=nz_all, **kw)
        want1 = fr.offpolicy_rollout_reference(flat, f_all, i_all, horizon_len=1, noise=nz_all,
                                               **kw)
        torch.cuda.synchronize()
        flip, explained = explain_flips(got1, want1, want1.actions[0].T, nz_all[0, A:])
        assert bool(explained[flip].all()), (head, int((~explained[flip]).sum()))
        ok = ~flip
        one = {'actions': float((got1.actions - want1.actions).abs()[0][ok].max()),
               'rewards': float((got1.rewards - want1.rewards).abs()[0][ok].max()),
               'states': float((got1.states - want1.states).abs().max()),
               'env_f': float(((got1.env_f - want1.env_f).abs()
                               / want1.env_f.abs().clamp_min(1.0))[:, ok].max())}
        assert torch.equal(got1.env_i, want1.env_i)
        assert all(one[f] <= t for f, t in (('actions', 1e-4), ('rewards', 1e-4),
                                            ('states', 1e-5), ('env_f', 1e-6))), (head, one)
        ms = cuda_ms(torch, lambda: fr.offpolicy_rollout(flat, f0, i0, horizon_len=h, seed=seed,
                                                         **kw), reps=10, warmup=2)
        plain_ms = cuda_ms(torch, lambda: fr.offpolicy_rollout_reference(
            flat, f0, i0, horizon_len=h, seed=seed, **kw), reps=1)
        out_rows = 2 * A if head != 'ddpg' else A
        flop = 2 * (S * D1 + D1 * D2 + D2 * out_rows) * n * h
        rows = body.n_f32 + body.n_i32
        b_ms, b_by = bound(flop, 4 * (flat.numel() + 2 + 2 * rows * n + h * (S - 1 - A)
                                      + n * h * (S + A + 3)))
        emit(phase='k4_offpolicy_vs_plain', kernel=f'fused_rollout[StockTradingEnv-v2,{head}]',
             envs=n, horizon=h, trajectory=report, one_step=one,
             one_step_lot_flips=int(flip.sum()), lot_flips_explained=int(explained[flip].sum()),
             ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
             tolerance={'actions': 1e-4, 'rewards': 1e-4, 'states': 1e-5, 'env_f': 1e-6,
                        'share_parted': 0.25})
        k4_off[head] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=max(one['actions'],
                                                                       one['rewards']),
                            bound_ms=b_ms, bound_by=b_by)

    # ---- the stock main paths
    def stock_args(path, device=None, agent_class=AgentPPO, **hyper):
        a = Config(agent_class, StockTradingVecEnv,
                   {'env_name': 'StockTradingEnv-v2', 'num_envs': path['envs'],
                    'max_step': T - 1, 'state_dim': S, 'action_dim': A, 'if_discrete': False})
        a.horizon_len, a.batch_size, a.repeat_times = path['horizon'], path['batch'], path['repeat']
        a.learning_rate, a.net_dims, a.random_seed = path['lr'], STOCK_NET, 0
        if device is not None:
            a.device = device
        for k, v in hyper.items():
            setattr(a, k, v)
        return a

    def reset_counts():
        fr.rollout.launches = fr.critic_values.launches = ppo_update.launches = 0
        fr.rollout.launches_by_body.clear()
        fr.offpolicy_rollout.launches_by_kernel.clear()
        for k in ppo_update.launches_by_head:
            ppo_update.launches_by_head[k] = 0

    def read_counts():
        return {'fused_rollout': fr.rollout.launches_by_body.get('StockTradingEnv-v2', 0),
                'critic_values': fr.critic_values.launches,
                'ppo_update': ppo_update.launches_by_head['continuous']}

    # one small round at ppo_stock's hypers (256 envs, H = 32, batch 128: K4
    # and K2 on the card) against the same round through the plain versions
    # on the CPU; tolerance: objectives 1e-3 relative, updates 2e-2 of each
    # buffer's largest
    g3 = torch.Generator().manual_seed(3)
    small = dict(PPO_STOCK, horizon=32, batch=128)
    small_noise = torch.cat([torch.randn((32, A, 256), generator=g3),
                             torch.rand((32, NR, 256), generator=g3)], 1)
    small_ids = torch.randint(0, 32 * 256, (2, 128), generator=g3)
    runs, start = {}, None
    for device in ('cuda', 'cpu'):
        ctx = build_training(stock_args(small, device))
        assert ctx.fused_rollout
        carry0 = ctx.carry
        if start is None:
            start = (ppo_state_to_numpy(carry0.agent_state), [x.cpu() for x in carry0.env_state],
                     carry0.obs.cpu())
        else:
            carry0 = carry0._replace(agent_state=ppo_state_from_numpy(start[0], ctx.device),
                                     env_state=type(carry0.env_state)(*start[1]), obs=start[2])
        before = [carry0.agent_state.act_flat.clone(), carry0.agent_state.cri_flat.clone()]
        reset_counts()
        c, m = ctx.round_fn(carry0, noise=small_noise.to(ctx.device).contiguous(),
                            ids=small_ids.to(ctx.device))
        if device == 'cuda':
            assert read_counts() == {'fused_rollout': 1, 'critic_values': 1, 'ppo_update': 1}
        runs[device] = ({k: float(v) for k, v in m.items()},
                        [(c.agent_state.act_flat - before[0]).cpu(),
                         (c.agent_state.cri_flat - before[1]).cpu()])
    (mg, dg), (mc, dc) = runs['cuda'], runs['cpu']
    obj_rel = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-6) for k in mc}
    upd_rel = [float((x - y).abs().max() / y.abs().max()) for x, y in zip(dg, dc)]
    assert all(r <= 1e-3 for r in obj_rel.values()), obj_rel
    assert all(r <= 2e-2 for r in upd_rel), upd_rel
    emit(phase='main_path_stock_small_vs_cpu', envs=256, horizon=32, batch=128,
         objective_rel_diff=obj_rel, update_rel_diff=upd_rel)

    def timed(path, phase, want, **extra):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            ctx = build_training(stock_args(path))
        print(text.getvalue(), end='', flush=True)
        assert ctx.fused_rollout
        carry, _ = ctx.round_fn(ctx.carry)                       # warm-up round
        p0 = [carry.agent_state.act_flat.clone(), carry.agent_state.cri_flat.clone()]
        torch.cuda.synchronize()
        reset_counts()
        start_, end_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start_.record()
        metrics = []
        for _ in range(ROUNDS):
            carry, m = ctx.round_fn(carry)
            m = scalars(m)
            metrics.append(torch.stack([m[k].float() for k in sorted(m)]))
        end_.record()
        torch.cuda.synchronize()
        launches = read_counts()
        assert launches == want, (phase, launches)
        round_ms = start_.elapsed_time(end_) / ROUNDS
        mvals = torch.stack(metrics).cpu()
        moved = max(float((carry.agent_state.act_flat - p0[0]).abs().max()),
                    float((carry.agent_state.cri_flat - p0[1]).abs().max()))
        assert bool(torch.isfinite(mvals).all()) and moved > 0.0
        update = ('pytorch (the JAX package runs this batch as XLA ops)'
                  if 'use_fused_update: PyTorch path' in text.getvalue() else 'kernel')
        emit(phase=phase, agent='AgentPPO', env='StockTradingEnv-v2', envs=path['envs'],
             horizon=path['horizon'], batch=path['batch'], repeat=path['repeat'],
             net_dims=STOCK_NET, rounds=ROUNDS, launches=launches, update_path=update,
             round_ms=round_ms, env_steps_per_s=path['envs'] * path['horizon'] / (round_ms / 1e3),
             metrics=dict(zip(sorted(m), mvals[-1].tolist())), max_param_change=moved,
             device=name, nvidia_smi=smi, **extra)
        return launches, update

    stock_launches, _ = timed(PPO_STOCK, 'main_path_stock', {
        'fused_rollout': ROUNDS, 'critic_values': ROUNDS, 'ppo_update': ROUNDS},
        fused_rollout_ms=k4['ppo_stock']['ms'], critic_ms=k4['ppo_stock']['critic']['ms'])
    stock4k_launches, update = timed(PPO_STOCK_4K, 'main_path_stock_4k', {
        'fused_rollout': ROUNDS, 'critic_values': ROUNDS, 'ppo_update': 0},
        fused_rollout_ms=k4['ppo_stock_4k']['ms'],
        critic_ms=k4['ppo_stock_4k']['critic']['ms'])
    assert update.startswith('pytorch'), update

    # ---- the entry point: PPO on the stock env at ppo_stock's shape (two
    # evaluation periods, the evaluator reporting cumulative_returns, 100 x
    # the final asset over the initial cash), then TD3, SAC and ModSAC (the
    # off-policy heads on K4)
    off_runs = {}
    for agent_class, path, periods, head in (
            (AgentPPO, PPO_STOCK, 2, None),
            (AgentTD3, dict(envs=256, horizon=32, batch=256, repeat=1.0, lr=3e-4), 2, 'ddpg'),
            (AgentSAC, dict(envs=256, horizon=32, batch=256, repeat=1.0, lr=3e-4), 1, 'sac'),
            (AgentModSAC, dict(envs=256, horizon=32, batch=256, repeat=1.0, lr=3e-4), 1,
             'modsac')):
        with tempfile.TemporaryDirectory() as cwd:
            a = stock_args(path, agent_class=agent_class, cwd=cwd, eval_times=2)
            if head is not None:
                a.buffer_size, a.gamma = 8192, 0.99
            a.eval_per_step = path['envs'] * path['horizon']
            a.break_step = a.eval_per_step * (periods - 1)
            reset_counts()
            t0 = time.time()
            res = train_agent(a)
            counts = read_counts()
            by_kernel = dict(fr.offpolicy_rollout.launches_by_kernel)
            rec = res['recorder']
            assert rec.shape[0] == periods and np.isfinite(rec).all()
            assert bool(((rec[:, 1] > 10) & (rec[:, 1] < 1000)).all()), rec[:, 1]   # percent
            if head is None:
                assert counts['fused_rollout'] == periods and counts['critic_values'] == periods
            else:
                tag = f'StockTradingEnv-v2,{head}'
                assert by_kernel.get(tag, 0) == periods, by_kernel
                off_runs[head] = periods
            emit(phase='train_agent', agent=agent_class.__name__, env='StockTradingEnv-v2',
                 envs=path['envs'], evaluations=int(rec.shape[0]),
                 total_step=int(res['total_step']),
                 max_cumulative_return=float(res['max_r']), seconds=round(time.time() - t0, 3),
                 rollout_launches=by_kernel if head else counts)

    kernels = []
    for recipe, path, launches in (('ppo_stock', PPO_STOCK, stock_launches),
                                   ('ppo_stock_4k', PPO_STOCK_4K, stock4k_launches)):
        k, n = k4[recipe], path['envs']
        kernels.append({'name': f'fused_rollout[StockTradingEnv-v2,gaussian,{n} envs]',
                        'route': 'cuda', 'source': src,
                        'replaces': 'elegantrl_tpu/ops/pallas_rollout.py:451',
                        'launches': launches['fused_rollout'], 'max_abs_err': k['max_abs_err'],
                        'ms': k['ms'], 'plain_ms': k['plain_ms'], 'bound_ms': k['bound_ms'],
                        'bound_by': k['bound_by'], 'library_ms': None,
                        'bound_ms_full_obs': k['bound_ms_full_obs'], 'cluster': k['cluster']})
        c = k['critic']
        kernels.append({'name': f'critic_values[StockTradingEnv-v2,{n} envs]', 'route': 'cuda',
                        'source': src, 'replaces': 'elegantrl_tpu/ops/pallas_rollout.py:600',
                        'launches': launches['critic_values'], 'max_abs_err': c['max_abs_err'],
                        'ms': c['ms'], 'plain_ms': c['plain_ms'], 'bound_ms': c['bound_ms'],
                        'bound_by': c['bound_by'], 'library_ms': None})
    kernels.append({'name': 'ppo_update[StockTradingEnv-v2]', 'route': 'cuda',
                    'source': 'elegantrl_tpu_torch/ops/csrc/ppo_update.cu',
                    'replaces': 'elegantrl_tpu/ops/pallas_update.py:79',
                    'launches': stock_launches['ppo_update'],
                    'max_abs_err': k2_stock['max_abs_err'], 'ms': k2_stock['ms'],
                    'plain_ms': k2_stock['plain_ms'], 'bound_ms': k2_stock['bound_ms'],
                    'bound_by': k2_stock['bound_by'], 'library_ms': None})
    for head, k in k4_off.items():
        kernels.append({'name': f'fused_rollout[StockTradingEnv-v2,{head}]', 'route': 'cuda',
                        'source': src, 'replaces': 'elegantrl_tpu/ops/pallas_rollout.py:451',
                        'launches': off_runs[head], 'max_abs_err': k['max_abs_err'],
                        'ms': k['ms'], 'plain_ms': k['plain_ms'], 'bound_ms': k['bound_ms'],
                        'bound_by': k['bound_by'], 'library_ms': None})
    return kernels


# ---------------------------------------------------------------- LunarLander

LUNAR_PPO = dict(envs=64, horizon=256, batch=512, repeat=16.0, lr=3e-4, net=(128, 128))
LUNAR_DQN = dict(envs=64, horizon=64, buffer=30000, batch=256, repeat=1.0, lr=5e-4,
                 net=(256, 256), explore_rate=0.2, updates=117)


def synthetic_ring(torch, rb, buf):
    """A full ring of transitions drawn on the card from a seed (a round's
    time does not depend on their values): states and rewards normal,
    actions uniform over the discrete actions, 2% terminal."""
    g = torch.Generator(device=buf.states.device).manual_seed(5)
    buf.states.normal_(generator=g)
    buf.rewards.normal_(generator=g)
    buf.undones.copy_((torch.rand(buf.undones.shape, generator=g, device=g.device)
                       > 0.02).float())
    buf.unmasks.fill_(1.0)
    buf.actions.copy_(torch.randint(0, rb.action_dim, buf.actions.shape, generator=g,
                                    device=g.device, dtype=buf.actions.dtype))
    return buf._replace(ptr=0, size=rb.max_size)


def buffer_rows(out, feature_major):
    """A feature-major (C, dim, B) gather as the (C, B, dim) rows of the
    one-field gather."""
    return out.transpose(1, 2) if feature_major else out


def lunar_phases(torch, dev, name, smi, bound, k2_lunar, k9_lunar):
    """K10, K11a and K11b against their plain versions, and the LunarLander
    paths; returns their entries of the kernels line (with K2 at S = 8, A = 2,
    U = 8 and K9 at (256, 256), whose checks ran with the other kernels')."""
    from elegantrl_tpu_torch import (Config, build_training, train_agent,
                                     train_agent_single_process, valid_agent)
    from elegantrl_tpu_torch.agents import AgentD3QN, AgentDQN, AgentPPO
    from elegantrl_tpu_torch.envs import LunarLanderContinuousEnv, LunarLanderEnv
    from elegantrl_tpu_torch.ops import fused_offpolicy_update as fo, kernels as kn
    from elegantrl_tpu_torch.ops.fused_update import ppo_update
    from elegantrl_tpu_torch.ops.nets import mlp_init
    from elegantrl_tpu_torch.train.evaluator import make_eval_fn
    src = 'elegantrl_tpu_torch/ops/csrc/kernels.cu'
    replaces = 'elegantrl_tpu/ops/pallas_kernels.py:'

    def cuda_ms_(fn, reps, warmup=1):
        return cuda_ms(torch, fn, reps, warmup)

    # ---- K10: bitwise equal to the plain loop (the same f32 operations in
    # the same order, no FMA contraction)
    k10 = {}
    for H, N in ((LUNAR_PPO['horizon'], LUNAR_PPO['envs']), (64, 4096), (37, 1000)):
        g = torch.Generator(device=dev).manual_seed(H * N)
        r = torch.randn((H, N), generator=g, device=dev)
        u = (torch.rand((H, N), generator=g, device=dev) > 0.02).float()
        v = torch.randn((H, N), generator=g, device=dev)
        nv = torch.randn(N, generator=g, device=dev)
        got = kn.gae_vtrace_kernel(r, u, v, nv, 0.99, 0.95)
        want = kn.gae_vtrace_reference(r, u, v, nv, 0.99, 0.95)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        assert torch.equal(got, want), ('K10 differs from its plain version', H, N, err)
        ms = cuda_ms_(lambda: kn.gae_vtrace_kernel(r, u, v, nv, 0.99, 0.95), reps=50, warmup=3)
        plain = cuda_ms_(lambda: kn.gae_vtrace_reference(r, u, v, nv, 0.99, 0.95), reps=5)
        # r, u, v read and adv written once; 7 f32 operations a cell
        b_ms, b_by = bound(7 * H * N, 4 * (4 * H * N + N))
        k10[(H, N)] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
        emit(phase='k10_vs_plain', H=H, N=N, bitwise_equal=True, **k10[(H, N)],
             library_ms=None, tolerance='exact')

    # ---- K11a: bitwise equal to buf[ids0, ids1]; one launch gathers every
    # field of a chunk (ReplayBuffer.gather with feature_major, as the update
    # chunks read them).  The library yardstick is one buf[ids0, ids1] call
    # per field plus the transposes to (C, dim, B) where the kernel writes
    # that layout; the port never calls it.  The one-field case (the JAX
    # package's function) is checked at the same ids.
    k11a = {}
    g = torch.Generator(device=dev).manual_seed(12)
    ring_d = torch.randn((4000, 1024, 6), generator=g, device=dev)
    act_d = torch.randn((4000, 1024, 2), generator=g, device=dev)
    cols_d = [torch.randn((4000, 1024), generator=g, device=dev) for _ in range(3)]
    ids0_d = torch.randint(0, 3999, (16, 1024), generator=g, device=dev)
    ids1_d = torch.randint(0, 1024, (16, 1024), generator=g, device=dev)
    ring_l = torch.randn((30000, 64, 8), generator=g, device=dev)
    act_l = torch.randint(0, 4, (30000, 64), generator=g, device=dev, dtype=torch.int32)
    cols_l = [torch.randn((30000, 64), generator=g, device=dev) for _ in range(3)]
    rows = torch.randint(0, 29999, (16, 4), generator=g, device=dev)
    ids0_l = rows[..., None].expand(16, 4, 64).reshape(16, 256)
    ids1_l = torch.arange(64, device=dev).expand(16, 4, 64).reshape(16, 256)

    def chunk_fields(ring, act, cols):
        return ([(ring, 0, True), (act, 0, act.dim() == 3)] + [(c, 0, False) for c in cols]
                + [(ring, 1, True)])

    def library(fields, i0, i1):
        outs = []
        for buf, off, fm in fields:
            out = buf[i0 + off, i1] if off else buf[i0, i1]
            outs.append(out.transpose(1, 2).contiguous() if fm else out)
        return outs

    cases = {'dqn_lunarlander_chunk': (chunk_fields(ring_l, act_l, cols_l), ids0_l, ids1_l),
             'path_d_chunk': (chunk_fields(ring_d, act_d, cols_d), ids0_d, ids1_d)}
    for case, (fields, i0, i1) in cases.items():
        for ids in ((i0, i1), (i0.int(), i1.int())):
            got = kn.buffer_gather_fields(fields, *ids)
            want = kn.buffer_gather_fields_reference(fields, *ids)
            lib_out = library(fields, *ids)
            one = [kn.buffer_gather(buf, *ids, off) for buf, off, _ in fields]
            torch.cuda.synchronize()
            for k, (a, b, c, d) in enumerate(zip(got, want, lib_out, one)):
                assert torch.equal(a, b) and torch.equal(a, c), ('K11a differs', case, k,
                                                                  ids[0].dtype)
                assert torch.equal(d, buffer_rows(b, fields[k][2])), ('K11a one field', case, k)
        ms = cuda_ms_(lambda: kn.buffer_gather_fields(fields, i0, i1), reps=50, warmup=3)
        plain = cuda_ms_(lambda: kn.buffer_gather_fields_reference(fields, i0, i1), reps=50,
                         warmup=3)
        lib_ms = cuda_ms_(lambda: library(fields, i0, i1), reps=50, warmup=3)
        one_ms = cuda_ms_(lambda: kn.buffer_gather(ring_l if case.startswith('dqn') else ring_d,
                                                   i0, i1), reps=50, warmup=3)
        nbytes = sum(i0.numel() * 2 * buf[0, 0].numel() * buf.element_size()
                     for buf, _, _ in fields) + 2 * i0.numel() * 8
        b_ms, b_by = bound(0, nbytes)
        k11a[case] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by, n_fields=len(fields),
                          one_field_ms=one_ms)
        emit(phase='k11a_vs_plain', case=case, ring=tuple(fields[0][0].shape),
             ids=tuple(i0.shape), launches_per_chunk=1,
             fields='states and next states (C, S, B), actions ' + (
                 'int32 (C, B)' if case.startswith('dqn') else '(C, A, B)')
             + ', rewards, undones, unmasks (C, B)', ids_dtypes='int64 and int32',
             bitwise_equal=True, **k11a[case],
             library='one buf[ids0, ids1] per field + transpose(1, 2).contiguous() where '
                     'feature-major', tolerance='exact')

    # ---- K11b: within 1e-5 of the largest plain output (FP32 products
    # summed in another order than cuBLAS's, TF32 off; tanhf of two
    # libraries) at the LunarLander actors' and critic's widths, for the
    # rollout's B = 64, a ragged 65 and 1, and 1000, 4096, 16,384 (each B
    # takes its own (rows, cluster) layout); two runs bitwise equal; the
    # call time by CUDA events and the device time from the profiler
    k11b = {}
    for dims in ((8, 128, 128, 2), (8, 256, 256, 4), (8, 128, 128, 1)):
        for B in (1, 64, 65, 1000, 4096, 16384):
            g = torch.Generator(device=dev).manual_seed(B)
            leaves = [p.detach().to(dev).contiguous() for p in
                      mlp_init(torch.Generator().manual_seed(B), dims, out_std=0.1).leaves()]
            x = torch.randn((B, dims[0]), generator=g, device=dev)
            got = kn.fused_mlp3(x, *leaves)
            again = kn.fused_mlp3(x, *leaves)
            want = kn.fused_mlp3_reference(x, *leaves)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            assert math.isfinite(err) and err <= 1e-5 * scale, ('K11b', dims, B, err, scale)
            assert torch.equal(got, again), ('K11b runs differ', dims, B)
            ms = cuda_ms_(lambda: kn.fused_mlp3(x, *leaves), reps=50, warmup=3)
            dev_ms = profiled_ms(torch, lambda: kn.fused_mlp3(x, *leaves), 20, 'fused_mlp3')
            plain = cuda_ms_(lambda: kn.fused_mlp3_reference(x, *leaves), reps=50, warmup=3)
            S, D1, D2, A = dims
            n_params = sum(t.numel() for t in leaves)
            b_ms, b_by = bound(2 * B * (S * D1 + D1 * D2 + D2 * A),
                               4 * (B * S + n_params + B * A))
            layout = kn._library().fused_mlp3_config(B, *dims)
            k11b[(dims, B)] = dict(max_abs_err=err, max_abs_out=scale, ms=ms, device_ms=dev_ms,
                                   plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                   rows_per_cluster=layout // 16, cluster=layout % 16)
            emit(phase='k11b_vs_plain', dims=dims, B=B, **k11b[(dims, B)], library_ms=None,
                 two_runs_bitwise_equal=True, tolerance='1e-5 x max|plain out|')

    # ---- the main paths, 10 rounds each at full width
    counters = {'gae_vtrace': kn.gae_vtrace_kernel, 'buffer_gather': kn.buffer_gather_fields,
                'fused_mlp3': kn.fused_mlp3, 'ppo_update': ppo_update, 'dqn_update': fo.dqn_chunk}

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0
        for k in ppo_update.launches_by_head:
            ppo_update.launches_by_head[k] = 0
        for k in fo.dqn_chunk.launches_by_variant:
            fo.dqn_chunk.launches_by_variant[k] = 0

    def read_counts():
        return {k: fn.launches for k, fn in counters.items()}

    def lunar_args(agent_class, path, **hyper):
        discrete = agent_class is not AgentPPO
        a = Config(agent_class, LunarLanderEnv if discrete else LunarLanderContinuousEnv,
                   {'env_name': 'LunarLander-v2' if discrete else 'LunarLanderContinuous-v2',
                    'num_envs': path['envs'], 'max_step': 1000, 'state_dim': 8,
                    'action_dim': 4 if discrete else 2, 'if_discrete': discrete})
        a.horizon_len, a.batch_size, a.repeat_times = path['horizon'], path['batch'], path['repeat']
        a.learning_rate, a.net_dims, a.random_seed = path['lr'], path['net'], 0
        if discrete:
            a.buffer_size, a.explore_rate = path['buffer'], path['explore_rate']
        for k, v in hyper.items():
            setattr(a, k, v)
        return a

    def timed(args, phase, want, prepare=None):
        ctx = build_training(args)
        carry = ctx.carry
        if prepare is not None:
            carry = prepare(ctx, carry)
        carry, _ = ctx.round_fn(carry)                          # warm-up round
        p0 = [x.clone() for x in carry.agent_state if isinstance(x, torch.Tensor)]
        torch.cuda.synchronize()
        reset_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        metrics = []
        for _ in range(ROUNDS):
            carry, m = ctx.round_fn(carry)
            m = scalars(m)
            metrics.append(torch.stack([m[k].float() for k in sorted(m)]))
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / ROUNDS
        launches = read_counts()
        round_ms = start.elapsed_time(end) / ROUNDS
        mvals = torch.stack(metrics).cpu()
        after = [x for x in carry.agent_state if isinstance(x, torch.Tensor)]
        moved = max(float((x - y).abs().max()) for x, y in zip(after, p0))
        assert launches == want, (phase, launches, want)
        assert bool(torch.isfinite(mvals).all()), mvals
        assert moved > 0.0
        steps = args.num_envs * args.horizon_len
        emit(phase=phase, agent=args.agent_class.__name__, env=args.env_name,
             envs=args.num_envs, horizon=args.horizon_len, batch=args.batch_size,
             repeat=args.repeat_times, net_dims=tuple(args.net_dims), rounds=ROUNDS,
             launches=launches, round_ms=round_ms, round_ms_host=host_ms,
             env_steps_per_s=steps / (round_ms / 1e3),
             metrics=dict(zip(sorted(m), mvals[-1].tolist())), max_param_change=moved,
             device=name, nvidia_smi=smi)
        return launches

    H_p = LUNAR_PPO['horizon']
    ppo_l = timed(lunar_args(AgentPPO, LUNAR_PPO), 'main_path_ppo_lunar',
                  # per round: K10 once, K2 once, K11b for the actor and the
                  # critic at every step and for the last observation's value
                  {'gae_vtrace': ROUNDS, 'buffer_gather': 0,
                   'fused_mlp3': ROUNDS * (2 * H_p + 1), 'ppo_update': ROUNDS, 'dqn_update': 0})

    def fill_ring(ctx, carry):
        return carry._replace(buf_state=synthetic_ring(torch, ctx.rb, carry.buf_state))

    chunks = -(-LUNAR_DQN['updates'] // 16)
    dqn_l = timed(lunar_args(AgentDQN, LUNAR_DQN), 'main_path_dqn_lunar',
                  # per round: K11b at every step (the greedy Q), K9 per chunk of
                  # 16 updates, K11a once per chunk for all six fields
                  {'gae_vtrace': 0, 'buffer_gather': ROUNDS * chunks,
                   'fused_mlp3': ROUNDS * LUNAR_DQN['horizon'], 'ppo_update': 0,
                   'dqn_update': ROUNDS * chunks}, prepare=fill_ring)
    assert fo.dqn_chunk.launches_by_variant['dqn'] == ROUNDS * chunks

    # ---- the entry point: train_agent (and an alias) for PPO, DQN and D3QN,
    # two evaluation periods each, then valid_agent on the saved D3QN agent
    entry = {}
    for agent_class, path, periods in ((AgentPPO, LUNAR_PPO, 2), (AgentDQN, LUNAR_DQN, 2),
                                       (AgentD3QN, dict(LUNAR_DQN, buffer=8000), 2)):
        with tempfile.TemporaryDirectory() as cwd:
            a = lunar_args(agent_class, path, cwd=cwd, eval_times=2)
            a.eval_per_step = a.num_envs * a.horizon_len * 2
            a.break_step = a.eval_per_step * (periods - 1)
            reset_counts()
            t0 = time.time()
            run = train_agent_single_process if agent_class is AgentPPO else train_agent
            res = run(a)
            counts = dict(read_counts(), dqn_variants={
                k: v for k, v in fo.dqn_chunk.launches_by_variant.items() if v})
            assert res['recorder'].shape[0] == periods and math.isfinite(res['max_r'])
            if agent_class is AgentPPO:
                assert counts['gae_vtrace'] == 2 * periods and counts['ppo_update'] == 2 * periods
            else:
                assert counts['buffer_gather'] == counts['dqn_update'] > 0   # one per chunk
            if agent_class is AgentD3QN:
                # the encoder and heads run PyTorch ops, in the rollout and the evaluator
                assert counts['fused_mlp3'] == 0 and counts['dqn_variants'].keys() == {'d3qn'}
                pairs = valid_agent(LunarLanderEnv, dict(a.env_args), path['net'], AgentD3QN,
                                    f'{cwd}/agent.npz', render_times=3)
                ctx = build_training(a)
                gen = torch.Generator(device=dev)
                gen.manual_seed(1)
                ret, stp = make_eval_fn(ctx.env, ctx.agent.greedy_action, 3, 1000, dev)(
                    res['agent_state'], gen)
                assert pairs == [(float(r), int(s)) for r, s in zip(ret, stp)], pairs
                counts['valid_agent'] = pairs
            else:
                assert counts['fused_mlp3'] > 0
            entry[agent_class.__name__] = counts
            emit(phase='train_agent', agent=agent_class.__name__, env=a.env_name,
                 envs=a.num_envs, evaluations=int(res['recorder'].shape[0]),
                 total_step=int(res['total_step']), max_r=float(res['max_r']),
                 seconds=round(time.time() - t0, 3), launches=counts)

    # ---- kernels line entries
    def entry_of(kname, route_src, repl, launches, main, **extra):
        return {'name': kname, 'route': 'cuda', 'source': route_src, 'replaces': repl,
                'launches': launches, 'max_abs_err': main['max_abs_err'], 'ms': main['ms'],
                'plain_ms': main['plain_ms'], 'bound_ms': main['bound_ms'],
                'bound_by': main['bound_by'], 'library_ms': main.get('library_ms'), **extra}

    k10_main = k10[(H_p, LUNAR_PPO['envs'])]
    kernels = [
        entry_of('gae_vtrace[256x64]', src, replaces + '123', ppo_l['gae_vtrace'], k10_main,
                 at_64x4096=k10[(64, 4096)], at_37x1000=k10[(37, 1000)]),
        entry_of('buffer_gather_fields[dqn_lunarlander chunk, 6 fields]', src, replaces + '62',
                 dqn_l['buffer_gather'], k11a['dqn_lunarlander_chunk'],
                 path_d_chunk=k11a['path_d_chunk']),
        entry_of('fused_mlp3[8,128,128,2 B=64]', src, replaces + '172', ppo_l['fused_mlp3'],
                 k11b[((8, 128, 128, 2), 64)], at_B16384=k11b[((8, 128, 128, 2), 16384)],
                 critic_8_128_128_1=k11b[((8, 128, 128, 1), 64)],
                 launches_cover='the actor and the critic forwards of main_path_ppo_lunar'),
        entry_of('fused_mlp3[8,256,256,4 B=64]', src, replaces + '172', dqn_l['fused_mlp3'],
                 k11b[((8, 256, 256, 4), 64)]),
        entry_of('ppo_update[LunarLanderContinuous-v2, U=8]',
                 'elegantrl_tpu_torch/ops/csrc/ppo_update.cu',
                 'elegantrl_tpu/ops/pallas_update.py:79', ppo_l['ppo_update'], k2_lunar),
        entry_of('dqn_update[dqn,256x256,B=256]', 'elegantrl_tpu_torch/ops/csrc/dqn_update.cu',
                 'elegantrl_tpu/ops/pallas_update.py:476', dqn_l['dqn_update'],
                 k9_lunar['dqn']),
        entry_of('dqn_update[d3qn,256x256,B=256]', 'elegantrl_tpu_torch/ops/csrc/dqn_update.cu',
                 'elegantrl_tpu/ops/pallas_update.py:476',
                 entry['AgentD3QN']['dqn_variants']['d3qn'], k9_lunar['d3qn']),
    ]
    return kernels


# ------------------------------------------------------------ Mosaic probes

# each probe's output at the JAX script's inputs (tab = arange(T * R), day 3,
# i filled with 5): row r of an (R, 128) output, or every cell of an (8, 128) one
PROBE_EXPECTED = {
    'sublane_dynslice_value': lambda r: 888.0, 'sublane_dynslice_ref': lambda r: 888.0,
    'transpose_1xN': lambda r: float(r), 'dynslice_then_transpose': lambda r: 48.0 + r,
    'scalar_from_vmem': lambda r: 1400.0, 'lane_dynslice_ref': lambda r: 64.0 * r + 3,
    'fori_scalar_carry': lambda r: 448.0 + 8 * r}


def probe_phases(torch, dev, bound):
    """The seven Mosaic probes (``ops/probes.py``): each kernel exactly equal
    to the values the JAX script's probes give and to its plain version, at
    the script's inputs and at seeded random integer-valued tables and days
    (exact in any summation order); then the probes' entry point
    (``scripts/torch_probe_ops.py``) with the launch counts reset just
    before it.  Returns their entries of the kernels line."""
    import importlib.util
    from pathlib import Path
    from elegantrl_tpu_torch.ops import probes
    T, R, L = probes.T_DEFAULT, probes.R_DEFAULT, probes.LANES
    results = {}
    for name, (fn, ref) in probes.WRAPPERS.items():
        inputs = probes.probe_inputs(name, dev)
        got, want = fn(*inputs), ref(*inputs)
        torch.cuda.synchronize()
        rows = got.shape[0]
        expected = torch.tensor([[PROBE_EXPECTED[name](r)] * L for r in range(rows)],
                                device=dev)
        assert torch.equal(got, want) and torch.equal(got, expected), (
            'probe differs', name, got.flatten()[:4].tolist(), expected.flatten()[:4].tolist())
        g = torch.Generator().manual_seed(PROBES_SEED)
        random_cases = []
        for T_, R_ in ((T, R), (200, 151)):
            for _ in range(3):
                rin = probes.probe_inputs(name, dev, T_, R_, gen=g)
                a, b = fn(*rin), ref(*rin)
                torch.cuda.synchronize()
                assert torch.equal(a, b), ('probe differs on random inputs', name, T_, R_)
                random_cases.append((T_, R_))
        ms = cuda_ms(torch, lambda: fn(*inputs), reps=50, warmup=3)
        plain = cuda_ms(torch, lambda: ref(*inputs), reps=20, warmup=2)
        # bytes the function needs: the row(s) it reads, the index, the output
        read = {'transpose_1xN': R, 'fori_scalar_carry': probes.STEPS * R}.get(name, R + 1)
        b_ms, b_by = bound(0, 4 * (read + got.numel()))
        results[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
                             bound_by=b_by, first=got.flatten()[:4].tolist(),
                             random_cases=len(random_cases))
        emit(phase='probes_vs_plain', probe=name, out=tuple(got.shape),
             first_values=results[name]['first'], expected_at_script_inputs=True,
             random_inputs=sorted(set(random_cases)), bitwise_equal=True,
             **{k: v for k, v in results[name].items() if k != 'first'}, library_ms=None,
             tolerance='exact (integer-valued f32)')
    # the probes' entry point, as a user runs it
    path = Path(__file__).resolve().parent / 'scripts' / 'torch_probe_ops.py'
    spec = importlib.util.spec_from_file_location('torch_probe_ops', path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    for fn, _ in probes.WRAPPERS.values():
        fn.launches = 0
    script.main()
    launches = {name: fn.launches for name, (fn, _) in probes.WRAPPERS.items()}
    assert all(n == 1 for n in launches.values()), launches
    emit(phase='probes_entry_point', script='scripts/torch_probe_ops.py', launches=launches)
    return [{'name': f'mosaic_probe[{name}]', 'route': 'cuda',
             'source': 'elegantrl_tpu_torch/ops/csrc/probes.cu',
             'replaces': f'scripts/probe_mosaic_ops.py:{probes.PROBES[name][2]}',
             'launches': launches[name], 'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
             'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'], 'bound_by': r['bound_by'],
             'library_ms': None, 'main_path': 'scripts/torch_probe_ops.py (no training path)'}
            for name, r in results.items()]


PROBES_SEED = 17


def main():
    import torch
    from elegantrl_tpu_torch import Config, build_training, train_agent
    from elegantrl_tpu_torch.agents import (AgentA2C, AgentDiscreteA2C, AgentDiscretePPO,
                                            AgentPPO)
    from elegantrl_tpu_torch.agents.ppo import make_ppo, norm_state
    from elegantrl_tpu_torch.envs import (CartPoleEnv, HopperEnv, PendulumEnv,
                                          PointChasingDiscreteEnv, PointChasingVecEnv,
                                          StockTradingVecEnv)
    from elegantrl_tpu_torch.ops import _cuda_build
    from elegantrl_tpu_torch.ops.fused_rollout import (
        CARTPOLE_BODY, CHASING_BODY, CHASING_DISCRETE_BODY, HOPPER_BODY, KERNEL_ENV_BODIES,
        PENDULUM_BODY, ROLLOUT_CLUSTERS, noise_rows, rollout, rollout_reference,
        _library as fr_lib, rollout_smem_bytes as fr_smem)
    from elegantrl_tpu_torch.ops.fused_update import (PPO_PHASES, PPO_SMEM_BYTES, ppo_phase_ms,
                                                      ppo_update, ppo_update_reference,
                                                      _library as fu_lib)
    from elegantrl_tpu_torch.ops.kernels import _library as kn_lib, mlp3_smem_bytes
    from elegantrl_tpu_torch.utils.jax_params import ppo_state_from_numpy, ppo_state_to_numpy

    # ---- 1. device
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card',
              file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    part, (peak_tflops, peak_tbs) = peaks_for(name)
    emit(phase='device', name=name, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, peaks_from=part, fp32_tflops=peak_tflops,
         hbm_tb_s=peak_tbs)
    dev = torch.device('cuda')

    def bound(flop, nbytes):
        t_ops, t_bytes = flop / (peak_tflops * 1e12), nbytes / (peak_tbs * 1e12)
        return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops >= t_bytes else 'bytes')

    # ---- 2. build
    t0 = time.time()
    logs = _cuda_build.build(['fused_rollout', 'ppo_update', 'dqn_update', 'ddpg_update',
                              'sac_update', 'kernels', 'probes'])
    ptxas = {k: [ln.strip() for ln in v.splitlines() if 'registers' in ln or 'spill' in ln]
             for k, v in logs.items()}
    # the .cu files own the shared-memory layouts; the Python copies that
    # judge eligibility on the CPU must agree with them, for every body
    smem = {'ppo_update': (fu_lib().ppo_update_smem_bytes(), PPO_SMEM_BYTES)}
    for body in KERNEL_ENV_BODIES.values():
        for dims in (NET_DIMS, (64, 64), (256, 256), (96, 160)):
            for c in ROLLOUT_CLUSTERS:
                smem[f'fused_rollout[{body.env_name},{dims},cluster={c}]'] = (
                    fr_lib().fused_rollout_smem_bytes(body.kernel_id, *dims, c),
                    fr_smem(body, dims, c))
    smem.update(offpolicy_smem_pairs())
    smem.update(stock_smem_pairs())
    for dims in ((8, 128, 128, 2), (8, 256, 256, 4), (8, 128, 128, 1), (151, 128, 128, 15)):
        for rows, c in ((64, 1), (64, 8), (32, 4), (16, 2), (16, 8)):
            smem[f'fused_mlp3[{dims},rows={rows},cluster={c}]'] = (
                kn_lib().fused_mlp3_smem_bytes(*dims, rows, c), mlp3_smem_bytes(*dims, rows, c))
    assert all(a == b for a, b in smem.values()), smem
    emit(phase='build', seconds=round(time.time() - t0, 3), ptxas=ptxas,
         smem_bytes={k: v[0] for k, v in smem.items()})

    # ---- weights and env rows at full width, from a seed
    args = Config()
    args.net_dims = NET_DIMS
    agent = make_ppo(NET_DIMS, 3, 1, args)
    st = agent.init(0, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    st = st._replace(norm_avg=torch.tensor([0.1, -0.2, 0.3], device=dev),
                     norm_std=torch.tensor([0.9, 1.1, 2.0], device=dev))
    with torch.no_grad():
        st.act.std_log.fill_(-0.5)
    N, H = NUM_ENVS, HORIZON
    env_f = torch.stack([(torch.rand(N, generator=gen, device=dev) * 2 - 1) * math.pi,
                         torch.rand(N, generator=gen, device=dev) * 2 - 1]).contiguous()
    env_i = (torch.arange(N, device=dev, dtype=torch.int32) * 7 % 200)[None].contiguous()
    noise = torch.cat([torch.randn((H, 1, N), generator=gen, device=dev),
                       torch.rand((H, 2, N), generator=gen, device=dev)], 1).contiguous()
    seed = torch.tensor([20260, -77], dtype=torch.int32, device=dev)
    kw = dict(net_dims=NET_DIMS, horizon_len=H, reward_scale=1.0)
    roll_args = (st.act_flat, st.cri_flat, st.norm_avg, st.norm_std, env_f, env_i)
    D1, D2 = NET_DIMS

    def rollout_bound(body, n_params, dims=NET_DIMS):
        """Both nets per env-step; every input read and output written once."""
        S, A = body.state_dim, body.action_dim
        D1, D2 = dims
        flop = 2 * (2 * (S * D1 + D1 * D2) + D2 * (A + 1)) * N * H
        rows_in = body.n_f32 + body.n_i32
        nbytes = 4 * (n_params + rows_in * N + 2 + 2 * S
                      + N * H * (S + (1 if body.discrete else A) + 5) + rows_in * N)
        return bound(flop, nbytes)

    # ---- 3. fused rollout (Pendulum) against its plain version
    # Tolerance: values, logprobs and the one-step dynamics recomputed by
    # the plain version from the kernel's own stored states and actions
    # (teacher-forced) agree to 1e-4 (f32 sums in another order, FMA
    # contraction).  Whole trajectories agree to 2e-2: near upright the
    # pendulum is unstable at rate sqrt(15) /s, so over 64 steps (3.2 s) a
    # last-bit difference can grow by up to e^(3.87*3.2) ~ 2e5.  Flags
    # agree exactly.
    def same_runs(a, b):
        return all(torch.equal(getattr(a, f), getattr(b, f)) for f in a._fields)

    def cluster_ms(run, body, n, dims):
        """ms of the rollout kernel at each cluster size that fits, and the
        size it picks by itself."""
        out = {str(c): cuda_ms(torch, lambda: run(c), reps=5) for c in ROLLOUT_CLUSTERS
               if fr_smem(body, dims, c) <= 232448}
        out['picked'] = fr_lib().fused_rollout_cluster(body.kernel_id, n, *dims, 0)
        return out

    k1 = {}
    for mode, extra in (('injected', dict(noise=noise)), ('philox', dict(seed=seed))):
        got = rollout(*roll_args, **kw, **extra)
        again = rollout(*roll_args, **kw, **extra)
        want = rollout_reference(*roll_args, **kw, **extra)
        torch.cuda.synchronize()
        assert same_runs(got, again), 'K1: two runs differ'
        diffs = {f: float((getattr(got, f).float() - getattr(want, f).float()).abs().max())
                 for f in got._fields}
        assert torch.equal(got.truncates, want.truncates), 'K1 truncation flags differ'
        assert all(math.isfinite(v) and v <= 2e-2 for v in diffs.values()), diffs
        with torch.no_grad():
            x = norm_state(got.states.transpose(1, 2), st.norm_avg, st.norm_std)
            mean = st.act(x)[..., 0]
            std = torch.exp(st.act.std_log)[0, 0]
            z = (got.actions[:, 0] - mean) / std
            lp = -0.5 * z * z - torch.log(std) - 0.5 * math.log(2 * math.pi)
            v = st.cri(x)[..., 0]
            # one env step from each stored (state, action), where no reset follows
            cos_t, sin_t, thdot = got.states[:-1, 0], got.states[:-1, 1], got.states[:-1, 2]
            f = torch.stack([torch.atan2(sin_t, cos_t), thdot]).reshape(2, -1)
            f2, _, rew, _, _ = PENDULUM_BODY.step(
                f, torch.zeros_like(f[:1], dtype=torch.int32),
                torch.tanh(got.actions[:-1, 0]).reshape(1, -1))
            nxt = PENDULUM_BODY.obs(f2, None).reshape(3, H - 1, N).transpose(0, 1)
            keep = got.truncates[:-1].bool().logical_not()[:, None, :].expand_as(nxt)
        tf = {'logprobs': float((lp - got.logprobs).abs().max()),
              'values': float((v - got.values).abs().max()),
              'rewards': float((rew.reshape(H - 1, N) - got.rewards[:-1]).abs().max()),
              'next_states': float((nxt - got.states[1:]).abs()[keep].max())}
        assert all(d <= 1e-4 for d in tf.values()), tf
        k1[mode] = dict(max_abs_diff=diffs, teacher_forced=tf, z=z)
        emit(phase='k1_vs_plain', mode=mode, max_abs_diff=diffs, teacher_forced=tf,
             two_runs_bitwise=True, tolerance={'trajectory': 2e-2, 'teacher_forced': 1e-4})
    k1_ms = cuda_ms(torch, lambda: rollout(*roll_args, **kw, seed=seed), reps=20, warmup=2)
    k1_plain_ms = cuda_ms(torch, lambda: rollout_reference(*roll_args, **kw, seed=seed), reps=3)
    k1_bound, k1_by = rollout_bound(PENDULUM_BODY, st.act_flat.numel() + st.cri_flat.numel())
    k1_cluster = cluster_ms(lambda c: rollout(*roll_args, **kw, seed=seed, cluster=c),
                            PENDULUM_BODY, N, NET_DIMS)
    emit(phase='k1_cluster_ms', envs=N, cluster_ms=k1_cluster, ms=k1_ms, device=name,
         nvidia_smi=smi)

    # ---- 4. the Pendulum rollout's Philox draws
    z = k1['philox']['z'].reshape(-1)
    zm, zs = float(z.mean()), float(z.std())
    out = rollout(*roll_args, **kw, seed=seed)
    reset = out.truncates[:-1].bool()
    thdot_next = out.states[1:, 2][reset]
    assert z.numel() == 262144 and abs(zm) < 0.01 and abs(zs - 1) < 0.01, (zm, zs)
    assert bool(reset.any()) and float(thdot_next.abs().max()) <= 1.0
    emit(phase='k1_philox', draws=z.numel(), z_mean=zm, z_std=zs, bounds='|mean|<0.01, |std-1|<0.01',
         resets=int(reset.sum()), max_abs_reset_thdot=float(thdot_next.abs().max()))

    # ---- 5. fused PPO update against its plain version
    # Tolerance: per buffer, the kernel's update (new - old) is within
    # 5e-3 of the largest plain update of that buffer; objectives within
    # 1e-4 relative at U=1 and 1e-3 at U=32 (32 steps compound rounding).
    hp = dict(net_dims=NET_DIMS, ratio_clip=0.25, lambda_entropy=0.001, lr=6e-5,
              clip_grad=3.0)

    def update_vs_plain(state, S, A, discrete, U, phase, dims=NET_DIMS, **hyper):
        g2 = torch.Generator(device=dev).manual_seed(100 + U)
        sb = torch.randn((U, S, BATCH), generator=g2, device=dev)
        if discrete:   # one-hot rows of uniformly drawn actions; logprobs near -log A
            index = torch.randint(0, A, (U, BATCH), generator=g2, device=dev)
            ab = torch.nn.functional.one_hot(index, A).float().transpose(1, 2).contiguous()
            lpb = torch.randn((U, BATCH), generator=g2, device=dev) * 0.3 - math.log(A)
        else:
            ab = torch.randn((U, A, BATCH), generator=g2, device=dev)
            lpb = torch.randn((U, BATCH), generator=g2, device=dev) * 0.3 - 1.2
        block = [sb, ab, lpb,
                 torch.randn((U, BATCH), generator=g2, device=dev),
                 torch.randn((U, BATCH), generator=g2, device=dev),
                 (torch.rand((U, BATCH), generator=g2, device=dev) > 0.05).float()]
        base = [state.act_flat, state.cri_flat, state.act_opt.mu + 1e-4,
                state.act_opt.nu + 1e-8, state.cri_opt.mu + 1e-4, state.cri_opt.nu + 1e-8]
        norm = (state.norm_avg, state.norm_std)
        hyper = dict(hp, net_dims=dims, discrete=discrete, **hyper)
        runs = {}
        for key, fn in (('kernel', ppo_update), ('again', ppo_update),
                        ('plain', ppo_update_reference)):
            bufs = [b.clone() for b in base]
            objs = fn(*bufs, 5, 5, *norm, *block, **hyper)
            torch.cuda.synchronize()
            runs[key] = (bufs, objs)
        (kb, ko), (pb, po) = runs['kernel'], runs['plain']
        again = runs['again'][0] + [runs['again'][1]]
        assert all(torch.equal(x, y) for x, y in zip(kb + [ko], again)), f'{phase}: two runs differ'
        rel = [float(((k - b) - (p - b)).abs().max() / (p - b).abs().max())
               for k, p, b in zip(kb, pb, base)]
        err = max(float(((k - b) - (p - b)).abs().max()) for k, p, b in zip(kb, pb, base))
        obj_rel = float(((ko - po).abs() / po.abs().clamp_min(1e-6)).max())
        assert all(r <= 5e-3 for r in rel), rel
        assert obj_rel <= (1e-4 if U == 1 else 1e-3), obj_rel
        bufs = [b.clone() for b in base]
        ms = cuda_ms(torch, lambda: ppo_update(*bufs, 5, 5, *norm, *block, **hyper),
                     reps=20, warmup=2)
        trace = torch.zeros((U, len(PPO_PHASES) + 1), dtype=torch.int64, device=dev)
        ppo_update(*bufs, 5, 5, *norm, *block, **hyper, trace=trace)
        torch.cuda.synchronize()
        phases = ppo_phase_ms(trace)
        # one CUDA kernel launch a call, whatever U is (3 calls profiled)
        launched = device_kernels(torch, lambda: ppo_update(*bufs, 5, 5, *norm, *block, **hyper))
        assert len(launched) == 3 and all('ppo_update_kernel' in k for k in launched), launched
        plain = cuda_ms(torch, lambda: ppo_update_reference(*bufs, 5, 5, *norm, *block, **hyper),
                        reps=3)
        P = state.act_flat.numel() + state.cri_flat.numel()
        D1, D2 = dims
        # 2 nets, forward + backward (2x), 2 FLOP per multiply-add
        flop = 3 * 2 * (2 * (S * D1 + D1 * D2) + D2 * (A + 1)) * BATCH * U
        nbytes = 4 * (2 * 3 * P + U * BATCH * (S + A + 4) + 2 * S + U * 3)
        b_ms, b_by = bound(flop, nbytes)
        emit(phase=phase, U=U, B=BATCH, S=S, A=A, net_dims=dims, rel_update_diff=rel,
             max_abs_err=err, objective_rel_diff=obj_rel, two_runs_bitwise=True,
             device_kernels_a_call=len(launched) / 3, ms=ms, plain_ms=plain, bound_ms=b_ms,
             bound_by=b_by, ppo_phase_ms=phases)
        return dict(ms=ms, plain_ms=plain, max_abs_err=err, bound_ms=b_ms, bound_by=b_by)

    k2 = {U: update_vs_plain(st, 3, 1, False, U, 'k2_vs_plain') for U in (1, 32)}
    # ppo_lunarlander_cont's update: S = 8, A = 2, B = 512, U = 8
    lunar_cfg = Config()
    lunar_cfg.net_dims = NET_DIMS
    st_lunar = make_ppo(NET_DIMS, 8, 2, lunar_cfg).init(0, dev)
    with torch.no_grad():
        st_lunar.act.std_log.fill_(-0.5)
    k2_lunar = update_vs_plain(st_lunar, 8, 2, False, 8, 'k2_vs_plain_lunar')
    # K2 at (512, 512), B = 512: a width the JAX package sends to its kernel
    # (float32 compute) that the first design refused (shared memory)
    wide_cfg = Config()
    wide_cfg.net_dims, wide_cfg.compute_dtype = (512, 512), 'float32'
    st_wide = make_ppo((512, 512), 3, 1, wide_cfg).init(0, dev)
    with torch.no_grad():
        st_wide.act.std_log.fill_(-0.5)
    k2_wide = update_vs_plain(st_wide, 3, 1, False, 1, 'k2_vs_plain_wide', dims=(512, 512))

    # ---- 6. fused rollout, the other bodies and the categorical head
    # One-step check (injected noise): the kernel and the plain version each
    # take ONE step from every (env rows, noise) pair that the plain rollout
    # visits, 262,144 at once, so nothing is amplified: values, logprobs,
    # rewards, stored states, continuous actions and next env rows (after
    # the masked reset) agree to 1e-4 (f32 sums in another order, FMA
    # contraction, the libraries' sin/cos/exp/log); flags, step counters and
    # discrete actions are equal, but for at most 8 samples that sit within
    # rounding of a hard threshold (|x| > 2.4, z < 0.25, distance < 2, a
    # touchdown, a Gumbel-max near-tie), which are counted and left out of
    # the rest.
    # Whole trajectories: CartPole, the hopper (touchdown, liftoff) and the
    # argmax have hard thresholds, so one last-bit difference parts a lane
    # from its twin for good.  A lane counts as parted from the first step
    # where any output differs by more than 2e-2 or a flag or discrete action
    # differs; at most 1% of the 4096 lanes may part in 64 steps, and every
    # other lane agrees everywhere, final env rows included.
    def body_state(body, dims=NET_DIMS):
        S, A = body.state_dim, body.action_dim
        a = Config()
        a.net_dims = dims
        s = make_ppo(dims, S, A, a, discrete=body.discrete).init(0, dev)
        g = torch.Generator(device=dev).manual_seed(11)
        s = s._replace(norm_avg=torch.rand(S, generator=g, device=dev) * 0.4 - 0.2,
                       norm_std=torch.rand(S, generator=g, device=dev) + 0.7)
        if not body.discrete:
            with torch.no_grad():
                s.act.std_log.fill_(-0.5)
        return s

    def body_noise(body, g, h, n):
        A, n_env = body.action_dim, body.n_step + body.n_reset
        head = (torch.rand if body.discrete else torch.randn)((h, A, n), generator=g, device=dev)
        return torch.cat([head, torch.rand((h, n_env, n), generator=g, device=dev)], 1).contiguous()

    def fields_differ(got, want, tol):
        """(H, N) bool: a flag or discrete action differs, or a float output
        differs by more than ``tol``; and the largest float difference."""
        bad = torch.zeros_like(got.logprobs, dtype=torch.bool)
        worst = got.logprobs.new_zeros(got.logprobs.shape)
        for f in got._fields[:7]:
            a, b = getattr(got, f), getattr(want, f)
            if a.dim() == 3:
                a, b = a.transpose(0, 1), b.transpose(0, 1)          # (rows, H, N)
            else:
                a, b = a[None], b[None]
            if f in ('terminals', 'truncates') or not a.dtype.is_floating_point:
                bad |= (a != b).any(0)
            else:
                worst = torch.maximum(worst, (a - b).abs().amax(0))
        return bad | (worst > tol), worst

    def check_body(body, env_class, dims=NET_DIMS, phase='k3_vs_plain'):
        S, A = body.state_dim, body.action_dim
        tag = f'fused_rollout[{body.env_name},{"categorical" if body.discrete else "gaussian"}]'
        s = body_state(body, dims)
        g = torch.Generator(device=dev).manual_seed(21)
        env_def = env_class(num_envs=1)._def
        f0, i0 = body.pack(env_def.init(g, N, dev))
        # stagger the step counters so that the time limit fires in some lanes
        i0 = (torch.arange(N, device=dev, dtype=torch.int32) * 37 % env_def.spec.max_step)[None]
        if body is HOPPER_BODY:   # a random policy rarely falls within 64 steps:
            f0[1, :64], f0[3, :64] = 0.27, -3.0      # drop some lanes below 0.25
        f0, i0 = f0.contiguous(), i0.contiguous()
        nz = body_noise(body, g, H, N)
        net = (s.act_flat, s.cri_flat, s.norm_avg, s.norm_std)
        bkw = dict(net_dims=dims, reward_scale=1.0, body=body)
        report = {}
        for mode, extra in (('injected', dict(noise=nz)), ('philox', dict(seed=seed))):
            trace = []
            got = rollout(*net, f0, i0, horizon_len=H, **bkw, **extra)
            again = rollout(*net, f0, i0, horizon_len=H, **bkw, **extra)
            want = rollout_reference(*net, f0, i0, horizon_len=H, env_trace=trace, **bkw, **extra)
            torch.cuda.synchronize()
            assert same_runs(got, again), (tag, mode, 'two runs differ')
            differ, worst = fields_differ(got, want, 2e-2)
            parted = differ.any(0)                                     # (N,)
            end_diff = torch.maximum((got.env_f - want.env_f).abs().amax(0),
                                     (got.env_i != want.env_i).any(0).float())
            share = float(parted.float().mean())
            kept = ~parted
            assert share <= 0.01, (tag, mode, share)
            assert float(end_diff[kept].max()) <= 2e-2, (tag, mode, float(end_diff[kept].max()))
            assert all(bool(torch.isfinite(getattr(got, f).float()).all()) for f in got._fields)
            flags = {'terminals': int(got.terminals.sum()), 'truncates': int(got.truncates.sum())}
            # Pendulum has no terminal state: its time limit fires instead
            assert flags['truncates' if body is PENDULUM_BODY else 'terminals'] > 0, (tag, flags)
            report[mode] = dict(lanes_parted=int(parted.sum()), share_parted=share,
                                max_abs_diff_kept=float(worst[:, kept].max()), **flags)
        # the one-step check, on the injected-noise trajectory's visited rows
        f_all = torch.cat([f for f, _ in trace], dim=1).contiguous()        # (F, H*N)
        i_all = torch.cat([i for _, i in trace], dim=1).contiguous()
        nz_all = nz.transpose(0, 1).reshape(1, noise_rows(body), H * N).contiguous()
        got = rollout(*net, f_all, i_all, horizon_len=1, noise=nz_all, **bkw)
        want = rollout_reference(*net, f_all, i_all, horizon_len=1, noise=nz_all, **bkw)
        torch.cuda.synchronize()
        flip, _ = fields_differ(got, want, float('inf'))
        # a next env row that is off by more than 0.25 after ONE step is a
        # branch taken the other way (the hopper's touchdown or liftoff)
        flip = (flip[0] | (got.env_i != want.env_i).any(0)
                | ((got.env_f - want.env_f).abs().amax(0) > 0.25))
        n_flip = int(flip.sum())
        assert n_flip <= 8, (tag, n_flip)
        ok = ~flip
        one = {}
        for f in got._fields:
            a, b = getattr(got, f), getattr(want, f)
            if a.dtype.is_floating_point:
                one[f] = float((a - b).abs()[..., ok].max())
        assert all(d <= 1e-4 for d in one.values()), (tag, one)
        ms = cuda_ms(torch, lambda: rollout(*net, f0, i0, horizon_len=H, seed=seed, **bkw),
                     reps=20, warmup=2)
        plain_ms = cuda_ms(torch, lambda: rollout_reference(*net, f0, i0, horizon_len=H,
                                                            seed=seed, **bkw), reps=2)
        b_ms, b_by = rollout_bound(body, s.act_flat.numel() + s.cri_flat.numel(), dims)
        # the time at each cluster size, at 4096 envs and at the 1024 of the
        # train_agent runs below
        by_c = {n: cluster_ms(lambda c: rollout(*net, f0[:, :n].contiguous(),
                                                i0[:, :n].contiguous(), horizon_len=H,
                                                seed=seed, cluster=c, **bkw), body, n, dims)
                for n in (N, 1024)}
        emit(phase=phase, kernel=tag, net_dims=dims, trajectory=report, one_step=one,
             one_step_threshold_flips=n_flip, two_runs_bitwise=True, ms=ms, plain_ms=plain_ms,
             bound_ms=b_ms, bound_by=b_by, cluster_ms=by_c,
             tolerance={'trajectory': 2e-2, 'share_parted': 0.01, 'one_step': 1e-4,
                        'threshold_flips': 8})
        return dict(name=tag, ms=ms, plain_ms=plain_ms, max_abs_err=max(one.values()),
                    bound_ms=b_ms, bound_by=b_by, cluster_ms=by_c)

    k3 = {body.env_name: check_body(body, env_class) for body, env_class in (
        (CARTPOLE_BODY, CartPoleEnv), (HOPPER_BODY, HopperEnv),
        (CHASING_BODY, PointChasingVecEnv), (CHASING_DISCRETE_BODY, PointChasingDiscreteEnv))}
    # K1 and K3 at (256, 256): widths the JAX runner takes its kernel at, which
    # the first design refused (both nets in one block); the same checks
    k13_wide = {body.env_name: check_body(body, env_class, (256, 256), 'k13_vs_plain_wide')
                for body, env_class in ((PENDULUM_BODY, PendulumEnv),
                                        (CARTPOLE_BODY, CartPoleEnv))}

    # the Gumbel-max sample on fixed logits (zero actor weights, the logits
    # as the output bias): action frequencies over 262,144 Philox draws are
    # within 0.005 of softmax(logits) (three standard errors are 0.003)
    gumbel = {}
    for body in (CARTPOLE_BODY, CHASING_DISCRETE_BODY):
        s = body_state(body)
        logits = torch.linspace(-1.0, 1.0, body.action_dim, device=dev)
        with torch.no_grad():
            s.act_flat.zero_()
            s.act.mlp.layers[-1].bias.copy_(logits)
        f0 = torch.zeros((body.n_f32, N), device=dev)
        if body is CHASING_DISCRETE_BODY:   # the walker far away: no lane terminates
            f0[4:6], f0[8] = -16.0, 22.6
        out = rollout(s.act_flat, s.cri_flat, s.norm_avg, s.norm_std, f0,
                      torch.zeros((1, N), dtype=torch.int32, device=dev), net_dims=NET_DIMS,
                      horizon_len=H, reward_scale=1.0, body=body, seed=seed)
        freq = torch.bincount(out.actions.reshape(-1).long(), minlength=body.action_dim) / (H * N)
        dfreq = float((freq - torch.softmax(logits, 0)).abs().max())
        dlp = float((out.logprobs - torch.log_softmax(logits, 0)[out.actions.long()]).abs().max())
        assert dfreq <= 0.005 and dlp <= 1e-5, (body.env_name, dfreq, dlp)
        gumbel[body.env_name] = dict(max_freq_diff=dfreq, max_logp_diff=dlp)
    # the chasing reset's Box-Muller normals: every lane starts at t = 1023,
    # terminates at step 0 and shows its fresh p0 and p1 + 8 at step 1
    s = body_state(CHASING_BODY)
    f0 = torch.zeros((CHASING_BODY.n_f32, 16 * N), device=dev)
    f0[4:6], f0[8] = -8.0, 11.3
    out = rollout(s.act_flat, s.cri_flat, s.norm_avg, s.norm_std, f0,
                  torch.full((1, 16 * N), 1023, dtype=torch.int32, device=dev),
                  net_dims=NET_DIMS, horizon_len=2, reward_scale=1.0, body=CHASING_BODY, seed=seed)
    assert bool(out.terminals[0].all()) and not bool(out.truncates.any())
    fresh = torch.cat([out.states[1, 0:2].reshape(-1), out.states[1, 4:6].reshape(-1) + 8.0])
    fm, fs = float(fresh.mean()), float(fresh.std())
    walker = out.env_f[2:4]
    assert abs(fm) < 0.01 and abs(fs - 1) < 0.01, (fm, fs)
    assert 0.0 <= float(walker.min()) and float(walker.max()) < 1.0
    emit(phase='k3_sampling', gumbel_max=gumbel, bounds='freq 0.005, logp 1e-5',
         chasing_reset_normals=dict(draws=fresh.numel(), mean=fm, std=fs,
                                    bounds='|mean|<0.01, |std-1|<0.01'))

    # ---- 7. fused PPO update, discrete head, against its plain version
    # (tolerances as for the continuous head; lambda_entropy 0.01 is the
    # discrete agents' default)
    k5 = {}
    for body in (CARTPOLE_BODY, CHASING_DISCRETE_BODY):
        s = body_state(body)
        for U in (1, 32):
            k5[(body.action_dim, U)] = update_vs_plain(
                s, body.state_dim, body.action_dim, True, U, 'k5_vs_plain', lambda_entropy=0.01)

    # ---- 7b. K2 at ppo_stock's widths (S = 151, A = 15, batch 512: the block
    # count and reduce of the stock main path's update), U = 2; tolerances as
    # at the other widths
    stock_body = StockTradingVecEnv(num_envs=1)._def.kernel_body
    k2_stock = update_vs_plain(body_state(stock_body), stock_body.state_dim,
                               stock_body.action_dim, False, 2, 'k2_vs_plain_stock')

    # ---- 8 and 9. the main paths
    pendulum = (AgentPPO, PendulumEnv, 'Pendulum-v1', 3, 1, False, 200)
    cartpole = (AgentDiscretePPO, CartPoleEnv, 'CartPole-v1', 4, 2, True, 500)

    def bench_args(task, num_envs, horizon, batch):
        agent_class, env_class, env_name, S, A, discrete, max_step = task
        a = Config(agent_class, env_class,
                   {'env_name': env_name, 'num_envs': num_envs, 'max_step': max_step,
                    'state_dim': S, 'action_dim': A, 'if_discrete': discrete})
        a.horizon_len, a.batch_size, a.repeat_times = horizon, batch, REPEAT
        a.net_dims, a.random_seed = NET_DIMS, 0
        return a

    def reset_counts():
        rollout.launches = ppo_update.launches = 0
        rollout.launches_by_body.clear()
        for k in ppo_update.launches_by_head:
            ppo_update.launches_by_head[k] = 0

    def read_counts():
        return dict(rollout.launches_by_body), dict(ppo_update.launches_by_head)

    def small_round_vs_cpu(task, body, phase):
        """A small round on the card (both kernels) against the same round
        on the CPU (both plain versions), same weights, noise and ids.
        Tolerance: objectives 1e-3 relative, updates 2e-2 of each buffer's
        largest (the rollout's f32 rounding reaches the advantages)."""
        g3 = torch.Generator(device='cpu').manual_seed(3)
        A, n_env = body.action_dim, body.n_step + body.n_reset
        head = (torch.rand if body.discrete else torch.randn)((32, A, 256), generator=g3)
        small_noise = torch.cat([head, torch.rand((32, n_env, 256), generator=g3)], 1)
        small_ids = torch.randint(0, 32 * 256, (2, 128), generator=g3)
        small, start_state = {}, None
        for device in ('cuda', 'cpu'):
            a = bench_args(task, 256, 32, 128)
            a.device = device
            ctx = build_training(a)
            assert ctx.fused_rollout
            carry0 = ctx.carry
            if start_state is None:   # snapshot: the round updates params in place
                start_state = (ppo_state_to_numpy(carry0.agent_state),
                               [x.cpu() for x in carry0.env_state], carry0.obs.cpu())
            else:                     # the CPU round starts where the card's did
                carry0 = carry0._replace(
                    agent_state=ppo_state_from_numpy(start_state[0], device),
                    env_state=type(carry0.env_state)(*start_state[1]), obs=start_state[2])
            before = [carry0.agent_state.act_flat.clone(), carry0.agent_state.cri_flat.clone()]
            c, m = ctx.round_fn(carry0, noise=small_noise.to(device).contiguous(),
                                ids=small_ids.to(device))
            m = scalars(m)
            small[device] = ({k: float(v) for k, v in m.items()},
                             [(c.agent_state.act_flat - before[0]).cpu(),
                              (c.agent_state.cri_flat - before[1]).cpu()])
        (mg, dg), (mc, dc) = small['cuda'], small['cpu']
        obj_rel = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-6) for k in mc}
        upd_rel = [float((g - p).abs().max() / p.abs().max()) for g, p in zip(dg, dc)]
        assert all(r <= 1e-3 for r in obj_rel.values()), obj_rel
        assert all(r <= 2e-2 for r in upd_rel), upd_rel
        emit(phase=phase, envs=256, horizon=32, batch=128,
             objective_rel_diff=obj_rel, update_rel_diff=upd_rel)

    def timed_rounds(task, body, head, phase, kernel_ms):
        a = bench_args(task, NUM_ENVS, HORIZON, BATCH)
        ctx = build_training(a)
        carry, _ = ctx.round_fn(ctx.carry)                      # warm-up round
        p0 = [carry.agent_state.act_flat.clone(), carry.agent_state.cri_flat.clone()]
        torch.cuda.synchronize()
        reset_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = []
        for _ in range(ROUNDS):
            carry, m = ctx.round_fn(carry)
            m = scalars(m)
            metrics.append(torch.stack([m[k].float() for k in sorted(m)]))
        end.record()
        torch.cuda.synchronize()
        by_body, by_head = read_counts()
        launches = {'fused_rollout': by_body.get(body.env_name, 0), 'ppo_update': by_head[head]}
        round_ms = start.elapsed_time(end) / ROUNDS
        mvals = torch.stack(metrics).cpu()
        moved = max(float((carry.agent_state.act_flat - p0[0]).abs().max()),
                    float((carry.agent_state.cri_flat - p0[1]).abs().max()))
        assert launches == {'fused_rollout': ROUNDS, 'ppo_update': ROUNDS}, launches
        assert rollout.launches == ROUNDS and ppo_update.launches == ROUNDS
        assert bool(torch.isfinite(mvals).all()), mvals
        assert moved > 0.0
        emit(phase=phase, agent=task[0].__name__, env=task[2], envs=NUM_ENVS, horizon=HORIZON,
             batch=BATCH, repeat=REPEAT, net_dims=NET_DIMS, rounds=ROUNDS, launches=launches,
             round_ms=round_ms, env_steps_per_s=NUM_ENVS * HORIZON / (round_ms / 1e3),
             **kernel_ms, metrics=dict(zip(sorted(m), mvals[-1].tolist())),
             max_param_change=moved, device=name, nvidia_smi=smi)
        return launches

    small_round_vs_cpu(pendulum, PENDULUM_BODY, 'main_path_small_vs_cpu')

    # on the card nothing falls back to a plain version where the JAX package
    # takes a kernel: asking for the plain version, or a workload that the
    # JAX package sends to its kernel and this kernel does not fit, raises
    # (the rollout's weight slices at (384, 384) exceed a cluster of 8).  Where
    # the JAX package runs XLA ops the card runs PyTorch ops and says so: A2C's
    # update (no kernel in either package), and both halves of a 3-hidden-layer
    # PPO (the generic rollout and the autograd update).
    import contextlib
    import io
    refused = {}
    for task in (pendulum, cartpole):
        for flag, setting in (('use_fused_rollout', ('use_fused_rollout', False)),
                              ('use_fused_rollout', ('net_dims', (384, 384))),
                              ('use_fused_update', ('use_fused_update', False))):
            a = bench_args(task, 256, 32, 128)
            setattr(a, *setting)
            try:
                build_training(a)
                raise AssertionError(f'build_training took a plain path on the card: {setting}')
            except ValueError as e:
                assert str(e).startswith(flag), e
                refused[f'{task[0].__name__} {setting}'] = str(e)[:80]
    a2c = bench_args((AgentA2C,) + pendulum[1:], 256, 32, 128)
    a2c.use_fused_update = False
    ctx = build_training(a2c)
    reset_counts()
    _, m = ctx.round_fn(ctx.carry)
    assert ctx.fused_rollout and math.isfinite(float(m['obj_actor']))
    assert read_counts() == ({'Pendulum-v1': 1}, {'continuous': 0, 'discrete': 0})
    deep = bench_args(pendulum, 256, 32, 128)
    deep.net_dims = (16,) * 3
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        ctx = build_training(deep)
    said = text.getvalue()
    reset_counts()
    _, m = ctx.round_fn(ctx.carry)
    assert not ctx.fused_rollout and math.isfinite(float(m['obj_critic']))
    assert ('use_fused_rollout: PyTorch path' in said and 'use_fused_update: PyTorch path' in said)
    assert read_counts() == ({}, {'continuous': 0, 'discrete': 0})
    emit(phase='no_plain_path_on_card', refused=refused, a2c_builds=True,
         three_layers='the generic rollout and the autograd update on the card, said so')

    launches = timed_rounds(pendulum, PENDULUM_BODY, 'continuous', 'main_path', dict(
        fused_rollout_ms=k1_ms, fused_rollout_plain_ms=k1_plain_ms,
        ppo_update_ms=k2[1]['ms'], ppo_update_plain_ms=k2[1]['plain_ms']))

    small_round_vs_cpu(cartpole, CARTPOLE_BODY, 'main_path_cartpole_small_vs_cpu')
    cart = k3['CartPole-v1']
    launches_cart = timed_rounds(cartpole, CARTPOLE_BODY, 'discrete', 'main_path_cartpole', dict(
        fused_rollout_ms=cart['ms'], fused_rollout_plain_ms=cart['plain_ms'],
        ppo_update_ms=k5[(2, 1)]['ms'], ppo_update_plain_ms=k5[(2, 1)]['plain_ms']))

    # ---- 10. the entry point
    def run_train_agent(task, num_envs, horizon, batch, periods, rounds_per_period=1, **hyper):
        with tempfile.TemporaryDirectory() as cwd:
            a = bench_args(task, num_envs, horizon, batch)
            a.cwd = cwd
            a.eval_per_step = num_envs * horizon * rounds_per_period
            a.break_step = a.eval_per_step * (periods - 1)
            for k, v in hyper.items():
                setattr(a, k, v)
            reset_counts()
            t0 = time.time()
            res = train_agent(a)
            by_body, by_head = read_counts()
            assert res['recorder'].shape[0] == periods and math.isfinite(res['max_r'])
            emit(phase='train_agent', agent=task[0].__name__, env=task[2], envs=num_envs,
                 evaluations=int(res['recorder'].shape[0]), total_step=int(res['total_step']),
                 max_r=float(res['max_r']), seconds=round(time.time() - t0, 3),
                 rollout_launches=by_body, update_launches=by_head)
            return by_body, by_head

    run_train_agent(pendulum, NUM_ENVS, HORIZON, BATCH, 2)
    by_body, by_head = run_train_agent(cartpole, NUM_ENVS, HORIZON, BATCH, 2)
    assert by_body == {'CartPole-v1': 2} and by_head['discrete'] == 2, (by_body, by_head)
    entry = {}
    hopper = (AgentPPO, HopperEnv, 'HopperSlip-v0', 6, 2, False, 1000)
    chasing = (AgentPPO, PointChasingVecEnv, 'PointChasingVecEnv', 8, 2, False, 1024)
    chasing_disc = (AgentDiscreteA2C, PointChasingDiscreteEnv, 'PointChasingDiscreteEnv',
                    8, 9, True, 1024)
    for task, batch in (((AgentA2C,) + pendulum[1:], 16), (hopper, BATCH), (chasing, BATCH),
                        (chasing_disc, 16)):
        by_body, by_head = run_train_agent(task, 1024, HORIZON, batch, 2, rounds_per_period=2,
                                           eval_times=2)
        a2c_task = 'A2C' in task[0].__name__
        assert by_body == {task[2]: 4}, (task[2], by_body)
        assert sum(by_head.values()) == (0 if a2c_task else 4), (task[2], by_head)
        entry[task[2]] = by_body[task[2]]

    # ---- 11. the off-policy family
    offpolicy_kernels, k9_lunar = offpolicy_phases(torch, dev, name, smi, bound, seed)

    # ---- 13. StockTradingEnv-v2 (K4)
    stock_kernels = stock_phases(torch, dev, name, smi, bound, seed, k2_stock)

    # ---- 14. LunarLander (K10, K11a, K11b; K2 and K9 at the slice's widths)
    lunar_kernels = lunar_phases(torch, dev, name, smi, bound, k2_lunar, k9_lunar)

    # ---- 15. the Mosaic probes
    probe_kernels = probe_phases(torch, dev, bound)

    # ---- 16. kernels line and device line
    k1_err = max(max(k1[m]['max_abs_diff'].values()) for m in k1)
    rollout_src = 'elegantrl_tpu_torch/ops/csrc/fused_rollout.cu'
    update_src = 'elegantrl_tpu_torch/ops/csrc/ppo_update.cu'
    kernels = [
        {'name': 'fused_rollout', 'route': 'cuda', 'source': rollout_src,
         'replaces': 'elegantrl_tpu/ops/pallas_rollout.py:600',
         'launches': launches['fused_rollout'], 'max_abs_err': k1_err, 'ms': k1_ms,
         'plain_ms': k1_plain_ms, 'bound_ms': k1_bound, 'bound_by': k1_by,
         'library_ms': None, 'cluster_ms': k1_cluster, 'wide': k13_wide['Pendulum-v1']},
        {'name': 'ppo_update', 'route': 'cuda', 'source': update_src,
         'replaces': 'elegantrl_tpu/ops/pallas_update.py:79',
         'launches': launches['ppo_update'], 'max_abs_err': k2[1]['max_abs_err'],
         'ms': k2[1]['ms'], 'plain_ms': k2[1]['plain_ms'], 'bound_ms': k2[1]['bound_ms'],
         'bound_by': k2[1]['bound_by'], 'library_ms': None,
         'u32': k2[32], 'wide': k2_wide},
    ]
    # the CartPole instantiation's launches are the CartPole main path's 10
    # rounds; the other bodies' are their train_agent runs above
    for env_name, k in k3.items():
        n = launches_cart['fused_rollout'] if env_name == 'CartPole-v1' else entry[env_name]
        kernels.append({'name': k['name'], 'route': 'cuda', 'source': rollout_src,
                        'replaces': 'elegantrl_tpu/ops/pallas_rollout.py:600', 'launches': n,
                        'max_abs_err': k['max_abs_err'], 'ms': k['ms'],
                        'plain_ms': k['plain_ms'], 'bound_ms': k['bound_ms'],
                        'bound_by': k['bound_by'], 'library_ms': None,
                        'cluster_ms': k['cluster_ms'],
                        **({'wide': k13_wide[env_name]} if env_name in k13_wide else {})})
    d = k5[(2, 1)]
    kernels.append({'name': 'ppo_update[discrete]', 'route': 'cuda', 'source': update_src,
                    'replaces': 'elegantrl_tpu/ops/pallas_update.py:79',
                    'launches': launches_cart['ppo_update'], 'max_abs_err': d['max_abs_err'],
                    'ms': d['ms'], 'plain_ms': d['plain_ms'], 'bound_ms': d['bound_ms'],
                    'bound_by': d['bound_by'], 'library_ms': None,
                    'u32': k5[(2, 32)], 'a9_u1': k5[(9, 1)], 'a9_u32': k5[(9, 32)]})
    kernels += offpolicy_kernels + stock_kernels + lunar_kernels + probe_kernels
    assert all(k['launches'] > 0 for k in kernels), [(k['name'], k['launches']) for k in kernels]
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                             'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
