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
   (and K2 at the stock widths), with the checks of 5; then the bf16
   variants of K1/K3 (bf16 weight slices and tiles, f32 sums) against the
   plain version in bf16, both storage types, at (128, 128), (128, 64) and
   (512, 512) (``k1_bf16_vs_plain``, ``k3_bf16_vs_plain``, ``BF16_TOL``);
8. the Pendulum main path: ``build_training`` at the bench config (4096
   envs, H=64, B=512, repeat 8, (128, 128)), one small round against the
   same round on the CPU, then 10 timed rounds with the launch counts reset
   just before them; the card refuses every plain path where the JAX
   package takes a kernel;
9. the CartPole main path, ``AgentDiscretePPO`` at the same sizes, likewise;
   then the bf16 main paths: ``main_path_bf16`` (``ppo_pendulum_bf16``'s
   shape), ``main_path_cartpole_bf16_storage`` and ``main_path_wide_auto``
   (PPO at (512, 512) with the default ``compute_dtype='auto'``), each 10
   rounds through the K1/K3 bf16 variant, K10 and the autograd update (no
   K2, no K11b, as the JAX package under bf16), and the card raising past
   the widest bf16 width (``bf16_width_limit``);
10. the entry point: ``train_agent`` for PPO on Pendulum and discrete PPO on
    CartPole (two evaluation periods each) and, shorter, A2C on Pendulum,
    PPO on HopperSlip, PPO on PointChasing and discrete A2C on
    PointChasingDiscrete, so every agent class and env body has run on the
    card through the entry point;
11. the off-policy family (``offpolicy_phases``): the off-policy rollout
    kernel's fifteen (body, head) instantiations, the ddpg, sac and modsac
    heads on the three continuous bodies and the DQN heads on the two
    discrete ones, against their plain version (``k6_vs_plain``, both noise
    modes, two runs bitwise equal, the time at each cluster size), TD3 and
    SAC on HopperSlip and DQN on CartPole at (256, 256)
    (``k6_vs_plain_wide``), the bf16 variant of every pair in both storage
    types (``k6_bf16_vs_plain``), the DQN-family update chunk's four variants (``k9_vs_plain``),
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
    without updates, then 10 timed rounds, and path A with bf16 compute
    (``main_path_td3_hopper_bf16``: K6's bf16 variant, K7) and with bf16
    compute and storage (``main_path_td3_hopper_bf16_storage``: the bf16
    ring and the autograd update); ``train_agent`` for every
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
    and the kernel's time at each cluster size (``k4_vs_plain``), the critic
    pass there on states whose lane groups share their market rows (its
    precondition, asserted), within ``CRITIC_TOL`` of the full MLP while a
    1xTF32 emulation of it is not, two runs bitwise equal, with its bounds counting
    the market columns once per (step, group) and in full, and on the tensor
    cores in split-3xTF32; K4 and the critic pass at (256, 256)
    (``k4_vs_plain_wide``) and the critic pass at (448, 448), on 64-sample
    tiles (``critic_vs_plain_448``); the ddpg, sac and modsac heads on the stock body
    (``k4_offpolicy_vs_plain``, two runs bitwise equal); the reset's and the head's Philox draws
    (``k4_philox``); the ``ppo_stock`` main path (a small round against the
    CPU, then 10 timed rounds: 10 K4 rollouts, 10 critic passes, 10 K2
    updates) and the ``ppo_stock_4k`` one (10 K4 rollouts and critic passes,
    the autograd update, 0 K2); ``train_agent`` for PPO (the evaluator
    reporting ``cumulative_returns``), TD3, SAC and ModSAC on the stock env;
13b. ``bf16_host_pixel_phases``: K4's bf16 variants, the stock actor
    kernel under the PPO head at 256 and 4096 envs and under the ddpg, sac
    and modsac heads, with both storage types, against the plain version in
    bf16 (``k4_bf16_vs_plain``: ``BF16_TOL`` on one step from every visited
    state with every lot flip at an edge of the two versions' actions, both
    noise modes, two runs bitwise equal, a float32 control that must break
    the limits, the time at each cluster size), the float32 kernels with
    bf16 storage (``k4_store_bf16_vs_plain``), the critic pass's bf16
    variant at 256 and 4096 envs and (576, 576) (``critic_bf16_vs_plain``);
    the main paths ``main_path_stock_bf16`` (``ppo_stock``'s shape in bf16:
    K4 bf16, the bf16 critic pass, K10, autograd), ``main_path_isaac_mock``
    (PPO through ``make_isaac_env`` on the mock VecTask, its tensors on the
    card), ``main_path_modsac_host`` (ModSAC on a host pool of numpy
    gym-protocol envs; sequential, threaded and forked pools bitwise equal)
    and ``main_path_pixel`` (pixel PPO on PixelChasing), each with ms per
    round, env-steps/s and the profiled idle share, then ``train_agent`` and
    a ``valid_agent`` round trip;
14. LunarLander and the kernels of ``ops/kernels.py`` (``lunar_phases``):
    K10, the V-trace recursion, bitwise against its plain version at 256 x
    64, 64 x 4096, 37 x 1000 and 2048 x 4096, alone and with the truncation
    bootstrap and the reward sums folded in, call and device time
    (``k10_vs_plain``), and the PPO advantage step's device kernels before
    and after the fold (``k10_advantage_step``); K11a, the replay gather, one
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
15b. ``parallel/`` (``parallel_phases``): the sharded rollouts
    (``sharded_rollout_vs_plain``: K1 on the main path's 4096 Pendulum envs,
    K6 on path A's 1024 HopperSlip envs, K4 with its critic pass on
    ``ppo_stock``'s 256, at dp = 2 and 4 on the one card: each shard's launch
    against its plain version with its folded seed, the union with injected
    noise bitwise equal to the single launch at one forced cluster size, ms
    per rollout at dp = 1, 2 and 4); the main path at ``{'dp': 2}`` against
    dp = 1, 10 rounds each, the launches asserted (``main_path_dp2``), and
    path A likewise (``main_path_td3_dp2``: two K6, one K7 chunk and one K11a
    a round); the
    ``population_ppo`` and ``population_stock`` shapes, 8 members, ms per
    member round, the launches per member round, ``train_agent_population``
    with evaluation and selection, copies that share no storage
    (``main_path_population``); a one-rank NCCL group through
    ``init_distributed`` and a round whose gathers run on it
    (``distributed_world1``); ``train_agent`` with ``mesh_axes={'dp': -1}``,
    ``elastic_restore`` of its carry onto ``{'dp': 2}``, a round and
    ``valid_agent`` (``train_agent_mesh``);
15c. ``marl/`` (``marl_phases``): MAPPO, MADDPG, QMIX, VDN, the recurrent
    MAPPO and the recurrent QMIX on TeamChasing at their learning recipes'
    sizes, a few rounds each with ms a round, finite metrics and every
    tensor on the card, then each ``train_*`` entry point for two evaluated
    rounds (PyTorch ops: the JAX package runs no Pallas kernel there);
15d. ``rlsolver/`` (``rlsolver_phases``): ``rlsolver_maxcut``, each ported
    MaxCut method (iSCO, MCPG, greedy local search, simulated annealing) on
    both committed 800-node BA instances at ``scripts/maxcut_shootout.py``'s
    sizes, its cut and seconds, gated on its x reproducing its cut in
    float64 numpy on the host and on beating random search at its number of
    sims; ``rlsolver_ppo_maxcut``, ``ppo_maxcut_solve`` on the committed
    64-node instance with K10's launches counted and K10 held, bitwise,
    against its plain version on the path's own inputs;
15e. ``serve.py`` and ``utils/profiling.py`` (``serve_profiling_phases``):
    ``serve_policy``, PPO on Pendulum (a few ``train_agent`` rounds at the
    main path's sizes, K1 and K2), SAC on Pendulum and DQN on CartPole at
    (128, 128), each saved as ``train_agent`` saves it and served on the
    card through ``PolicyServer.start(port=0)``: ``/health``, then batches
    of 1, 7, 64 and 4096 rows from four client threads of 50 requests each,
    every answer held against the plain version on the same rows, K11b
    counted once a PPO or DQN request, p50 and p99 latency, requests/s and
    K11b's time at each batch size beside its plain time and bound;
    ``profiling_trace``, three main-path rounds traced by ``trace`` and read
    by ``parse_device_trace`` (busy share in (0, 1], K1 and K2 three
    launches each, ``sol_report`` on the card's entry);
15f. ``rlsolver_more_phases``: ``rlsolver_problems``, partitioning, set
    cover, BILP and portfolio on the JAX tests' instances at their optima,
    and partitioning on ``syn_BA_800_dense.txt``; ``rlsolver_learned``,
    ECO-DQN (32 BA-60 graphs, 2 x 500 steps; greedy and eps 0.05 with 64
    restarts), S2V-DQN (40 epochs), L2A, RUN-CSP and PI-GNN on both
    800-node instances, the attention-model TSP (20 cities) and the
    GraphTRS pretrain with its L2A transfer, every x recomputed in float64
    on the host and each beating random search;
15g. ``vrp_tnco_phases`` (``rlsolver_vrp_tnco``): ``vrptw_solve`` on the
    bundled ``rand24_vrptw.txt`` and a 100-customer Solomon-sized instance,
    each best tour checked on the host and its distance recomputed in
    float64; the TNCO greedy and annealing on an 8 x 8 grid and a 64-node
    random network, each cost recomputed by a host evaluator; the matrix
    chain at its DP optimum; ``examples_torch/tutorial_rlsolver.py``.  Then
    ``driver_phases`` (``drivers``): every training driver of
    ``helloworld_torch/`` and ``examples_torch/`` that needs no gymnasium,
    as a user calls it, its ``Config`` cut to two rounds and one
    evaluation, each asserting the set of kernels it launches, the
    paper-trading loop served by ``PolicyServer``; beside it,
    ``helloworld_learns``: the four single files in child processes, each
    to its own learning assert (a miss is reported, a crash fails);
16. the kernels line (the sharded wrappers' numbers ride with the entry of
    the kernel they launch, ``sharded``) and the device line.

The streamed designs of the rollout kernels (layer 2 read from a copy of
the weights in device memory, taken where no cluster holds the weight
slices) are held against their plain versions with the tolerances of the
resident designs' checks: ``k13_vs_plain_streamed`` (K1 and K3 at (384,
384) and (1024, 1024)), ``k13_bf16_vs_plain_streamed`` ((1024, 1024) in
bf16), ``k6_vs_plain_streamed`` (ddpg, sac and dqn at (1024, 1024), ddpg
and dqn in bf16), ``k4_vs_plain`` at (512, 512) and (640, 640) with the
critic pass, ``k4_offpolicy_vs_plain`` under the ddpg head at (512, 512),
``k4_bf16_vs_plain`` and ``critic_bf16_vs_plain`` at (1024, 1024); and
three main paths take them: ``main_path_wide_f32`` (PPO on Pendulum at
(384, 384) in float32: the streamed K1, K10, K2), ``main_path_td3_wide``
(path A at (1024, 1024): the streamed K6, K7) and ``main_path_stock_wide``
(``ppo_stock`` at (640, 640): the streamed K4 actor and critic pass, the
autograd update, as the JAX package runs XLA ops there).  Past the widest
streamed lane group each kernel takes a narrower one (``onpolicy_narrow.cu``,
``offpolicy_narrow.cu``): ``k13_vs_plain_narrow`` (K1 at (1536, 1536), 8
lanes) with ``main_path_narrow``; ``k6_vs_plain_narrow`` (path A at (3072,
3072), 8 lanes) with ``main_path_td3_narrow``; ``k4_vs_plain`` at (1280,
1280) (the actor on 16 lanes) and (1536, 1536) (the critic pass on
16-sample tiles) with ``main_path_stock_narrow_1280`` and ``_1536``.

Each phase prints one JSON line; any failure raises and exits non-zero.
Needs one CUDA card and the CUDA toolkit; imports nothing of JAX.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

NUM_ENVS, HORIZON, BATCH, REPEAT, NET_DIMS = 4096, 64, 512, 8.0, (128, 128)
ROUNDS = 10

# Published dense peaks of the H100 SXM part (NVIDIA data sheet, 700 W), one
# copy, in the port's utils/profiling.py: FP32 on the CUDA cores, TFLOP/s,
# and HBM bandwidth, TB/s; TF32 on the tensor cores, TFLOP/s (the critic
# pass's split-3xTF32 products); dense bf16 on the tensor cores, TFLOP/s (the
# bf16 variants' bound: their products take bf16 operands, which the card
# multiplies at that rate).
from elegantrl_tpu_torch.utils.profiling import CHIP_PEAKS  # noqa: E402

H100_SXM_PEAKS = (CHIP_PEAKS['H100 SXM']['f32_tflops'],
                  CHIP_PEAKS['H100 SXM']['hbm_gbps'] / 1e3)
H100_TF32_TFLOPS = CHIP_PEAKS['H100 SXM']['tf32_tflops']
H100_BF16_TFLOPS = CHIP_PEAKS['H100 SXM']['bf16_tflops']


T_START = time.time()


def emit(**kw):
    """One JSON line; ``t`` is the seconds since the script started."""
    print(json.dumps({**kw, 't': round(time.time() - T_START, 1)}), flush=True)


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
    """Mean device ms per launch of the kernels whose name holds
    ``kernel_name`` (one a call where it is used), from ``torch.profiler``
    over ``reps`` calls after one warm-up.  A trace can come back without
    some of its device events (the profiler warns that it clears events at
    the end of a cycle), so the mean is over the launches the trace holds,
    and a trace holding none is taken again, up to three times; then the
    time is taken with CUDA events over the same calls (launch gaps
    included), and a ``profiler_empty`` line says so."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [ev.time_range.elapsed_us() for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA and kernel_name in ev.name]
        if times:
            return sum(times) / 1e3 / len(times)
    ms = cuda_ms(torch, fn, reps)
    emit(phase='profiler_empty', kernel=kernel_name, traces=3, fallback='cuda events', ms=ms)
    return ms


def device_kernels(torch, fn, reps=3, traces=4):
    """The names of the CUDA kernels ``reps`` calls of ``fn`` launch (memsets
    and copies left out), from ``torch.profiler``.  A trace can come back
    without some of its device events, never with an extra one, so of
    ``traces`` traces the one holding the most is kept."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    best = []
    for attempt in range(traces):
        # every other trace records a warm-up step first and keeps the
        # second: the device tracing is then already running when the
        # counted calls launch (a trace started cold has dropped its first
        # kernel)
        warm = attempt % 2 == 0
        # acc_events: the scheduled trace keeps the active step's events when
        # its cycle ends (torch 2.11 clears them there otherwise)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1) if warm else None,
                     acc_events=warm) as prof:
            for _ in range(2 if warm else 1):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                if warm:
                    prof.step()
        names = [ev.name for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and not ev.name.startswith(('Memset', 'Memcpy', '[memory]', 'ProfilerStep'))]
        if len(names) > len(best):
            best = names
    return best


# ---------------------------------------------------------------- off-policy

OFF_NET = (128, 128)
# the two off-policy main paths, the JAX package's profiled round shapes
# (scripts/profile_sol.py: td3_hopper_shape, dqn_cartpole_shape)
PATH_A = dict(envs=1024, horizon=32, buffer=4000, batch=1024, repeat=4.0, lr=3e-4,
              updates=15)
PATH_B = dict(envs=64, horizon=64, buffer=20000, batch=128, repeat=1.0, lr=1e-3,
              updates=156)
# path A at (1024, 1024) (main_path_td3_wide): the JAX package's DDPG/TD3
# chunk takes a net that wide only at max(net_dims) * batch <= 131072
# (agents/ddpg_td3.py, the JAX eligibility copied term by term), so
# batch 128 (at 1024 it runs XLA ops and the port autograd)
PATH_A_WIDE = dict(PATH_A, batch=128, updates=125)
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
# the bf16 variants, and the float32 kernels with bf16 storage, against
# their plain versions so (k6_bf16_vs_plain and the on-policy
# check_reduced say why): whole trajectories, a lane parted beyond 5e-2, at
# most 1% of the lanes (at least one) parted; one step from every visited
# state within 1e-2, at most 1% of the samples beyond 1e-4, at most 1%
# threshold flips
BF16_TOL = {'trajectory': 5e-2, 'share_parted': 0.01, 'one_step': 1e-2,
            'share_over_1e4': 0.01, 'flip_share': 0.01}


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
        for dims in (OFF_NET, (256, 256), (96, 160), (512, 512), (1024, 1024), (1024, 256)):
            for c in fr.ROLLOUT_CLUSTERS:
                for bf in (0, 1):
                    # the resident and streamed layouts, the narrower groups' from
                    # the narrow library
                    for level in range(fr.OFF_LEVELS + 1):
                        out[f'offpolicy_rollout[{env_name},{head},{dims},cluster={c},bf16={bf},'
                            f'level={level}]'] = (
                            fr._library(level << 1).offpolicy_rollout_smem_bytes(
                                body.kernel_id, fr.OFFPOLICY_HEADS[head], *dims, c,
                                bf | level << 1),
                            fr.offpolicy_smem_bytes(body, dims, head, c, bool(bf), level))
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
    from elegantrl_tpu_torch.envs import StockTradingVecEnv
    from elegantrl_tpu_torch.ops import fused_rollout as fr
    body = StockTradingVecEnv(num_envs=1)._def.kernel_body
    S, A = body.state_dim, body.action_dim
    out = {}
    for dims in (OFF_NET, (256, 256), (96, 160), (448, 448), (576, 576), (704, 704),
                 (1024, 1024), (640, 640), (1280, 1280), (1536, 1536)):
        for c in fr.ROLLOUT_CLUSTERS:
            for bf in (0, 1):
                # the resident and streamed layouts, the narrower groups' from the
                # narrow library
                for level in range(fr.STOCK_LEVELS + 1):
                    lib, v = fr._library(level << 1), bf | level << 1
                    key = f'{dims},cluster={c},bf16={bf},level={level}'
                    out[f'stock_rollout[{key}]'] = (
                        lib.stock_rollout_smem_bytes(*dims, c, v),
                        fr.actor_smem_bytes(S, dims, A, c, bf16=bool(bf), streamed=level))
                    for head in fr.CONTINUOUS_HEADS:
                        out[f'offpolicy_rollout[StockTradingEnv-v2,{head},{key}]'] = (
                            lib.offpolicy_rollout_smem_bytes(
                                body.kernel_id, fr.OFFPOLICY_HEADS[head], *dims, c, v),
                            fr.offpolicy_smem_bytes(body, dims, head, c, bool(bf), level))
        for lib in (fr._library(0), fr._library(4)):   # both libraries, the same reckoning
            out[f'critic_values[{dims},{lib._name.split("/")[-1]}]'] = (
                lib.critic_values_smem_bytes(*dims), fr.critic_smem_bytes(dims))
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

    def flat_for(body, head, seed_, dims=OFF_NET):
        """The head's net as the agents initialise it, from a seed."""
        S, A = body.state_dim, body.action_dim
        d1, d2 = dims
        heads = {'sac': [((d2, 2 * A), 0.1)], 'modsac': [((d2, A), 0.1)] * 2,
                 'dqn_duel': [((d2, A), 0.1), ((d2, 1), 0.1)]}.get(head, [((d2, A), 0.1)])
        nets = ([((S, d1, d2, A), 0.1)] if head in ('ddpg', 'dqn')
                else [((S, d1, d2), None)] + heads)
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

    def k6_bound(body, head, n, h, n_params, dims=OFF_NET, tflops=None, store=False):
        """At the FP32 CUDA-core rate, or at ``tflops`` (the bf16 variant: the
        dense bf16 tensor rate); ``store``: states and float actions written
        as bf16."""
        S, A = body.state_dim, body.action_dim
        D1, D2 = dims
        out_rows = {'dqn_duel': A + 1, 'sac': 2 * A, 'modsac': 2 * A}.get(head, A)
        flop = 2 * (S * D1 + D1 * D2 + D2 * out_rows) * n * h
        rows = body.n_f32 + body.n_i32
        cont = head in fr.CONTINUOUS_HEADS
        a_out = A if cont else 1
        nbytes = (4 * (n_params + 2 + 2 * rows * n)
                  + n * h * ((2 if store else 4) * (S + (a_out if cont else 0))
                             + 4 * (3 + (0 if cont else a_out))))
        return bound(flop, nbytes, tflops)

    # ---- k6_vs_plain: each instantiation at its main path's envs and horizon
    # Tolerances as for the on-policy bodies (k3_vs_plain): whole trajectories
    # in both noise modes, a lane parts from its twin at the first step where
    # an output differs by more than 2e-2 or a flag or discrete action
    # differs, at most 1% of lanes part (at least one lane may: path B has
    # only 64); one step from every visited state
    # (injected noise) agrees to 1e-4 with discrete actions and flags equal,
    # but for at most 8 samples within rounding of a hard threshold (an argmax
    # near-tie, CartPole's limits, a touchdown), counted and left out.  Two
    # runs of the kernel are bitwise equal in both modes; the kernel's time at
    # each cluster size that fits (cluster_ms) records the options, the
    # kernel picks its own.
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
            again = fr.offpolicy_rollout(flat, f0, i0, horizon_len=h, **kw, **extra)
            want = fr.offpolicy_rollout_reference(flat, f0, i0, horizon_len=h, env_trace=trace,
                                                  **kw, **extra)
            torch.cuda.synchronize()
            assert all(torch.equal(getattr(got, f), getattr(again, f)) for f in got._fields), (
                'K6 runs differ', tag, mode)
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
        sizes = {c: cuda_ms_(lambda c=c: fr.offpolicy_rollout(flat, f0, i0, horizon_len=h,
                                                              seed=seed, cluster=c, **kw),
                             reps=10, warmup=1)
                 for c in fr.ROLLOUT_CLUSTERS
                 if fr.offpolicy_smem_bytes(body, OFF_NET, head, c) <= fr.SMEM_LIMIT}
        picked = fr._library().offpolicy_rollout_cluster(
            body.kernel_id, fr.OFFPOLICY_HEADS[head], n, D1, D2, 0, 0)
        b_ms, b_by = k6_bound(body, head, n, h, flat.numel())
        emit(phase='k6_vs_plain', kernel=tag, envs=n, horizon=h, trajectory=report,
             one_step=one, one_step_threshold_flips=n_flip, two_runs_bitwise_equal=True,
             cluster=picked, cluster_ms=sizes, ms=ms, plain_ms=plain_ms,
             bound_ms=b_ms, bound_by=b_by,
             tolerance={'trajectory': 2e-2, 'lanes_parted': max(1, int(0.01 * n)),
                        'one_step': 1e-4, 'threshold_flips': 8})
        k6[(env_name, head)] = dict(name=tag, ms=ms, plain_ms=plain_ms,
                                    max_abs_err=max(one.values()), bound_ms=b_ms, bound_by=b_by,
                                    cluster=picked, cluster_ms=sizes)

    # ---- k6_vs_plain_wide: TD3 and SAC on HopperSlip (path A's shape) and
    # DQN on CartPole (path B's) at (256, 256), widths the first design
    # refused (its whole net in one block): the kernel against its plain
    # version with k6_vs_plain's trajectory tolerances, two runs bitwise
    # equal, and the wrapper's fit that the runner asks
    for env_name, head in (('HopperSlip-v0', 'ddpg'), ('HopperSlip-v0', 'sac'),
                           ('CartPole-v1', 'dqn')):
        body = fr.KERNEL_ENV_BODIES[env_name]
        wide = (256, 256)
        n, h = (PATH_A if head in fr.CONTINUOUS_HEADS else PATH_B)['envs'], (
            PATH_A if head in fr.CONTINUOUS_HEADS else PATH_B)['horizon']
        assert fr.offpolicy_fits(body, head, wide), (env_name, head)
        g = torch.Generator(device=dev).manual_seed(37)
        S, A = body.state_dim, body.action_dim
        heads = {'sac': [((256, 2 * A), 0.1)]}.get(head, [((256, A), 0.1)])
        nets = [((S, 256, 256, A), 0.1)] if head != 'sac' else [((S, 256, 256), None)] + heads
        flat = init_flat(torch.Generator().manual_seed(7), nets, dev)
        env_def = env_classes[env_name](num_envs=1)._def
        f0, i0 = body.pack(env_def.init(g, n, dev))
        i0 = (torch.arange(n, device=dev, dtype=torch.int32) * 37 % env_def.spec.max_step)[None]
        f0, i0 = f0.contiguous(), i0.contiguous()
        kw = dict(body=body, head=head, net_dims=wide, reward_scale=1.0, noise_std=0.1,
                  explore_rate=0.25, std_clip=std_clip(head))
        report = {}
        for mode, extra in (('injected', dict(noise=k6_noise(body, head, g, h, n))),
                            ('philox', dict(seed=seed))):
            got = fr.offpolicy_rollout(flat, f0, i0, horizon_len=h, **kw, **extra)
            again = fr.offpolicy_rollout(flat, f0, i0, horizon_len=h, **kw, **extra)
            want = fr.offpolicy_rollout_reference(flat, f0, i0, horizon_len=h, **kw, **extra)
            torch.cuda.synchronize()
            assert all(torch.equal(getattr(got, f), getattr(again, f)) for f in got._fields)
            differ, worst = k6_fields_differ(got, want, 2e-2)
            parted = differ.any(0)
            assert int(parted.sum()) <= max(1, int(0.01 * n)), (env_name, head, mode)
            report[mode] = dict(lanes_parted=int(parted.sum()),
                                max_abs_diff_kept=float(worst[:, ~parted].max()),
                                step0_max_abs_diff=float(worst[0].max()))
            assert report[mode]['step0_max_abs_diff'] <= 1e-4, report[mode]
        ms = cuda_ms_(lambda: fr.offpolicy_rollout(flat, f0, i0, horizon_len=h, seed=seed, **kw),
                      reps=10, warmup=2)
        plain_ms = cuda_ms_(lambda: fr.offpolicy_rollout_reference(flat, f0, i0, horizon_len=h,
                                                                   seed=seed, **kw), reps=1)
        b_ms, b_by = k6_bound(body, head, n, h, flat.numel(), wide)
        picked = fr._library().offpolicy_rollout_cluster(
            body.kernel_id, fr.OFFPOLICY_HEADS[head], n, *wide, 0, 0)
        emit(phase='k6_vs_plain_wide', kernel=f'fused_rollout[{env_name},{head}]',
             net_dims=wide, envs=n, horizon=h, trajectory=report, two_runs_bitwise_equal=True,
             cluster=picked, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
             tolerance={'trajectory': 2e-2, 'lanes_parted': max(1, int(0.01 * n)),
                        'step0': 1e-4})
        k6[(env_name, head)]['wide'] = dict(net_dims=list(wide), ms=ms, plain_ms=plain_ms,
                                            bound_ms=b_ms, bound_by=b_by, cluster=picked,
                                            max_abs_err=report['injected']['step0_max_abs_diff'])

    # ---- k6_bf16_vs_plain: the bf16 variant (bf16 products, f32 sums) of
    # every pair against the plain version in bf16, at its main path's shape,
    # both storage types (bf16 storage: the obs rounded before acting, bf16
    # states and float actions); and k6_store_bf16_vs_plain: the float32
    # kernel with bf16 storage (the JAX package's storage_dtype='bfloat16'
    # under float32 compute) against the plain version so.  Tolerances
    # (BF16_TOL): two runs bitwise equal in both noise modes; one step from
    # every visited state (injected noise) within 1e-2 on every sample
    # without a threshold flip, at most 1% flips, and at most 1% of the
    # samples beyond 1e-4: the kernel and the plain version sum the f32
    # products in other orders, and where a hidden activation (or an obs
    # under bf16 storage) lies within that last bit of a bf16 rounding
    # boundary it rounds one bf16 step (2^-8) apart, moving an output by
    # about |w| 2^-8 |h| (a stored bf16 action by one bf16 step, up to
    # 3.9e-3); whole trajectories: at most 1% of the lanes (at least one)
    # part (an output beyond 5e-2, or a flag or discrete action) and the
    # rest agree to 5e-2.  The control (bf16 compute): the float32 kernel
    # on the same one-step inputs against the bf16 plain version must break
    # these limits where the net's outputs are floats (the Gaussian heads);
    # a DQN head's only output is its argmax, which bf16 and f32 sums part
    # only at near-ties, so there the control's reading is reported and not
    # asserted.
    k6_bf16 = {}
    bfr = torch.bfloat16

    def as_f32(out):
        return out._replace(states=out.states.float(), actions=out.actions.float()
                            if out.actions.dtype == bfr else out.actions)

    def k6_one_step(o1, w1, samples):
        o1, w1 = as_f32(o1), as_f32(w1)
        flip, sample = k6_fields_differ(o1, w1, float('inf'))
        flip = (flip[0] | (o1.env_i != w1.env_i).any(0)
                | ((o1.env_f - w1.env_f).abs().amax(0) > 0.25))
        sample = torch.maximum(sample[0], (o1.env_f - w1.env_f).abs().amax(0))[~flip]
        one = dict(max_abs=float(sample.max()), share_over_1e4=float((sample > 1e-4)
                                                                     .float().mean()),
                   flips=int(flip.sum()))
        one['within'] = (one['flips'] <= BF16_TOL['flip_share'] * samples
                         and one['max_abs'] <= BF16_TOL['one_step']
                         and one['share_over_1e4'] <= BF16_TOL['share_over_1e4'])
        return one

    for env_name, head in K6_PAIRS:
        body = fr.KERNEL_ENV_BODIES[env_name]
        path = PATH_A if head in fr.CONTINUOUS_HEADS else PATH_B
        n, h = path['envs'], path['horizon']
        g = torch.Generator(device=dev).manual_seed(41)
        flat = flat_for(body, head, 7)
        env_def = env_classes[env_name](num_envs=1)._def
        f0, i0 = body.pack(env_def.init(g, n, dev))
        i0 = (torch.arange(n, device=dev, dtype=torch.int32) * 37 % env_def.spec.max_step)[None]
        f0, i0 = f0.contiguous(), i0.contiguous()
        nz = k6_noise(body, head, g, h, n)
        nz_all = nz.transpose(0, 1).reshape(1, nz.shape[1], h * n).contiguous()
        for compute, store in ((bfr, False), (bfr, True), (None, True)):
            kw = dict(body=body, head=head, net_dims=OFF_NET, reward_scale=1.0, noise_std=0.1,
                      explore_rate=0.25, std_clip=std_clip(head), compute_dtype=compute,
                      store_dtype=bfr if store else None)
            tag = (f'offpolicy_rollout{"_bf16" if compute else ""}'
                   f'[{env_name},{head},store={"bf16" if store else "f32"}]')
            report = {}
            for mode, extra in (('injected', dict(noise=nz)), ('philox', dict(seed=seed))):
                trace = []
                got = fr.offpolicy_rollout(flat, f0, i0, horizon_len=h, **kw, **extra)
                again = fr.offpolicy_rollout(flat, f0, i0, horizon_len=h, **kw, **extra)
                want = fr.offpolicy_rollout_reference(flat, f0, i0, horizon_len=h,
                                                      env_trace=trace, **kw, **extra)
                torch.cuda.synchronize()
                assert all(torch.equal(getattr(got, f), getattr(again, f))
                           for f in got._fields), (tag, mode)
                assert got.states.dtype == (bfr if store else torch.float32), tag
                differ, worst = k6_fields_differ(as_f32(got), as_f32(want),
                                                 BF16_TOL['trajectory'])
                parted = differ.any(0)
                assert int(parted.sum()) <= max(1, int(BF16_TOL['share_parted'] * n)), (
                    tag, mode, int(parted.sum()))
                assert float(worst[:, ~parted].max()) <= BF16_TOL['trajectory'], (tag, mode)
                report[mode] = dict(lanes_parted=int(parted.sum()),
                                    max_abs_diff_kept=float(worst[:, ~parted].max()))
                if mode == 'injected':
                    f_all = torch.cat([f for f, _ in trace], dim=1).contiguous()
                    i_all = torch.cat([i for _, i in trace], dim=1).contiguous()
            w1 = fr.offpolicy_rollout_reference(flat, f_all, i_all, horizon_len=1,
                                                noise=nz_all, **kw)
            one = k6_one_step(fr.offpolicy_rollout(flat, f_all, i_all, horizon_len=1,
                                                   noise=nz_all, **kw), w1, h * n)
            assert one['within'], (tag, one)
            res = dict(name=tag, trajectory=report, one_step=one, max_abs_err=one['max_abs'],
                       lanes_parted=max(r['lanes_parted'] for r in report.values()))
            if compute is not None:
                control = k6_one_step(fr.offpolicy_rollout(
                    flat, f_all, i_all, horizon_len=1, noise=nz_all,
                    **dict(kw, compute_dtype=None)), w1, h * n)
                if head in fr.CONTINUOUS_HEADS:
                    assert not control['within'], ('the f32 kernel passed BF16_TOL', tag, control)
                res['control_f32_kernel'] = control
            ms = cuda_ms_(lambda: fr.offpolicy_rollout(flat, f0, i0, horizon_len=h, seed=seed,
                                                       **kw), reps=10, warmup=2)
            plain_ms = cuda_ms_(lambda: fr.offpolicy_rollout_reference(
                flat, f0, i0, horizon_len=h, seed=seed, **kw), reps=1)
            if compute is not None:
                b_ms, b_by = k6_bound(body, head, n, h, flat.numel(), tflops=H100_BF16_TFLOPS,
                                      store=store)
                res['bound_ms_fp32'] = k6_bound(body, head, n, h, flat.numel(), store=store)[0]
            else:
                b_ms, b_by = k6_bound(body, head, n, h, flat.numel(), store=store)
            picked = fr._library().offpolicy_rollout_cluster(
                body.kernel_id, fr.OFFPOLICY_HEADS[head], n, D1, D2, 0, int(compute is not None))
            res.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, cluster=picked)
            k6_bf16[(env_name, head, compute is not None, store)] = res
            emit(phase='k6_bf16_vs_plain' if compute is not None else 'k6_store_bf16_vs_plain',
                 kernel=tag, envs=n, horizon=h, two_runs_bitwise_equal=True, **res,
                 tolerance=BF16_TOL, device=name, nvidia_smi=smi)

    # ---- k6_vs_plain_streamed: the streamed design (layer 2 read from the
    # stream_weights copy in device memory), taken where no cluster holds the
    # net's slices, at (1024, 1024): TD3 (ddpg) and SAC on HopperSlip at path
    # A's shape and DQN on CartPole at path B's in float32, with
    # k6_vs_plain's tolerances (whole trajectories, both noise modes, and one
    # step from every visited state); ddpg and dqn in bf16 with
    # k6_bf16_vs_plain's (BF16_TOL, the float32 control breaking it for the
    # Gaussian head); two runs bitwise equal; the kernel's time at each
    # cluster size its streamed layout fits and the bounds (operations at
    # the FP32 rate, or the dense bf16 rate; stream_bytes: the W2 bytes the
    # lane groups read from L2, one net a group and step)
    # Past its 16-lane groups' widest width (2592 on HopperSlip in float32)
    # the streamed design takes 8-lane groups: TD3 at (3072, 3072), path A's
    # shape, the same checks (k6_narrow)
    k6_streamed, k6_narrow = {}, {}
    for env_name, head, dims, compute in (
            ('HopperSlip-v0', 'ddpg', (1024, 1024), None), ('HopperSlip-v0', 'sac', (1024, 1024), None),
            ('CartPole-v1', 'dqn', (1024, 1024), None), ('HopperSlip-v0', 'ddpg', (1024, 1024), bfr),
            ('CartPole-v1', 'dqn', (1024, 1024), bfr), ('HopperSlip-v0', 'ddpg', (3072, 3072), None)):
        body = fr.KERNEL_ENV_BODIES[env_name]
        bf = compute is not None
        assert fr.offpolicy_fits(body, head, dims, bf)
        assert not fr.offpolicy_fits_resident(body, head, dims, bf)
        level = fr.offpolicy_level(body, head, dims, bf)
        path = PATH_A if head in fr.CONTINUOUS_HEADS else PATH_B
        n, h = path['envs'], path['horizon']
        g = torch.Generator(device=dev).manual_seed(43)
        flat = flat_for(body, head, 7, dims)
        env_def = env_classes[env_name](num_envs=1)._def
        f0, i0 = body.pack(env_def.init(g, n, dev))
        i0 = (torch.arange(n, device=dev, dtype=torch.int32) * 37 % env_def.spec.max_step)[None]
        if body is fr.HOPPER_BODY:
            f0[1, :16], f0[3, :16] = 0.27, -3.0
        f0, i0 = f0.contiguous(), i0.contiguous()
        nz = k6_noise(body, head, g, h, n)
        nz_all = nz.transpose(0, 1).reshape(1, nz.shape[1], h * n).contiguous()
        kw = dict(body=body, head=head, net_dims=dims, reward_scale=1.0, noise_std=0.1,
                  explore_rate=0.25, std_clip=std_clip(head), compute_dtype=compute)
        tol = BF16_TOL['trajectory'] if bf else 2e-2
        parted_most = max(1, int((BF16_TOL['share_parted'] if bf else 0.01) * n))
        tag = (f'offpolicy_rollout{"_bf16" if bf else ""}[{env_name},{head},{dims}'
               f'{fr._design_tag(level << 1, fr.OFF_LANES)}]')
        report = {}
        for mode, extra in (('injected', dict(noise=nz)), ('philox', dict(seed=seed))):
            trace = []
            got = fr.offpolicy_rollout(flat, f0, i0, horizon_len=h, **kw, **extra)
            again = fr.offpolicy_rollout(flat, f0, i0, horizon_len=h, **kw, **extra)
            want = fr.offpolicy_rollout_reference(flat, f0, i0, horizon_len=h, env_trace=trace,
                                                  **kw, **extra)
            torch.cuda.synchronize()
            assert all(torch.equal(getattr(got, f), getattr(again, f)) for f in got._fields), (
                tag, mode, 'two runs differ')
            differ, worst = k6_fields_differ(as_f32(got), as_f32(want), tol)
            parted = differ.any(0)
            assert int(parted.sum()) <= parted_most, (tag, mode, int(parted.sum()))
            assert float(worst[:, ~parted].max()) <= tol, (tag, mode)
            if not bf:
                end = torch.maximum((got.env_f - want.env_f).abs().amax(0),
                                    (got.env_i != want.env_i).any(0).float())
                assert float(end[~parted].max()) <= 2e-2, (tag, mode)
            report[mode] = dict(lanes_parted=int(parted.sum()),
                                max_abs_diff_kept=float(worst[:, ~parted].max()))
            if mode == 'injected':
                f_all = torch.cat([f for f, _ in trace], dim=1).contiguous()
                i_all = torch.cat([i for _, i in trace], dim=1).contiguous()
        g1 = fr.offpolicy_rollout(flat, f_all, i_all, horizon_len=1, noise=nz_all, **kw)
        w1 = fr.offpolicy_rollout_reference(flat, f_all, i_all, horizon_len=1, noise=nz_all,
                                            **kw)
        torch.cuda.synchronize()
        res = dict(name=tag, net_dims=list(dims), trajectory=report)
        if bf:
            one = k6_one_step(g1, w1, h * n)
            assert one['within'], (tag, one)
            control = k6_one_step(fr.offpolicy_rollout(
                flat, f_all, i_all, horizon_len=1, noise=nz_all, **dict(kw, compute_dtype=None)),
                w1, h * n)
            if head in fr.CONTINUOUS_HEADS:
                assert not control['within'], ('the f32 kernel passed BF16_TOL', tag, control)
            res.update(one_step=one, control_f32_kernel=control, max_abs_err=one['max_abs'])
        else:
            flip, _ = k6_fields_differ(g1, w1, float('inf'))
            flip = (flip[0] | (g1.env_i != w1.env_i).any(0)
                    | ((g1.env_f - w1.env_f).abs().amax(0) > 0.25))
            assert int(flip.sum()) <= 8, (tag, int(flip.sum()))
            one = {}
            for f in g1._fields:
                a, b = getattr(g1, f), getattr(w1, f)
                if a.dtype.is_floating_point:
                    d = (a - b).abs()
                    one[f] = float((d[:, ~flip] if f == 'env_f' else d[0][~flip]).max())
            assert all(v <= 1e-4 for v in one.values()), (tag, one)
            res.update(one_step=one, one_step_threshold_flips=int(flip.sum()),
                       max_abs_err=max(one.values()))
        ms = cuda_ms_(lambda: fr.offpolicy_rollout(flat, f0, i0, horizon_len=h, seed=seed, **kw),
                      reps=5, warmup=1)
        plain_ms = cuda_ms_(lambda: fr.offpolicy_rollout_reference(flat, f0, i0, horizon_len=h,
                                                                   seed=seed, **kw), reps=1)
        variant = int(bf) | level << 1
        sizes = {c: cuda_ms_(lambda c=c: fr.offpolicy_rollout(flat, f0, i0, horizon_len=h,
                                                              seed=seed, cluster=c, **kw),
                             reps=3, warmup=1)
                 for c in fr.ROLLOUT_CLUSTERS
                 if fr.offpolicy_smem_bytes(body, dims, head, c, bf, level) <= fr.SMEM_LIMIT}
        picked = fr._library(variant).offpolicy_rollout_cluster(
            body.kernel_id, fr.OFFPOLICY_HEADS[head], n, *dims, 0, variant)
        b_ms, b_by = k6_bound(body, head, n, h, flat.numel(), dims,
                              tflops=H100_BF16_TFLOPS if bf else None)
        lanes = fr.narrow_lanes(fr.OFF_LANES, level)
        stream_bytes = (n // lanes) * h * dims[0] * dims[1] * (2 if bf else 4)
        res.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, cluster=picked,
                   cluster_ms=sizes, lanes=lanes, stream_bytes=stream_bytes,
                   stream_ms_at_hbm_rate=stream_bytes / (peaks_for(name)[1][1] * 1e12) * 1e3)
        if bf:
            res['bound_ms_fp32'] = k6_bound(body, head, n, h, flat.numel(), dims)[0]
        (k6_narrow if level >= 2 else k6_streamed)[(env_name, head, bf)] = res
        emit(phase='k6_vs_plain_narrow' if level >= 2 else 'k6_vs_plain_streamed', kernel=tag,
             envs=n, horizon=h,
             two_runs_bitwise_equal=True, **res,
             tolerance=(BF16_TOL if bf else {'trajectory': 2e-2, 'lanes_parted': parted_most,
                                             'one_step': 1e-4, 'threshold_flips': 8}),
             device=name, nvidia_smi=smi)

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

    def timed_rounds(task, head, path, phase, kernel_ms, variant=None, autograd=False,
                     **hyper):
        """10 timed rounds; ``autograd``: the update is the autograd loop
        (bf16 storage: the JAX package runs its scan), one K11a gather an
        update and no chunk; under bf16 compute the rollout kernel counted is
        its bf16 variant ('<env>,<head>,bf16')."""
        a = off_args(task, path['envs'], path['horizon'], path['batch'], path['repeat'],
                     path['buffer'], path['lr'], **hyper)
        ctx = build_training(a)
        body = fr.KERNEL_ENV_BODIES[task[2]]
        carry, rb = ctx.carry, ctx.rb
        bf = hyper.get('compute_dtype') == 'bfloat16'
        dims = tuple(a.net_dims)
        level = fr.offpolicy_level(body, head, dims, bf)   # the streamed designs past 0
        types = dict(compute_dtype=torch.bfloat16 if bf else None,
                     store_dtype=(torch.bfloat16 if hyper.get('storage_dtype') == 'bfloat16'
                                  else None))
        # fill the ring: kernel rollouts inserted without updates
        flat = carry.agent_state.act if head in fr.CONTINUOUS_HEADS else carry.agent_state.q
        f, i = (x.contiguous() for x in body.pack(carry.env_state))
        buf, fills, t0 = carry.buf_state, 0, time.time()
        while buf.size < rb.max_size:
            s_ = torch.randint(-2 ** 31, 2 ** 31 - 1, (2,), generator=carry.gen, device=dev,
                               dtype=torch.int32)
            out = fr.offpolicy_rollout(flat, f, i, body=body, head=head, net_dims=dims,
                                       horizon_len=path['horizon'], reward_scale=1.0,
                                       noise_std=0.05, explore_rate=0.25, seed=s_, **types)
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
        assert by_kernel == {f'{task[2]},{head}' + (',bf16' if bf else '')
                             + fr._design_tag(level << 1, fr.OFF_LANES): ROUNDS}, by_kernel
        assert update_counts == ({} if autograd else
                                 {variant or CHUNK_VARIANT[head]: ROUNDS * chunks}), update_counts
        assert fr.offpolicy_rollout.launches == ROUNDS
        # K11a: one launch gathers every field of a chunk (of an update, autograd)
        gathers = kn.buffer_gather_fields.launches
        want_gathers = ROUNDS * (U if autograd else chunks)
        assert gathers == want_gathers, (phase, gathers, want_gathers)
        assert bool(torch.isfinite(mvals).all()), mvals
        assert moved > 0.0
        emit(phase=phase, agent=task[0].__name__, env=task[2], envs=path['envs'],
             horizon=path['horizon'], ring_rows=rb.max_size, batch=path['batch'],
             repeat=path['repeat'], net_dims=dims, updates_per_round=U,
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
    # path A with bf16 compute (the K6 bf16 variant, the K7 chunk: the storage
    # is float32) and its bf16-storage twin (the bf16 ring: the autograd
    # update, as the JAX package runs its scan there)
    launches_a_bf16 = timed_rounds(td3_hopper, 'ddpg', PATH_A, 'main_path_td3_hopper_bf16', dict(
        fused_rollout_bf16_ms=k6_bf16[('HopperSlip-v0', 'ddpg', True, False)]['ms']), gamma=0.99,
        compute_dtype='bfloat16')
    launches_a_bf16s = timed_rounds(
        td3_hopper, 'ddpg', PATH_A, 'main_path_td3_hopper_bf16_storage', dict(
            fused_rollout_bf16_ms=k6_bf16[('HopperSlip-v0', 'ddpg', True, True)]['ms']), gamma=0.99,
        compute_dtype='bfloat16', storage_dtype='bfloat16', autograd=True)
    # path A at (1024, 1024) float32 with batch 128 (PATH_A_WIDE), past the
    # widths a cluster holds: the streamed K6 and the K7 chunk, 10 rounds
    launches_a_wide = timed_rounds(td3_hopper, 'ddpg', PATH_A_WIDE, 'main_path_td3_wide', dict(
        fused_rollout_streamed_ms=k6_streamed[('HopperSlip-v0', 'ddpg', False)]['ms']),
        gamma=0.99, net_dims=(1024, 1024), compute_dtype='float32')
    assert launches_a_wide[1], launches_a_wide
    # path A at (3072, 3072): K6 on 8-lane streamed groups, and the autograd
    # update (past max(net_dims) * batch <= 131072 the JAX package runs its
    # scan), 10 rounds
    launches_a_narrow = timed_rounds(td3_hopper, 'ddpg', PATH_A_WIDE, 'main_path_td3_narrow', dict(
        fused_rollout_narrow_ms=k6_narrow[('HopperSlip-v0', 'ddpg', False)]['ms']),
        gamma=0.99, net_dims=(3072, 3072), compute_dtype='float32', autograd=True)
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
                        'bound_by': k['bound_by'], 'library_ms': None,
                        'cluster': k['cluster'], 'cluster_ms': k['cluster_ms'],
                        **({'wide': k['wide']} if 'wide' in k else {})})
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
    # the bf16 variant of K6/K6' (one template instantiation per pair, bf16
    # weights and tiles): one entry per main path, path A with bf16 compute
    # (storage f32) and its bf16-storage twin, each with its own launches;
    # every pair's check rides along, and the float32 kernel's bf16-storage
    # checks ride with the f32 entries' pairs
    def reduced_pairs(bf):
        return {f'{e},{hd},store={"bf16" if st else "f32"}':
                {k: v[k] for k in ('ms', 'plain_ms', 'max_abs_err', 'bound_ms', 'lanes_parted',
                                   'cluster') + (('bound_ms_fp32',) if bf else ())}
                for (e, hd, b_, st), v in k6_bf16.items() if b_ == bf}
    for store, launched in ((False, launches_a_bf16), (True, launches_a_bf16s)):
        a = k6_bf16[('HopperSlip-v0', 'ddpg', True, store)]
        kernels.append({'name': a['name'], 'route': 'cuda', 'source': rollout_src,
                        'replaces': 'elegantrl_tpu/ops/pallas_rollout.py:1006',
                        'launches': launched[0]['HopperSlip-v0,ddpg,bf16'],
                        'max_abs_err': a['max_abs_err'], 'ms': a['ms'], 'plain_ms': a['plain_ms'],
                        'bound_ms': a['bound_ms'], 'bound_by': a['bound_by'],
                        'bound_ms_fp32': a['bound_ms_fp32'], 'library_ms': None,
                        **({'pairs': reduced_pairs(True)} if not store else {})})
    for k in kernels:
        if k['name'] == 'fused_rollout[HopperSlip-v0,ddpg]':
            k['pairs_store_bf16'] = reduced_pairs(False)
    # the streamed design of K6/K6' (offpolicy_rollout_kernel<Body, HEAD, BF,
    # true>): its entry is path A's at (1024, 1024), main_path_td3_wide's
    # launches; every streamed check rides along
    a = k6_streamed[('HopperSlip-v0', 'ddpg', False)]
    kernels.append({'name': 'offpolicy_rollout[HopperSlip-v0,ddpg,streamed]', 'route': 'cuda',
                    'source': rollout_src, 'replaces': 'elegantrl_tpu/ops/pallas_rollout.py:1006',
                    'launches': launches_a_wide[0]['HopperSlip-v0,ddpg,streamed'],
                    'max_abs_err': a['max_abs_err'], 'ms': a['ms'], 'plain_ms': a['plain_ms'],
                    'bound_ms': a['bound_ms'], 'bound_by': a['bound_by'], 'library_ms': None,
                    'net_dims': a['net_dims'], 'cluster': a['cluster'],
                    'cluster_ms': a['cluster_ms'], 'stream_bytes': a['stream_bytes'],
                    'checks': {v['name']: {f: v[f] for f in (
                        'ms', 'plain_ms', 'bound_ms', 'bound_by', 'max_abs_err', 'cluster',
                        'stream_bytes')} for v in k6_streamed.values()}})
    # its 8-lane groups: path A's at (3072, 3072), main_path_td3_narrow's launches
    a = k6_narrow[('HopperSlip-v0', 'ddpg', False)]
    kernels.append({'name': 'offpolicy_rollout[HopperSlip-v0,ddpg,streamed8]', 'route': 'cuda',
                    'source': rollout_src, 'replaces': 'elegantrl_tpu/ops/pallas_rollout.py:1006',
                    'launches': launches_a_narrow[0]['HopperSlip-v0,ddpg,streamed8'],
                    'max_abs_err': a['max_abs_err'], 'ms': a['ms'], 'plain_ms': a['plain_ms'],
                    'bound_ms': a['bound_ms'], 'bound_by': a['bound_by'], 'library_ms': None,
                    'net_dims': a['net_dims'], 'lanes': a['lanes'], 'cluster': a['cluster'],
                    'cluster_ms': a['cluster_ms'], 'stream_bytes': a['stream_bytes']})
    return kernels, k9_lunar


# ------------------------------------------------------------- StockTrading

STOCK_NET = (128, 128)
# the ppo_stock and ppo_stock_4k recipes (scripts/torch_verify_learning.py)
PPO_STOCK = dict(envs=256, horizon=128, batch=512, repeat=8.0, lr=2e-4)
PPO_STOCK_4K = dict(envs=4096, horizon=128, batch=4096, repeat=64.0, lr=2e-4)
# the off-policy heads on the stock body at path A's envs and horizon
STOCK_OFF = dict(envs=1024, horizon=32)
# The critic pass's limit against its plain version, the full f32 MLP: the
# split-3xTF32 kernel reads 2e-7 to 6e-7 there, a plain 1xTF32 product (the
# residual products dropped; critic_1xtf32 in stock_phases) about 3e-5 or
# more, so the limit sits between them, and each critic check asserts that
# the 1xTF32 emulation of the same states exceeds it.
CRITIC_TOL = 5e-6


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
    from elegantrl_tpu_torch.ops.nets import gelu, init_flat, ppo_param_shapes, split_flat
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

    def onpolicy_bound(n, h, n_act, n_cri, dims=STOCK_NET):
        """K4 on-policy: the actor (rollout) and critic (pass) over every
        env-step, each net's W1 market columns once per step (the day, and
        so the market rows of the obs, is the same on every lane); bytes:
        weights, the env rows in and out, one market row of each table per
        step, the stored outputs written once.  Also the bound that counts
        both nets in full per env-step."""
        D1, D2 = dims
        L, M = 1 + A, S - 1 - A
        flop_a = 2 * (L * D1 + D1 * D2 + D2 * A) * n * h + 2 * M * D1 * h
        flop_c = 2 * (L * D1 + D1 * D2 + D2) * n * h + 2 * M * D1 * h
        flop_full = 2 * (S * D1 + D1 * D2 + D2 * A) * n * h + 2 * (S * D1 + D1 * D2 + D2) * n * h
        rows = body.n_f32 + body.n_i32
        nbytes = 4 * (n_act + n_cri + 2 * S + 2 * rows * n + h * M + n * h * (S + A + 5))
        return bound(flop_a + flop_c, nbytes), bound(flop_full, nbytes)

    def critic_bounds(n, h, n_cri, dims=STOCK_NET):
        """The critic pass over H x N stored states: (1) the market columns
        once per (step, group of 32 lanes), the work the kernel does, on the
        FP32 CUDA cores; (2) in full, every sample's 151 columns; (3) as the
        kernel computes it, layer 1's lane columns and layer 2 on the
        tensor cores in split-3xTF32 (three TF32 products of their FLOP at
        495 TFLOP/s) beside the rest on the FP32 cores, the larger of the
        two.  Bytes: the weights, each sample's 16 lane rows and each
        (step, group)'s market rows read once, the values written once."""
        D1, D2 = dims
        L, M = 1 + A, S - 1 - A
        groups = h * -(-n // 32)
        nbytes = 4 * (n_cri + 2 * S + n * h * (L + 1) + groups * M)
        once = bound(2 * (L * D1 + D1 * D2 + D2) * n * h + 2 * M * D1 * groups, nbytes)
        full = bound(2 * (S * D1 + D1 * D2 + D2) * n * h, 4 * (n_cri + 2 * S + n * h * (S + 1)))
        t_tc = 3 * 2 * (L * D1 + D1 * D2) * n * h / (H100_TF32_TFLOPS * 1e12)
        t_fp32 = (2 * D2 * n * h + 2 * M * D1 * groups) / (peak_tflops * 1e12)
        t_bytes = nbytes / (peak_tbs * 1e12)
        tf32 = (max(t_tc, t_fp32, t_bytes) * 1e3,
                'operations' if max(t_tc, t_fp32) >= t_bytes else 'bytes')
        return once, full, tf32

    def market_shared(states):
        """The critic pass's precondition: the lanes of each group of 32 share
        every step's market rows."""
        m = states[:, 1 + A:]
        first = torch.div(torch.arange(m.shape[-1], device=m.device), 32,
                          rounding_mode='floor') * 32
        return torch.equal(m, m[:, :, first])

    def critic_1xtf32(cri_flat, norm_avg, norm_std, states, dims):
        """The critic pass as a plain 1xTF32 product would compute it: the
        kernel's tensor-core operands (the lane rows and W1's lane columns,
        h1 and W2) rounded to TF32 as cvt.rna rounds them, the residual
        products dropped, the rest in f32.  What CRITIC_TOL must tell apart
        from the split-3xTF32 kernel."""
        def tf32(x):
            b = x.contiguous().view(torch.int32)
            return ((b + 0x1000) & ~0x1FFF).view(torch.float32)
        W1, b1, W2, b2, Wo, bo = split_flat(cri_flat, ppo_param_shapes(S, dims, 1, True)[1])
        xn = (states.transpose(1, 2) - norm_avg) / (norm_std + 1e-4)
        L = 1 + A
        h1 = gelu(tf32(xn[..., :L]) @ tf32(W1[:, :L]).T + xn[..., L:] @ W1[:, L:].T + b1)
        return (gelu(tf32(h1) @ tf32(W2).T + b2) @ Wo.T + bo)[..., 0]

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
    # options; the kernel picks its own.  The critic pass: within CRITIC_TOL
    # of its plain version (the full MLP) on the stored states, whose lane
    # groups share their market rows (asserted), and on a 7 x 99 slice,
    # while its 1xTF32 emulation on the stored states is not; two runs
    # bitwise equal.
    peak_tflops, peak_tbs = peaks_for(name)[1]
    st = make_ppo(STOCK_NET, S, A, Config()).init(0, dev)
    g = torch.Generator(device=dev).manual_seed(41)
    st = st._replace(norm_avg=torch.rand(S, generator=g, device=dev) * 0.4 - 0.2,
                     norm_std=torch.rand(S, generator=g, device=dev) + 0.7)
    with torch.no_grad():
        st.act.std_log.fill_(-0.5)
    net = (st.act_flat, st.cri_flat, st.norm_avg, st.norm_std)
    k4 = {}

    def stock_state(dims, seed_):
        s = make_ppo(dims, S, A, Config()).init(seed_, dev)
        s = s._replace(norm_avg=stx.norm_avg, norm_std=stx.norm_std)
        with torch.no_grad():
            s.act.std_log.fill_(-0.5)
        return s

    # past the resident designs' widths, the streamed ones (k4_vs_plain's
    # checks and tolerances): (512, 512), the actor kernel streamed and the
    # critic pass on 64-sample tiles, and (640, 640), both streamed
    for recipe, path, dims in (('ppo_stock', PPO_STOCK, STOCK_NET),
                               ('ppo_stock_4k', PPO_STOCK_4K, STOCK_NET),
                               ('ragged_300', dict(PPO_STOCK, envs=300), STOCK_NET),
                               ('ppo_stock_512_streamed', PPO_STOCK, (512, 512)),
                               ('ppo_stock_640_streamed', PPO_STOCK, (640, 640)),
                               # past the 32-lane groups' widest width (1184): the
                               # actor on 16-lane groups, the critic pass on
                               # 32-sample tiles, then (1536) on 16-sample ones
                               ('ppo_stock_1280_narrow', PPO_STOCK, (1280, 1280)),
                               ('ppo_stock_1536_narrow', PPO_STOCK, (1536, 1536))):
        n, h = path['envs'], path['horizon']
        stx = st if dims == STOCK_NET else stock_state(dims, 2)
        netx = (stx.act_flat, stx.cri_flat, stx.norm_avg, stx.norm_std)
        a_st = fr.rollout_level(body, dims)      # the actor's design level
        variant = a_st << 1
        # the streamed widths draw from a generator of their own, so the
        # resident checks keep their inputs
        gx = g if dims == STOCK_NET else torch.Generator(device=dev).manual_seed(53)
        f0, i0 = start_rows(n, T - 61, gx)
        nz = noise(gx, h, n)
        bkw = dict(net_dims=dims, reward_scale=2.0 ** -8, body=body)
        report = {}
        for mode, extra in (('injected', dict(noise=nz)), ('philox', dict(seed=seed))):
            trace = []
            got = fr.rollout(*netx, f0, i0, horizon_len=h, **bkw, **extra)
            again = fr.rollout(*netx, f0, i0, horizon_len=h, **bkw, **extra)
            want = fr.rollout_reference(*netx, f0, i0, horizon_len=h, env_trace=trace, **bkw,
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
        got1 = fr.rollout(*netx, f_all, i_all, horizon_len=1, noise=nz_all, **bkw)
        want1 = fr.rollout_reference(*netx, f_all, i_all, horizon_len=1, noise=nz_all, **bkw)
        torch.cuda.synchronize()
        flip, explained = explain_flips(got1, want1, torch.tanh(want1.actions[0]),
                                        nz_all[0, A:])
        assert bool(explained[flip].all()), ('unexplained lot flips', int((~explained[flip]).sum()))
        one = one_step(got1, want1, flip)
        tol = {'values': 1e-4, 'logprobs': 1e-4, 'actions': 1e-4, 'rewards': 1e-4,
               'states': 1e-5, 'env_f': 1e-6}
        assert all(one[f] <= t for f, t in tol.items()), one
        # the critic pass alone against its plain version, on the stored states
        assert market_shared(got.states), 'the critic pass precondition'
        v = fr.critic_values(stx.cri_flat, stx.norm_avg, stx.norm_std, got.states,
                             net_dims=dims)
        v2 = fr.critic_values(stx.cri_flat, stx.norm_avg, stx.norm_std, got.states,
                              net_dims=dims)
        torch.cuda.synchronize()
        assert torch.equal(v, v2), 'critic pass runs differ'

        v_ref = fr.critic_values_reference(stx.cri_flat, stx.norm_avg, stx.norm_std, got.states,
                                           net_dims=dims)
        # and on a slice whose H N (693) is no multiple of the 64-sample tile
        odd = got.states[:7, :, :99].contiguous()
        critic_err = max(float((v - v_ref).abs().max()), float((
            fr.critic_values(stx.cri_flat, stx.norm_avg, stx.norm_std, odd, net_dims=dims)
            - fr.critic_values_reference(stx.cri_flat, stx.norm_avg, stx.norm_std, odd,
                                         net_dims=dims)).abs().max()))
        assert critic_err <= CRITIC_TOL, critic_err
        tf32_err = float((critic_1xtf32(stx.cri_flat, stx.norm_avg, stx.norm_std, got.states,
                                        dims) - v_ref).abs().max())
        assert tf32_err > CRITIC_TOL, ('the critic limit does not part 1xTF32', tf32_err)
        ms = cuda_ms(torch, lambda: fr.rollout(*netx, f0, i0, horizon_len=h, seed=seed, **bkw),
                     reps=10, warmup=2)
        plain_ms = cuda_ms(torch, lambda: fr.rollout_reference(*netx, f0, i0, horizon_len=h,
                                                               seed=seed, **bkw), reps=1)
        c_ms = cuda_ms(torch, lambda: fr.critic_values(stx.cri_flat, stx.norm_avg, stx.norm_std,
                                                       got.states, net_dims=dims),
                       reps=10, warmup=2)
        c_plain = cuda_ms(torch, lambda: fr.critic_values_reference(
            stx.cri_flat, stx.norm_avg, stx.norm_std, got.states, net_dims=dims), reps=2)
        cluster = fr._library(variant).stock_rollout_cluster(n, *dims, 0, variant)
        cluster_ms = {c: cuda_ms(torch, lambda: fr.rollout(*netx, f0, i0, horizon_len=h, seed=seed,
                                                           stock_cluster=c, **bkw),
                                 reps=5, warmup=1) for c in (1, 2, 4, 8)
                      if fr.actor_smem_bytes(S, dims, A, c, streamed=a_st) <= fr.SMEM_LIMIT}
        (b_ms, b_by), (full_ms, _) = onpolicy_bound(n, h, stx.act_flat.numel(),
                                                    stx.cri_flat.numel(), dims)
        (cb_ms, cb_by), (cf_ms, _), (ct_ms, ct_by) = critic_bounds(n, h, stx.cri_flat.numel(),
                                                                   dims)
        emit(phase='k4_vs_plain', kernel='fused_rollout[StockTradingEnv-v2,gaussian]',
             recipe=recipe, envs=n, net_dims=dims,
             actor_design=('streamed' if a_st else 'resident'),
             actor_lanes=fr.rollout_group_lanes(body, dims),
             critic_tile=fr.critic_tile(dims),
             horizon=h, trajectory=report, one_step=one, one_step_samples=h * n,
             one_step_lot_flips=int(flip.sum()), lot_flips_explained=int(explained[flip].sum()),
             two_runs_bitwise_equal=True, cluster=cluster, cluster_ms=cluster_ms,
             critic_pass_max_abs_err=critic_err, critic_1xtf32_max_abs_err=tf32_err, ms=ms, actor_ms=ms - c_ms, plain_ms=plain_ms,
             bound_ms=b_ms, bound_by=b_by, bound_ms_full_obs=full_ms, critic_ms=c_ms,
             critic_plain_ms=c_plain, critic_bound_ms=ct_ms, critic_bound_by=ct_by,
             critic_bound_ms_market_once=cb_ms, critic_bound_ms_full=cf_ms,
             critic_two_runs_bitwise_equal=True, critic_precondition_holds=True,
             ms_covers='the actor-only rollout kernel and the critic pass',
             tolerance=dict(tol, share_parted=0.25, kept_lanes=2e-2, critic=CRITIC_TOL))
        k4[recipe] = dict(net_dims=list(dims), critic_tile=fr.critic_tile(dims),
                          ms=ms, plain_ms=plain_ms, max_abs_err=max(one['values'], one['logprobs'],
                                                                one['actions'], one['rewards']),
                     bound_ms=b_ms, bound_by=b_by, bound_ms_full_obs=full_ms, cluster=cluster,
                     critic=dict(ms=c_ms, plain_ms=c_plain, max_abs_err=critic_err,
                                 bound_ms=ct_ms, bound_by=ct_by, bound_ms_market_once=cb_ms,
                                 bound_ms_full=cf_ms))

    # ---- k4_vs_plain_wide: ppo_stock's rollout at (256, 256), which the
    # first critic pass refused (its whole critic in one block): the actor
    # kernel's first step against the plain version (1e-4; the actor's whole
    # trajectory is k4_vs_plain's) and the critic pass's values against
    # theirs (CRITIC_TOL, which their 1xTF32 emulation exceeds), two runs
    # bitwise equal, and both kernels' times and bounds
    wide = (256, 256)
    assert fr.rollout_fits(body, wide)
    stw = make_ppo(wide, S, A, Config()).init(0, dev)
    stw = stw._replace(norm_avg=st.norm_avg, norm_std=st.norm_std)
    with torch.no_grad():
        stw.act.std_log.fill_(-0.5)
    netw = (stw.act_flat, stw.cri_flat, stw.norm_avg, stw.norm_std)
    n, h = PPO_STOCK['envs'], PPO_STOCK['horizon']
    f0, i0 = start_rows(n, T - 61, g)
    bkw = dict(net_dims=wide, reward_scale=2.0 ** -8, body=body)
    got = fr.rollout(*netw, f0, i0, horizon_len=h, seed=seed, **bkw)
    again = fr.rollout(*netw, f0, i0, horizon_len=h, seed=seed, **bkw)
    want1 = fr.rollout_reference(*netw, f0, i0, horizon_len=1, seed=seed, **bkw)
    torch.cuda.synchronize()
    assert all(torch.equal(getattr(got, f), getattr(again, f)) for f in got._fields)
    assert market_shared(got.states)
    v_ref = fr.critic_values_reference(stw.cri_flat, stw.norm_avg, stw.norm_std, got.states,
                                       net_dims=wide)
    wide_err = dict(values=float((got.values - v_ref).abs().max()),
                    step0_actions=float((got.actions[0] - want1.actions[0]).abs().max()),
                    step0_logprobs=float((got.logprobs[0] - want1.logprobs[0]).abs().max()))
    wide_tol = dict(values=CRITIC_TOL, step0_actions=1e-4, step0_logprobs=1e-4)
    assert all(wide_err[f] <= t for f, t in wide_tol.items()), wide_err
    wide_tf32 = float((critic_1xtf32(stw.cri_flat, stw.norm_avg, stw.norm_std, got.states, wide)
                       - v_ref).abs().max())
    assert wide_tf32 > CRITIC_TOL, ('the critic limit does not part 1xTF32', wide_tf32)
    w_ms = cuda_ms(torch, lambda: fr.rollout(*netw, f0, i0, horizon_len=h, seed=seed, **bkw),
                   reps=5, warmup=1)
    wc_ms = cuda_ms(torch, lambda: fr.critic_values(stw.cri_flat, stw.norm_avg, stw.norm_std,
                                                    got.states, net_dims=wide), reps=10, warmup=2)
    wc_plain = cuda_ms(torch, lambda: fr.critic_values_reference(
        stw.cri_flat, stw.norm_avg, stw.norm_std, got.states, net_dims=wide), reps=2)
    (wb_ms, wb_by), _ = onpolicy_bound(n, h, stw.act_flat.numel(), stw.cri_flat.numel(), wide)
    (wcb_ms, _), (wcf_ms, _), (wct_ms, wct_by) = critic_bounds(n, h, stw.cri_flat.numel(), wide)
    emit(phase='k4_vs_plain_wide', recipe='ppo_stock', net_dims=wide, envs=n, horizon=h,
         max_abs_err=wide_err, critic_1xtf32_max_abs_err=wide_tf32, two_runs_bitwise_equal=True,
         cluster=fr._library().stock_rollout_cluster(n, *wide, 0, 0), ms=w_ms, bound_ms=wb_ms,
         bound_by=wb_by, critic_ms=wc_ms, critic_plain_ms=wc_plain, critic_bound_ms=wct_ms,
         critic_bound_by=wct_by, critic_bound_ms_market_once=wcb_ms, critic_bound_ms_full=wcf_ms,
         ms_covers='the actor-only rollout kernel and the critic pass', tolerance=wide_tol)
    k4['ppo_stock']['critic']['wide'] = dict(net_dims=list(wide), ms=wc_ms, plain_ms=wc_plain,
                                             bound_ms=wct_ms, bound_by=wct_by,
                                             max_abs_err=wide_err['values'])
    # and the critic pass alone at (448, 448), the stock actor kernel's widest
    # width, where it takes 64-sample tiles (128 do not fit a block), on the
    # same states: CRITIC_TOL (its 1xTF32 emulation exceeds it) and two runs
    # bitwise equal
    cri448 = make_ppo((448, 448), S, A, Config()).init(1, dev).cri_flat
    v448 = fr.critic_values(cri448, st.norm_avg, st.norm_std, got.states, net_dims=(448, 448))
    again448 = fr.critic_values(cri448, st.norm_avg, st.norm_std, got.states,
                                net_dims=(448, 448))
    ref448 = fr.critic_values_reference(cri448, st.norm_avg, st.norm_std, got.states,
                                        net_dims=(448, 448))
    torch.cuda.synchronize()
    err448 = float((v448 - ref448).abs().max())
    assert torch.equal(v448, again448) and err448 <= CRITIC_TOL, err448
    tf32_448 = float((critic_1xtf32(cri448, st.norm_avg, st.norm_std, got.states, (448, 448))
                      - ref448).abs().max())
    assert tf32_448 > CRITIC_TOL, ('the critic limit does not part 1xTF32', tf32_448)
    ms448 = cuda_ms(torch, lambda: fr.critic_values(cri448, st.norm_avg, st.norm_std, got.states,
                                                    net_dims=(448, 448)), reps=10, warmup=2)
    (_, _), (_, _), (b448, by448) = critic_bounds(n, h, cri448.numel(), (448, 448))
    emit(phase='critic_vs_plain_448', net_dims=[448, 448], envs=n, horizon=h,
         max_abs_err=err448, critic_1xtf32_max_abs_err=tf32_448, two_runs_bitwise_equal=True,
         ms=ms448, bound_ms=b448, bound_by=by448, tolerance=CRITIC_TOL)

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
    # and the ddpg head at (512, 512), past the resident design's 448: the
    # streamed one, with the same checks
    for head, dims in (('ddpg', STOCK_NET), ('sac', STOCK_NET), ('modsac', STOCK_NET),
                       ('ddpg', (512, 512))):
        n, h = STOCK_OFF['envs'], STOCK_OFF['horizon']
        d1, d2 = dims
        heads = {'sac': [((d2, 2 * A), 0.1)], 'modsac': [((d2, A), 0.1)] * 2}.get(head)
        nets = [((S, d1, d2, A), 0.1)] if head == 'ddpg' else [((S, d1, d2), None)] + heads
        flat = init_flat(torch.Generator().manual_seed(7), nets, dev)
        gx = g if dims == STOCK_NET else torch.Generator(device=dev).manual_seed(59)
        f0, i0 = start_rows(n, T - 17, gx)
        nz = noise(gx, h, n)
        kw = dict(body=body, head=head, net_dims=dims, reward_scale=1.0, noise_std=0.1,
                  explore_rate=0.25, std_clip=(-20.0, 2.0) if head == 'modsac' else (-16.0, 2.0))
        report = {}
        for mode, extra in (('injected', dict(noise=nz)), ('philox', dict(seed=seed))):
            trace = []
            got = fr.offpolicy_rollout(flat, f0, i0, horizon_len=h, **kw, **extra)
            again = fr.offpolicy_rollout(flat, f0, i0, horizon_len=h, **kw, **extra)
            want = fr.offpolicy_rollout_reference(flat, f0, i0, horizon_len=h, env_trace=trace,
                                                  **kw, **extra)
            torch.cuda.synchronize()
            assert all(torch.equal(getattr(got, f), getattr(again, f)) for f in got._fields), (
                'K4 off-policy runs differ', head, mode)
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
        # the bound counts W1's market columns once a step (every lane of a
        # step shares the day), as the kernel applies them; bound_ms_full_obs
        # counts all S columns for every lane and step
        out_rows = 2 * A if head != 'ddpg' else A
        L, M = 1 + A, S - 1 - A
        flop = 2 * (L * d1 + d1 * d2 + d2 * out_rows) * n * h + 2 * M * d1 * h
        flop_full = 2 * (S * d1 + d1 * d2 + d2 * out_rows) * n * h
        rows = body.n_f32 + body.n_i32
        nbytes = 4 * (flat.numel() + 2 + 2 * rows * n + h * M + n * h * (S + A + 3))
        b_ms, b_by = bound(flop, nbytes)
        full_ms, _ = bound(flop_full, nbytes)
        streamed = not fr.offpolicy_fits_resident(body, head, dims)
        picked = fr._library().offpolicy_rollout_cluster(
            body.kernel_id, fr.OFFPOLICY_HEADS[head], n, d1, d2, 0,
            fr.STREAMED if streamed else 0)
        emit(phase='k4_offpolicy_vs_plain', kernel=f'fused_rollout[StockTradingEnv-v2,{head}]',
             net_dims=dims, design='streamed' if streamed else 'resident',
             envs=n, horizon=h, trajectory=report, one_step=one,
             one_step_lot_flips=int(flip.sum()), lot_flips_explained=int(explained[flip].sum()),
             two_runs_bitwise_equal=True, cluster=picked,
             ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bound_ms_full_obs=full_ms,
             tolerance={'actions': 1e-4, 'rewards': 1e-4, 'states': 1e-5, 'env_f': 1e-6,
                        'share_parted': 0.25})
        k4_off[head if dims == STOCK_NET else f'{head}_{d1}_streamed'] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=max(one['actions'],
                                                                       one['rewards']),
                            bound_ms=b_ms, bound_by=b_by, bound_ms_full_obs=full_ms)

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
        fr.critic_values.launches_by_kind.clear()
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

    def timed(path, phase, want, hyper=None, **extra):
        text = io.StringIO()
        a = stock_args(path, **(hyper or {}))
        with contextlib.redirect_stdout(text):
            ctx = build_training(a)
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
        kinds = dict(fr.rollout.launches_by_body), dict(fr.critic_values.launches_by_kind)
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
             net_dims=tuple(a.net_dims), rounds=ROUNDS, launches=launches,
             launches_by_kind=kinds, update_path=update,
             round_ms=round_ms, env_steps_per_s=path['envs'] * path['horizon'] / (round_ms / 1e3),
             metrics=dict(zip(sorted(m), mvals[-1].tolist())), max_param_change=moved,
             device=name, nvidia_smi=smi, **extra)
        return launches, update, kinds

    stock_launches, _, _ = timed(PPO_STOCK, 'main_path_stock', {
        'fused_rollout': ROUNDS, 'critic_values': ROUNDS, 'ppo_update': ROUNDS},
        fused_rollout_ms=k4['ppo_stock']['ms'], critic_ms=k4['ppo_stock']['critic']['ms'])
    stock4k_launches, update, _ = timed(PPO_STOCK_4K, 'main_path_stock_4k', {
        'fused_rollout': ROUNDS, 'critic_values': ROUNDS, 'ppo_update': 0},
        fused_rollout_ms=k4['ppo_stock_4k']['ms'],
        critic_ms=k4['ppo_stock_4k']['critic']['ms'])
    assert update.startswith('pytorch'), update
    # ppo_stock at (640, 640) in float32, past both resident designs: the
    # streamed actor kernel and the streamed critic pass (32-sample tiles)
    # once a round, and the autograd update (at these widths the JAX
    # package's fused update does not fit its VMEM budget: XLA ops there)
    _, update, wide_kinds = timed(PPO_STOCK, 'main_path_stock_wide', {
        'fused_rollout': 0, 'critic_values': ROUNDS, 'ppo_update': 0},
        hyper=dict(net_dims=(640, 640), compute_dtype='float32'),
        fused_rollout_ms=k4['ppo_stock_640_streamed']['ms'],
        critic_ms=k4['ppo_stock_640_streamed']['critic']['ms'])
    assert wide_kinds == ({'StockTradingEnv-v2,streamed': ROUNDS},
                          {'float32,streamed': ROUNDS}), wide_kinds
    assert update.startswith('pytorch'), update
    # ppo_stock at (1280, 1280) and (1536, 1536), past the actor's 32-lane
    # groups: the actor kernel on 16-lane groups and the critic pass on 32-
    # and 16-sample tiles once a round, the autograd update
    narrow_kinds = {}
    for dims, critic_kind in (((1280, 1280), 'float32,streamed'),
                              ((1536, 1536), 'float32,streamed16')):
        recipe = f'ppo_stock_{dims[0]}_narrow'
        _, update, kinds = timed(PPO_STOCK, f'main_path_stock_narrow_{dims[0]}', {
            'fused_rollout': 0, 'critic_values': ROUNDS, 'ppo_update': 0},
            hyper=dict(net_dims=dims, compute_dtype='float32'),
            fused_rollout_ms=k4[recipe]['ms'], critic_ms=k4[recipe]['critic']['ms'])
        assert kinds == ({'StockTradingEnv-v2,streamed16': ROUNDS}, {critic_kind: ROUNDS}), kinds
        assert update.startswith('pytorch'), update
        narrow_kinds[dims[0]] = kinds

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
                        'bound_by': c['bound_by'], 'library_ms': None,
                        'bound_ms_market_once': c['bound_ms_market_once'],
                        'bound_ms_full': c['bound_ms_full'],
                        **({'wide': c['wide']} if 'wide' in c else {})})
    kernels.append({'name': 'ppo_update[StockTradingEnv-v2]', 'route': 'cuda',
                    'source': 'elegantrl_tpu_torch/ops/csrc/ppo_update.cu',
                    'replaces': 'elegantrl_tpu/ops/pallas_update.py:79',
                    'launches': stock_launches['ppo_update'],
                    'max_abs_err': k2_stock['max_abs_err'], 'ms': k2_stock['ms'],
                    'plain_ms': k2_stock['plain_ms'], 'bound_ms': k2_stock['bound_ms'],
                    'bound_by': k2_stock['bound_by'], 'library_ms': None})
    for head, k in k4_off.items():
        if head.endswith('streamed'):
            continue
        kernels.append({'name': f'fused_rollout[StockTradingEnv-v2,{head}]', 'route': 'cuda',
                        'source': src, 'replaces': 'elegantrl_tpu/ops/pallas_rollout.py:451',
                        'launches': off_runs[head], 'max_abs_err': k['max_abs_err'],
                        'ms': k['ms'], 'plain_ms': k['plain_ms'], 'bound_ms': k['bound_ms'],
                        'bound_by': k['bound_by'], 'library_ms': None,
                        'bound_ms_full_obs': k['bound_ms_full_obs']})
    # the streamed designs of K4's actor kernel (stock_actor_kernel<HEAD, BF,
    # true>) and critic pass (critic_values_kernel<32, BF>): their entries are
    # main_path_stock_wide's at (640, 640); the other streamed checks
    # ((512, 512), the ddpg head) ride along
    k = k4['ppo_stock_640_streamed']
    kernels.append({'name': 'fused_rollout[StockTradingEnv-v2,gaussian,256 envs,streamed]',
                    'route': 'cuda', 'source': src,
                    'replaces': 'elegantrl_tpu/ops/pallas_rollout.py:451',
                    'launches': wide_kinds[0]['StockTradingEnv-v2,streamed'],
                    'max_abs_err': k['max_abs_err'], 'ms': k['ms'], 'plain_ms': k['plain_ms'],
                    'bound_ms': k['bound_ms'], 'bound_by': k['bound_by'], 'library_ms': None,
                    'net_dims': k['net_dims'], 'bound_ms_full_obs': k['bound_ms_full_obs'],
                    'cluster': k['cluster'],
                    'checks': {'ppo_stock_512': {f: k4['ppo_stock_512_streamed'][f] for f in (
                        'ms', 'plain_ms', 'bound_ms', 'max_abs_err', 'cluster')},
                        'ddpg_512': {f: k4_off['ddpg_512_streamed'][f] for f in (
                            'ms', 'plain_ms', 'bound_ms', 'max_abs_err')}}})
    c = k['critic']
    kernels.append({'name': 'critic_values[StockTradingEnv-v2,256 envs,streamed]',
                    'route': 'cuda', 'source': src,
                    'replaces': 'elegantrl_tpu/ops/pallas_rollout.py:600',
                    'launches': wide_kinds[1]['float32,streamed'],
                    'max_abs_err': c['max_abs_err'], 'ms': c['ms'], 'plain_ms': c['plain_ms'],
                    'bound_ms': c['bound_ms'], 'bound_by': c['bound_by'], 'library_ms': None,
                    'net_dims': k['net_dims'], 'tile': k['critic_tile'],
                    'bound_ms_market_once': c['bound_ms_market_once'],
                    'bound_ms_full': c['bound_ms_full']})
    # the narrower groups: the actor on 16-lane groups (main_path_stock_narrow_1280's
    # launches; the (1536, 1536) check rides along) and the critic pass on
    # 16-sample tiles (main_path_stock_narrow_1536's)
    k = k4['ppo_stock_1280_narrow']
    kernels.append({'name': 'fused_rollout[StockTradingEnv-v2,gaussian,256 envs,streamed16]',
                    'route': 'cuda', 'source': src,
                    'replaces': 'elegantrl_tpu/ops/pallas_rollout.py:451',
                    'launches': narrow_kinds[1280][0]['StockTradingEnv-v2,streamed16'],
                    'max_abs_err': k['max_abs_err'], 'ms': k['ms'], 'plain_ms': k['plain_ms'],
                    'bound_ms': k['bound_ms'], 'bound_by': k['bound_by'], 'library_ms': None,
                    'net_dims': k['net_dims'], 'bound_ms_full_obs': k['bound_ms_full_obs'],
                    'cluster': k['cluster'],
                    'checks': {'ppo_stock_1536': {f: k4['ppo_stock_1536_narrow'][f] for f in (
                        'ms', 'plain_ms', 'bound_ms', 'max_abs_err', 'cluster')}}})
    k = k4['ppo_stock_1536_narrow']
    c = k['critic']
    kernels.append({'name': 'critic_values[StockTradingEnv-v2,256 envs,streamed16]',
                    'route': 'cuda', 'source': src,
                    'replaces': 'elegantrl_tpu/ops/pallas_rollout.py:600',
                    'launches': narrow_kinds[1536][1]['float32,streamed16'],
                    'max_abs_err': c['max_abs_err'], 'ms': c['ms'], 'plain_ms': c['plain_ms'],
                    'bound_ms': c['bound_ms'], 'bound_by': c['bound_by'], 'library_ms': None,
                    'net_dims': k['net_dims'], 'tile': k['critic_tile'],
                    'bound_ms_market_once': c['bound_ms_market_once'],
                    'bound_ms_full': c['bound_ms_full']})
    return kernels


# ----------------------------------------------- K4 bf16, host envs, pixels

# the ppo_isaac_mock recipe (examples/plan_Isaac_Gym.py:85-97), the
# modsac_lander_host shape (scripts/verify_learning.py:451-466) and the
# pixelppo_chasing recipe (scripts/verify_learning.py:186-197)
ISAAC_MOCK = dict(envs=64, horizon=40, net=(128, 128), batch=512, repeat=32.0, lr=1e-3,
                  reward_scale=4.0, gamma=0.95)
MODSAC_HOST = dict(envs=16, horizon=64, net=(256, 256), buffer=int(5e4), batch=1024,
                   repeat=1.0, lr=1e-4, reward_scale=0.5)
PIXEL_PPO = dict(envs=128, horizon=64, net=(128,), encoder=128, batch=512, repeat=256.0,
                 lr=3e-4, gamma=0.97)


class HostLanderEnv:
    """A gym-protocol env in numpy (no gymnasium on the card's machine): a 2-D
    lander with LunarLanderContinuous's shapes (8 obs, 2 actions in [-1, 1],
    1000 steps), thrust against gravity towards the pad at the origin; a
    crash or a landing ends the episode, the time limit truncates it."""

    def __init__(self):
        self._rng = np.random.default_rng(0)
        self._s = np.zeros(6)
        self._t = 0

    def reset(self, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._s = np.concatenate([self._rng.uniform(-1, 1, 2) * [0.5, 0.1] + [0.0, 1.4],
                                  self._rng.uniform(-0.5, 0.5, 2), [0.0, 0.0]])
        self._t = 0
        return self._obs(), {}

    def _obs(self):
        x, y, vx, vy, ang, vang = self._s
        return np.array([x, y, vx, vy, ang, vang, float(y <= 0.0), float(y <= 0.0)], np.float32)

    def step(self, action):
        a = np.clip(np.asarray(action, np.float64), -1.0, 1.0)
        x, y, vx, vy, ang, vang = self._s
        main = max(a[0], 0.0)
        vang += 0.05 * a[1]
        ang += 0.05 * vang
        vx += 0.05 * (-np.sin(ang) * main)
        vy += 0.05 * (np.cos(ang) * main * 2.0 - 1.0)
        x, y = x + 0.05 * vx, y + 0.05 * vy
        self._s = np.array([x, y, vx, vy, ang, vang])
        self._t += 1
        shaping = -np.hypot(x, y) - np.hypot(vx, vy) - abs(ang)
        landed = y <= 0.0 and abs(vy) < 0.5 and abs(x) < 0.2
        crashed = y <= 0.0 and not landed or abs(x) > 1.5
        reward = shaping - 0.3 * main + (100.0 if landed else -100.0 if crashed else 0.0)
        return (self._obs(), float(reward), bool(landed or crashed), self._t >= 1000, {})


def profiled_rounds(torch, step, rounds):
    """``rounds`` calls of ``step`` under the profiler: (host ms per round,
    device busy ms per round, idle share, device events per round); busy is
    the sum of the CUDA kernels' durations (one stream: they do not
    overlap)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in evs) / 1e3
    return wall / rounds, busy / rounds, 1.0 - busy / wall, len(evs) / rounds


def bf16_host_pixel_phases(torch, dev, name, smi, bound, seed):
    """K4's bf16 variants (the stock actor kernel under every head and the
    critic pass), the float32 kernels with bf16 storage, and the main paths
    of the bf16 stock recipe, the Isaac adapter, the host pool and the pixel
    agent; returns their entries of the kernels line."""
    import contextlib
    import io
    from elegantrl_tpu_torch import (AgentPixelPPO, Config, PixelChasingEnv, build_training,
                                     make_host_env, make_isaac_env, train_agent, valid_agent)
    from elegantrl_tpu_torch.agents import AgentModSAC, AgentPPO
    from elegantrl_tpu_torch.agents.ppo import make_ppo
    from elegantrl_tpu_torch.envs import StockTradingVecEnv
    from elegantrl_tpu_torch.envs.base import EnvSpec
    from elegantrl_tpu_torch.envs.host_env import HostLink, host_collect_rollout
    from elegantrl_tpu_torch.envs.isaac import mock_vectask
    from elegantrl_tpu_torch.ops import fused_offpolicy_update as fo, fused_rollout as fr
    from elegantrl_tpu_torch.ops import kernels as kn
    from elegantrl_tpu_torch.ops.fused_update import ppo_update
    from elegantrl_tpu_torch.ops.nets import gelu, ppo_param_shapes, split_flat

    bfr = torch.bfloat16
    env_def = StockTradingVecEnv(num_envs=1)._def
    body = env_def.kernel_body
    S, A, NR = body.state_dim, body.action_dim, body.n_reset
    T = body.tables.close.shape[0]
    L, M = 1 + A, S - 1 - A
    src = 'elegantrl_tpu_torch/ops/csrc/fused_rollout.cu'
    peak_tflops, peak_tbs = peaks_for(name)[1]
    g = torch.Generator(device=dev).manual_seed(43)

    def start_rows(n, day):
        f, _ = body.pack(env_def.init(g, n, dev))
        return f.contiguous(), torch.full((1, n), day, dtype=torch.int32, device=dev)

    def noise(h, n):
        return torch.cat([torch.randn((h, A, n), generator=g, device=dev),
                          torch.rand((h, NR, n), generator=g, device=dev)], 1).contiguous()

    def bf16_bound(flop_tc, flop_rest, nbytes):
        """The bf16 variants' least time: the products of bf16 operands at the
        dense bf16 tensor rate beside the rest at the FP32 rate, against the
        bytes; and the same work all at the FP32 rate (bound_ms_fp32)."""
        t_tc = flop_tc / (H100_BF16_TFLOPS * 1e12)
        t_rest = flop_rest / (peak_tflops * 1e12)
        t_bytes = nbytes / (peak_tbs * 1e12)
        fp32 = bound(flop_tc + flop_rest, nbytes)[0]
        t = max(t_tc + t_rest, t_bytes)
        return t * 1e3, ('operations' if t_tc + t_rest >= t_bytes else 'bytes'), fp32

    def as_f32(out):
        return out._replace(states=out.states.float(), actions=out.actions.float())

    def bf16_interval(v):
        """The float32 values that round to the bf16 values ``v`` (round to
        nearest): ``v`` plus or minus half the bf16 spacing at ``|v|``, which
        is exact arithmetic of the rounding, not a tolerance."""
        v = v.float()
        e = torch.frexp(v)[1]
        half = torch.where(v == 0, torch.zeros_like(v), torch.pow(2.0, (e - 9).float()))
        return v - half, v + half

    def flips_at_edges(got1, want1, got_lo, got_hi, env_want, u_reset):
        """One step from the same rows: the samples whose lots differ, and
        whether each sits at a lot edge.  ``env_want`` is the float32 action
        the plain version's env stepped on (its ``env_actions``); the
        kernel's env action lies in ``[got_lo, got_hi]``: one value, or,
        where the kernel stores its actions in bf16 while its env steps on
        the float32 ones, the values that round to the stored one.  At the
        first stock whose lots differ (the cash before it is equal on both
        sides) a flip is at an edge when the kernel's interval lies within
        BF16_TOL['one_step'] of ``env_want`` and either a lot edge trunc(100
        a) or a dead-zone edge |a| = 0.1 lies between the two, or
        ``env_want`` is within 1e-3 lots (or 1e-6) of an edge (the env's own
        rounding); where the step reset the lane, the reset's normal is
        within 1e-4 of 1 or 2."""
        lots_g, lots_w = got1.env_f[1:1 + A], want1.env_f[1:1 + A]
        flip = (lots_g != lots_w).any(0)
        k = torch.argmax((lots_g != lots_w).int(), 0)
        lo, hi = torch.minimum(got_lo, env_want), torch.maximum(got_hi, env_want)
        near = torch.maximum(got_lo - env_want, env_want - got_hi) <= BF16_TOL['one_step']
        xw = 100.0 * env_want
        dead = lambda a: a.abs() < 0.1  # noqa: E731
        edge = near & ((torch.trunc(100.0 * lo) != torch.trunc(100.0 * hi))
                       | (dead(lo) != dead(hi))
                       | ((xw - torch.round(xw)).abs() < 1e-3)
                       | ((env_want.abs() - 0.1).abs() < 1e-6))
        p = (A + 1) // 2
        r = torch.sqrt(-2.0 * torch.log(1.0 - u_reset[1:1 + p]))
        ang = 2 * math.pi * u_reset[1 + p:1 + 2 * p]
        z = torch.cat([r * torch.cos(ang), r * torch.sin(ang)])[:A].abs()
        near_z = ((z - 1).abs() < 1e-4) | ((z - 2).abs() < 1e-4)
        pick = lambda m: m.gather(0, k[None])[0]  # noqa: E731
        explained = torch.where(got1.terminals[0].bool(), pick(near_z), pick(edge))
        return flip, explained

    def kernel_env_action(out, on, stored_bf16):
        """The kernel's env action as an interval (lo, hi), ``(A, samples)``:
        on-policy tanh of its float32 action; off-policy its action, widened
        to the values that round to it where it was stored in bf16."""
        if on:
            a = torch.tanh(out.actions[0])
            return a, a
        a = out.actions[0].float().T
        return bf16_interval(a) if stored_bf16 else (a, a)

    def one_step_bf16(got1, want1, flip, n_samples, on):
        """BF16_TOL's one-step reading over the samples without a lot flip:
        per sample the largest difference of its stored state and action,
        reward, and on-policy its logprob and value."""
        def per_sample(f):
            d = (getattr(got1, f).float() - getattr(want1, f).float()).abs()[0]
            return d if d.dim() == 1 else d.amax(0 if on else 1)
        fields = ['states', 'actions', 'rewards'] + (['logprobs', 'values'] if on else [])
        sample = torch.stack([per_sample(f) for f in fields]).amax(0)[~flip]
        one = dict(max_abs=float(sample.max()), flips=int(flip.sum()),
                   share_over_1e4=float((sample > 1e-4).float().mean()))
        one['within'] = (one['flips'] <= BF16_TOL['flip_share'] * n_samples
                         and one['max_abs'] <= BF16_TOL['one_step']
                         and one['share_over_1e4'] <= BF16_TOL['share_over_1e4'])
        return one

    # ---- k4_bf16_vs_plain, k4_store_bf16_vs_plain: the stock actor kernel
    # (and on-policy the critic pass) under bf16 compute with both storage
    # types, and the float32 kernels with bf16 storage, against the plain
    # version in the same types: ppo_stock's 256 and ppo_stock_4k's 4096
    # envs (PPO head, H 128, from day T - 61: every lane resets once), the
    # ddpg, sac and modsac heads at 1024 envs x 32.  Tolerances: two runs
    # bitwise equal in both noise modes; one step from every visited state
    # (injected noise) within BF16_TOL on the samples without a lot flip,
    # every lot flip at a lot edge of the two versions' actions (bf16 sums
    # in another order part an action by a last bit, and at a bf16 rounding
    # boundary of a hidden activation by about |w| 2^-8 |h|); whole
    # trajectories: a lot flip parts a lane for good (the stock rule: at
    # most a quarter parted), the others within BF16_TOL['trajectory'] and
    # with equal lots at the end.  Control (bf16 compute): the float32
    # kernel on the same one-step inputs must break BF16_TOL.
    st = make_ppo(STOCK_NET, S, A, Config()).init(0, dev)
    st = st._replace(norm_avg=torch.rand(S, generator=g, device=dev) * 0.4 - 0.2,
                     norm_std=torch.rand(S, generator=g, device=dev) + 0.7)
    with torch.no_grad():
        st.act.std_log.fill_(-0.5)
    net = (st.act_flat, st.cri_flat, st.norm_avg, st.norm_std)
    D1, D2 = STOCK_NET
    res = {}
    cases = [('ppo', n, c, s, STOCK_NET) for n in (PPO_STOCK['envs'], PPO_STOCK_4K['envs'])
             for c, s in ((bfr, False), (bfr, True), (None, True))]
    cases += [(head, STOCK_OFF['envs'], c, s, STOCK_NET) for head in fr.CONTINUOUS_HEADS
              for c, s in ((bfr, False), (bfr, True), (None, True))]
    # ppo_stock's rollout at (1024, 1024) in bf16, past the resident designs:
    # the streamed actor kernel and critic pass, the same checks
    cases += [('ppo', PPO_STOCK['envs'], bfr, False, (1024, 1024))]
    for head, n, compute, store, dims in cases:
        d1, d2 = dims
        streamed = dims != STOCK_NET
        if streamed:   # its draws leave the later checks' inputs as they were
            g_state = g.get_state()
        on = head == 'ppo'
        h = PPO_STOCK['horizon'] if on else STOCK_OFF['horizon']
        f0, i0 = start_rows(n, T - 61 if on else T - 21)
        nz = noise(h, n)
        sdt = bfr if store else None
        tag = (f'fused_rollout{"_bf16" if compute else ""}[StockTradingEnv-v2,'
               f'{"gaussian" if on else head},{n} envs,store={"bf16" if store else "f32"}'
               f'{f",{dims},streamed" if streamed else ""}]')
        if on:
            if streamed:
                netd = make_ppo(dims, S, A, Config()).init(3, dev)
                netd = netd._replace(norm_avg=st.norm_avg, norm_std=st.norm_std)
                with torch.no_grad():
                    netd.act.std_log.fill_(-0.5)
                net = (netd.act_flat, netd.cri_flat, netd.norm_avg, netd.norm_std)
            kw = dict(net_dims=dims, reward_scale=2.0 ** -8, body=body,
                      compute_dtype=compute, store_dtype=sdt)
            run = lambda f, i, hh, ctl=False, **x: fr.rollout(  # noqa: E731
                *net, f, i, horizon_len=hh, **(dict(kw, compute_dtype=None) if ctl else kw), **x)
            plain = lambda f, i, hh, **x: fr.rollout_reference(  # noqa: E731
                *net, f, i, horizon_len=hh, **kw, **x)
            flat_n = net[0].numel() + net[1].numel()
        else:
            shapes = fr.offpolicy_head_shapes(S, STOCK_NET, A, head)
            flat = (torch.randn(sum(math.prod(x) for x in shapes), generator=g, device=dev)
                    * 0.05).contiguous()
            kw = dict(body=body, head=head, net_dims=STOCK_NET, reward_scale=1.0, noise_std=0.1,
                      std_clip=std_clip(head), compute_dtype=compute, store_dtype=sdt)
            run = lambda f, i, hh, ctl=False, **x: fr.offpolicy_rollout(  # noqa: E731
                flat, f, i, horizon_len=hh, **(dict(kw, compute_dtype=None) if ctl else kw), **x)
            plain = lambda f, i, hh, **x: fr.offpolicy_rollout_reference(  # noqa: E731
                flat, f, i, horizon_len=hh, **kw, **x)
            flat_n = flat.numel()
        report = {}
        for mode, extra in (('injected', dict(noise=nz)), ('philox', dict(seed=seed))):
            trace = []
            got, again = run(f0, i0, h, **extra), run(f0, i0, h, **extra)
            want = plain(f0, i0, h, env_trace=trace, **extra)
            torch.cuda.synchronize()
            assert all(torch.equal(getattr(got, f), getattr(again, f)) for f in got._fields), (
                tag, mode, 'two runs differ')
            assert got.states.dtype == (bfr if store else torch.float32), tag
            gf, wf = as_f32(got), as_f32(want)
            assert torch.equal(got.terminals, want.terminals), (tag, mode)
            sg = gf.states if on else gf.states.transpose(1, 2)
            sw = wf.states if on else wf.states.transpose(1, 2)
            assert torch.equal(sg[:, 1 + A:], sw[:, 1 + A:]), (tag, 'market rows')
            lot = ((sg[:, 1:1 + A] - sw[:, 1:1 + A]).abs() > 1e-6).any(1)
            act_d = (gf.actions - wf.actions).abs().amax(1 if on else -1)
            bad = lot | (act_d > BF16_TOL['trajectory'])
            # a flip at the last step shows only in the final env rows
            parted = bad.any(0) | (got.env_f[1:1 + A] != want.env_f[1:1 + A]).any(0)
            share = float(parted.float().mean())
            assert share <= 0.25, (tag, mode, share)
            rel_end = ((got.env_f - want.env_f).abs() / want.env_f.abs().clamp_min(1.0))[:, ~parted]
            assert rel_end.numel() == 0 or float(rel_end.max()) <= 1e-4, (tag, mode)
            kept_err = float(act_d[:, ~parted].max()) if bool((~parted).any()) else 0.0
            assert kept_err <= BF16_TOL['trajectory'], (tag, mode, kept_err)
            report[mode] = dict(lanes_parted=int(parted.sum()), share_parted=share,
                                max_abs_diff_kept=kept_err)
            if mode == 'injected':
                inj = trace
        f_all = torch.cat([f for f, _ in inj], dim=1).contiguous()
        i_all = torch.cat([i for _, i in inj], dim=1).contiguous()
        nz_all = nz.transpose(0, 1).reshape(1, nz.shape[1], h * n).contiguous()
        env_acts = []
        w1 = plain(f_all, i_all, 1, noise=nz_all, env_actions=env_acts)
        g1 = run(f_all, i_all, 1, noise=nz_all)
        torch.cuda.synchronize()
        env_w, rounded = env_acts[0], store and not on
        g_lo, g_hi = kernel_env_action(g1, on, rounded)
        flip, explained = flips_at_edges(g1, w1, g_lo, g_hi, env_w, nz_all[0, A:])
        assert bool(explained[flip].all()), (tag, 'lot flips off an edge',
                                             int((~explained[flip]).sum()))
        one = one_step_bf16(g1, w1, flip, h * n, on)
        assert one['within'], (tag, one)
        r = dict(name=tag, trajectory=report, one_step=one, max_abs_err=one['max_abs'],
                 lot_flips_explained=int(explained[flip].sum()))
        if rounded:   # how many flips the stored actions' rounding interval explains
            _, at_stored = flips_at_edges(g1, w1, *kernel_env_action(g1, on, False), env_w,
                                          nz_all[0, A:])
            r['lot_flips_needing_the_rounding_interval'] = int((~at_stored[flip]).sum())
        if compute is not None:
            c1 = run(f_all, i_all, 1, ctl=True, noise=nz_all)
            cf, _ = flips_at_edges(c1, w1, *kernel_env_action(c1, on, rounded), env_w,
                                   nz_all[0, A:])
            control = one_step_bf16(c1, w1, cf, h * n, on)
            assert not control['within'], ('the f32 kernel passed BF16_TOL', tag, control)
            r['control_f32_kernel'] = control
        r['ms'] = cuda_ms(torch, lambda: run(f0, i0, h, seed=seed), reps=10, warmup=2)
        r['plain_ms'] = cuda_ms(torch, lambda: plain(f0, i0, h, seed=seed), reps=1)
        bf = int(compute is not None)
        if on:
            r['cluster'] = fr._library().stock_rollout_cluster(
                n, d1, d2, 0, bf | (fr.STREAMED if streamed else 0))
            r['cluster_ms'] = {c: cuda_ms(torch, lambda: fr.rollout(
                *net, f0, i0, horizon_len=h, seed=seed, stock_cluster=c, **kw), reps=5)
                for c in (1, 2, 4, 8)
                if fr.actor_smem_bytes(S, dims, A, c, bf16=bool(bf), streamed=streamed)
                <= fr.SMEM_LIMIT}
            r['critic_tile'] = fr.critic_tile(dims)
        else:
            r['cluster'] = fr._library().offpolicy_rollout_cluster(
                body.kernel_id, fr.OFFPOLICY_HEADS[head], n, d1, d2, 0, bf)
        # the actor's lane columns, layers 2 and 3 per lane and W1's market
        # columns once a step (the kernel's work); on-policy plus the critic
        # pass's share as the kernel computes it (critic_bf16_vs_plain)
        rows = 2 * A if head in ('sac', 'modsac') else A
        flop = 2 * (L * d1 + d1 * d2 + d2 * rows) * n * h + 2 * M * d1 * h
        if on:
            flop += 2 * (L * d1 + d1 * d2 + d2) * n * h + 2 * M * d1 * h * -(-n // 32)
        nbytes = (4 * (flat_n + 2 * S + 2 * (body.n_f32 + body.n_i32) * n + h * M)
                  + n * h * ((2 if store else 4) * S + 4 * (A + 5)))
        if compute is not None:
            r['bound_ms'], r['bound_by'], r['bound_ms_fp32'] = bf16_bound(flop, 0, nbytes)
        else:
            r['bound_ms'], r['bound_by'] = bound(flop, nbytes)
        res[(head, n, compute is not None, store) + ((dims,) if streamed else ())] = r
        if streamed:
            net = (st.act_flat, st.cri_flat, st.norm_avg, st.norm_std)
            g.set_state(g_state)
        emit(phase='k4_bf16_vs_plain' if compute is not None else 'k4_store_bf16_vs_plain',
             kernel=tag, envs=n, horizon=h, two_runs_bitwise_equal=True, **r,
             tolerance=dict(BF16_TOL, share_parted=0.25), device=name, nvidia_smi=smi)

    # ---- critic_bf16_vs_plain: the critic pass's bf16 variant (one mma.sync
    # m16n8k16 where the float32 pass issues three TF32 products) on the
    # stored bf16-compute states at 256 and 4096 envs, and at (576, 576),
    # the widest bf16 width (64-sample tiles), against the plain MLP in bf16:
    # within BF16_TOL (max 1e-2, at most 1% of the values beyond 1e-4); the
    # float32 pass on the same states must break it; two runs bitwise equal;
    # the groups share their market rows (the precondition, asserted).
    crit = {}
    for n, dims in ((256, STOCK_NET), (4096, STOCK_NET), (256, (576, 576)), (256, (1024, 1024))):
        f0, i0 = start_rows(n, T - 61)
        states = fr.rollout(*net, f0, i0, net_dims=STOCK_NET, horizon_len=128,
                            reward_scale=1.0, body=body, seed=seed, compute_dtype=bfr).states
        m = states[:, 1 + A:]
        first = torch.div(torch.arange(n, device=dev), 32, rounding_mode='floor') * 32
        assert torch.equal(m, m[:, :, first]), 'the critic pass precondition'
        if dims == (1024, 1024):
            # the streamed pass (32-sample tiles) on the critic as the agents
            # initialise it, as the K4 bf16 case above runs it: with N(0,
            # 0.05^2) weights at this width 2.5% of the values lay beyond
            # 1e-4 on an H100 (max 9.2e-4), where the bf16 rounding
            # boundaries of 1024 hidden units part the two sum orders
            cri = make_ppo(dims, S, A, Config()).init(4, dev).cri_flat
        else:
            cri = st.cri_flat if dims == STOCK_NET else (torch.randn(
                sum(math.prod(x) for x in ppo_param_shapes(S, dims, 1, True)[1]), generator=g,
                device=dev) * 0.05).contiguous()
        args_ = (cri, st.norm_avg, st.norm_std, states)
        v = fr.critic_values(*args_, net_dims=dims, compute_dtype=bfr)
        v2 = fr.critic_values(*args_, net_dims=dims, compute_dtype=bfr)
        want = fr.critic_values_reference(*args_, net_dims=dims, compute_dtype=bfr)
        ctl = fr.critic_values(*args_, net_dims=dims)
        torch.cuda.synchronize()
        assert torch.equal(v, v2), 'critic bf16 runs differ'
        d, dc = (v - want).abs(), (ctl - want).abs()
        one = dict(max_abs=float(d.max()), share_over_1e4=float((d > 1e-4).float().mean()))
        control = dict(max_abs=float(dc.max()), share_over_1e4=float((dc > 1e-4).float().mean()))
        assert one['max_abs'] <= BF16_TOL['one_step'] and \
            one['share_over_1e4'] <= BF16_TOL['share_over_1e4'], (n, dims, one)
        assert control['share_over_1e4'] > BF16_TOL['share_over_1e4'], (n, dims, control)
        ms = cuda_ms(torch, lambda: fr.critic_values(*args_, net_dims=dims, compute_dtype=bfr),
                     reps=10, warmup=2)
        f32_ms = cuda_ms(torch, lambda: fr.critic_values(*args_, net_dims=dims), reps=10)
        plain_ms = cuda_ms(torch, lambda: fr.critic_values_reference(
            *args_, net_dims=dims, compute_dtype=bfr), reps=2)
        d1, d2 = dims
        hh, groups = states.shape[0], states.shape[0] * -(-n // 32)
        nbytes = 4 * (cri.numel() + 2 * S + n * hh * 1 + groups * M) + 2 * n * hh * L
        b_ms, b_by, b32 = bf16_bound(2 * (L * d1 + d1 * d2) * n * hh,
                                     2 * d2 * n * hh + 2 * M * d1 * groups, nbytes)
        crit[(n, dims)] = dict(name=f'critic_values_bf16[StockTradingEnv-v2,{n} envs,{dims}]',
                               max_abs_err=one['max_abs'], one_step=one, control_f32_pass=control,
                               ms=ms, float32_pass_ms=f32_ms, plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, bound_ms_fp32=b32)
        emit(phase='critic_bf16_vs_plain', envs=n, horizon=hh, net_dims=dims,
             two_runs_bitwise_equal=True, precondition_holds=True, **crit[(n, dims)],
             tolerance={k: BF16_TOL[k] for k in ('one_step', 'share_over_1e4')}, device=name,
             nvidia_smi=smi)

    def timed_path(phase, step, rounds, steps_per_round, extra):
        """ms per round over ``rounds`` (CUDA events, the counts reset just
        before and read just after: the kernels' launches and the pool steps
        taken through a ``HostLink``, the host-rollout path), env-steps/s,
        then the profiled idle share over 3 more."""
        step()                                                   # warm-up round
        torch.cuda.synchronize()
        counters = dict(fused_rollout=fr.rollout, critic_values=fr.critic_values,
                        offpolicy_rollout=fr.offpolicy_rollout, ppo_update=ppo_update,
                        gae_vtrace=kn.gae_vtrace_kernel, fused_mlp3=kn.fused_mlp3,
                        buffer_gather=kn.buffer_gather_fields, sac_chunk=fo.sac_chunk)
        for fn in counters.values():
            fn.launches = 0
        fr.rollout.launches_by_body.clear()
        fr.critic_values.launches_by_kind.clear()
        HostLink.steps = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(rounds):
            step()
        end.record()
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
        by_kind = (dict(fr.rollout.launches_by_body), dict(fr.critic_values.launches_by_kind))
        host_steps = HostLink.steps
        round_ms = start.elapsed_time(end) / rounds
        host_ms, busy_ms, idle, events = profiled_rounds(torch, step, 3)
        emit(phase=phase, rounds=rounds, launches=launches, rollout_by_body=by_kind[0],
             critic_by_kind=by_kind[1], host_link_steps=host_steps, round_ms=round_ms,
             env_steps_per_s=steps_per_round / (round_ms / 1e3),
             profiled=dict(round_ms=host_ms, device_busy_ms=busy_ms, idle_share=idle,
                           device_events_per_round=events), **extra, device=name,
             nvidia_smi=smi)
        return launches, by_kind, host_steps

    def round_step(ctx):
        box = [ctx.carry]

        def step():
            box[0], m = ctx.round_fn(box[0])
            assert all(math.isfinite(float(v)) for k, v in m.items() if v.dim() == 0), m
        return step, box

    def entry_point(args, env_class, env_args, agent_class, net_dims, periods=2):
        """train_agent for ``periods`` evaluations, then valid_agent on the
        saved agent: its greedy episodes are finite."""
        with tempfile.TemporaryDirectory() as cwd:
            args.cwd, args.eval_times = cwd, 2
            args.eval_per_step = args.num_envs * args.horizon_len
            args.break_step = args.eval_per_step * (periods - 1)
            t0 = time.time()
            r = train_agent(args)
            assert r['recorder'].shape[0] == periods and np.isfinite(r['recorder']).all()
            played = valid_agent(env_class, env_args, net_dims, agent_class,
                                 os.path.join(cwd, 'agent.npz'), render_times=2)
            assert len(played) == 2 and all(math.isfinite(x) for x, _ in played), played
            emit(phase='train_agent', agent=agent_class.__name__, env=env_args['env_name'],
                 evaluations=int(r['recorder'].shape[0]), total_step=int(r['total_step']),
                 max_r=float(r['max_r']), seconds=round(time.time() - t0, 3),
                 valid_agent=played)

    # ---- main_path_stock_bf16: ppo_stock's shape with bf16 compute (K4 bf16,
    # the bf16 critic pass, K10, the autograd update: no K2, as the JAX package
    # under bf16 compute)
    stock_env_args = {'env_name': 'StockTradingEnv-v2', 'num_envs': PPO_STOCK['envs'],
                      'max_step': T - 1, 'state_dim': S, 'action_dim': A, 'if_discrete': False}

    def stock_bf16_args():
        a = Config(AgentPPO, StockTradingVecEnv, dict(stock_env_args))
        a.horizon_len, a.batch_size = PPO_STOCK['horizon'], PPO_STOCK['batch']
        a.repeat_times, a.learning_rate = PPO_STOCK['repeat'], PPO_STOCK['lr']
        a.net_dims, a.random_seed, a.compute_dtype = STOCK_NET, 0, 'bfloat16'
        return a

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        ctx = build_training(stock_bf16_args())
    assert ctx.fused_rollout and 'use_fused_update: PyTorch path' in text.getvalue()
    step, _ = round_step(ctx)
    stock_l, stock_kind, stock_host = timed_path(
        'main_path_stock_bf16', step, ROUNDS, PPO_STOCK['envs'] * PPO_STOCK['horizon'],
        dict(agent='AgentPPO', env='StockTradingEnv-v2', envs=PPO_STOCK['envs'],
             horizon=PPO_STOCK['horizon'], batch=PPO_STOCK['batch'],
             repeat=PPO_STOCK['repeat'], net_dims=STOCK_NET, compute_dtype='bfloat16'))
    assert stock_kind == ({'StockTradingEnv-v2,bf16': ROUNDS}, {'bf16': ROUNDS}), stock_kind
    assert set(stock_l) == {'fused_rollout', 'critic_values', 'gae_vtrace'}, stock_l
    assert stock_l['gae_vtrace'] == ROUNDS and stock_host == 0, (stock_l, stock_host)
    # one period: the stock env's greedy episodes run 1112 steps
    entry_point(stock_bf16_args(), StockTradingVecEnv, stock_env_args, AgentPPO, STOCK_NET,
                periods=1)

    # ---- main_path_isaac_mock: PPO through make_isaac_env on the mock
    # VecTask with its tensors on the card (ppo_isaac_mock's recipe): the
    # round train_agent runs (ctx.round_fn: the host rollout on the sim
    # through a HostLink, the actor on the card with K11b, then K10, K2)
    spec = EnvSpec('MockVecTask-v0', ISAAC_MOCK['envs'], 40, 2, 2, False)

    def isaac_args():
        env = make_isaac_env(lambda: mock_vectask(ISAAC_MOCK['envs'], dev),
                             env_name='MockVecTask-v0', spec=spec)
        ea = {'env_name': 'MockVecTask-v0', 'num_envs': ISAAC_MOCK['envs'], 'max_step': 40,
              'state_dim': 2, 'action_dim': 2, 'if_discrete': False}
        a = Config(AgentPPO, env, ea)
        a.net_dims, a.horizon_len, a.batch_size = ISAAC_MOCK['net'], 40, ISAAC_MOCK['batch']
        a.repeat_times, a.learning_rate = ISAAC_MOCK['repeat'], ISAAC_MOCK['lr']
        a.reward_scale, a.gamma, a.random_seed = ISAAC_MOCK['reward_scale'], 0.95, 0
        return a, env, ea

    a, env, _ = isaac_args()
    ctx = build_training(a)
    assert ctx.use_host_rollout and not ctx.fused_rollout
    assert ctx.carry.obs.device.type == dev.type   # the sim's tensors stay on the run's device
    step, box = round_step(ctx)
    isaac_l, _, isaac_host = timed_path('main_path_isaac_mock', step, ROUNDS, 64 * 40, dict(
        agent='AgentPPO', env='MockVecTask-v0 (tensors on the card)', **ISAAC_MOCK))
    assert box[0].obs.device.type == dev.type
    assert set(isaac_l) == {'ppo_update', 'gae_vtrace', 'fused_mlp3'}, isaac_l
    assert isaac_l['ppo_update'] == ROUNDS and isaac_l['gae_vtrace'] == ROUNDS, isaac_l
    assert isaac_l['fused_mlp3'] >= 40 * ROUNDS and isaac_host == 40 * ROUNDS, (
        isaac_l, isaac_host)
    a, env, ea = isaac_args()
    entry_point(a, env, ea, AgentPPO, ISAAC_MOCK['net'])

    # ---- main_path_modsac_host: ModSAC through make_host_env on the numpy
    # lander (modsac_lander_host's shape); the pool steps sequentially, on 4
    # threads and on 4 forked processes, and the three give bitwise-equal
    # rollouts from the same weights and noise.  The timed round is the one
    # train_agent runs (ctx.round_fn: the host rollout through a HostLink's
    # pinned buffers, the ModSAC actor on PyTorch ops, as K11b takes only a
    # 3-linear MLP; then the ring, K11a's gathers and the autograd update:
    # no K8 at (256, 256), past the JAX chunk's widths)
    lander_spec = EnvSpec('HostLander-v0', MODSAC_HOST['envs'], 1000, 8, 2, False)

    def lander_args(**pool):
        env = make_host_env(HostLanderEnv, lander_spec, seed=0, **pool)
        ea = {'env_name': 'HostLander-v0', 'num_envs': MODSAC_HOST['envs'], 'max_step': 1000,
              'state_dim': 8, 'action_dim': 2, 'if_discrete': False}
        a = Config(AgentModSAC, env, ea)
        a.net_dims, a.horizon_len = MODSAC_HOST['net'], MODSAC_HOST['horizon']
        a.buffer_size, a.batch_size = MODSAC_HOST['buffer'], MODSAC_HOST['batch']
        a.repeat_times, a.learning_rate = MODSAC_HOST['repeat'], MODSAC_HOST['lr']
        a.reward_scale, a.gamma, a.random_seed = MODSAC_HOST['reward_scale'], 0.99, 0
        return a, env, ea

    a, env, ea = lander_args()
    ctx = build_training(a)
    assert ctx.use_host_rollout
    zs = torch.randn((64, 16, 2), generator=g, device=dev)
    outs = {}
    for kind, pool_kw in (('sequential', {}), ('threads', dict(num_threads=4)),
                          ('processes', dict(num_procs=4))):
        env_k = make_host_env(HostLanderEnv, lander_spec, seed=0, **pool_kw)
        try:
            obs0 = env_k.host_pool.reset_all(16)
            ro, last = host_collect_rollout(env_k.host_pool, ctx.agent, ctx.carry.agent_state,
                                            obs0, None, 64, 0.5, dev, noise=zs)
            outs[kind] = [x.cpu() for x in ro[:6] if x is not None] + [torch.as_tensor(last)]
        finally:
            env_k.host_pool.close()
    assert all(all(torch.equal(x, y) for x, y in zip(outs['sequential'], outs[k]))
               for k in ('threads', 'processes')), 'host pools differ'
    step, _ = round_step(ctx)
    step()    # a first round fills the ring past one batch
    host_l, _, modsac_host = timed_path('main_path_modsac_host', step, ROUNDS, 16 * 64, dict(
        agent='AgentModSAC', env='HostLander-v0 (numpy, gym protocol)',
        pools_bitwise_equal=['sequential', 'threads', 'processes'], **MODSAC_HOST))
    assert set(host_l) == {'buffer_gather'} and host_l['buffer_gather'] >= ROUNDS, host_l
    assert modsac_host == 64 * ROUNDS, modsac_host
    a, env, ea = lander_args()
    entry_point(a, env, ea, AgentModSAC, MODSAC_HOST['net'])
    env.host_pool.close()

    # ---- main_path_pixel: pixelppo_chasing's recipe (the ConvNet and the
    # autograd update on PyTorch ops, as the JAX package runs XLA; K10)
    pixel_args_ = {'env_name': 'PixelChasing-v0', 'num_envs': PIXEL_PPO['envs'],
                   'max_step': 200, 'state_dim': (64, 64, 2), 'action_dim': 2,
                   'if_discrete': False}

    def pixel_args():
        a = Config(AgentPixelPPO, PixelChasingEnv, dict(pixel_args_))
        a.net_dims, a.encoder_dim, a.gamma = PIXEL_PPO['net'], PIXEL_PPO['encoder'], 0.97
        a.horizon_len, a.batch_size = PIXEL_PPO['horizon'], PIXEL_PPO['batch']
        a.repeat_times, a.learning_rate, a.random_seed = PIXEL_PPO['repeat'], PIXEL_PPO['lr'], 0
        return a

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        ctx = build_training(pixel_args())
    said = text.getvalue()
    assert 'use_fused_update: PyTorch path' in said and 'use_conv_kernel: PyTorch path' in said
    step, _ = round_step(ctx)
    pix_l, _, pix_host = timed_path('main_path_pixel', step, ROUNDS,
                                    PIXEL_PPO['envs'] * PIXEL_PPO['horizon'],
                                    dict(agent='AgentPixelPPO', env='PixelChasing-v0',
                                         **PIXEL_PPO))
    # the ConvNet and the update are PyTorch ops (as the JAX package's XLA):
    # K10 is the path's one kernel
    assert pix_l == {'gae_vtrace': ROUNDS} and pix_host == 0, (pix_l, pix_host)
    entry_point(pixel_args(), PixelChasingEnv, pixel_args_, AgentPixelPPO, PIXEL_PPO['net'])

    # ---- the kernels line: K4 bf16 on its main path (ppo_stock's 256 envs),
    # the bf16 critic pass likewise; the other shapes, heads and the float32
    # kernels with bf16 storage ride along as checks
    k = res[('ppo', PPO_STOCK['envs'], True, False)]
    c = crit[(256, STOCK_NET)]
    checks = {r['name']: {f: r[f] for f in ('ms', 'plain_ms', 'bound_ms', 'bound_by',
                                            'max_abs_err', 'cluster')
                          if f in r} | ({'bound_ms_fp32': r['bound_ms_fp32']}
                                        if 'bound_ms_fp32' in r else {})
              for r in res.values()}
    return [
        {'name': 'fused_rollout_bf16[StockTradingEnv-v2,gaussian,256 envs]', 'route': 'cuda',
         'source': src, 'replaces': 'elegantrl_tpu/ops/pallas_rollout.py:600',
         'launches': stock_kind[0]['StockTradingEnv-v2,bf16'], 'max_abs_err': k['max_abs_err'],
         'ms': k['ms'], 'plain_ms': k['plain_ms'], 'bound_ms': k['bound_ms'],
         'bound_by': k['bound_by'], 'bound_ms_fp32': k['bound_ms_fp32'], 'library_ms': None,
         'cluster_ms': k['cluster_ms'], 'checks': checks},
        {'name': c['name'], 'route': 'cuda', 'source': src,
         'replaces': 'elegantrl_tpu/ops/pallas_rollout.py:600',
         'launches': stock_kind[1]['bf16'], 'max_abs_err': c['max_abs_err'], 'ms': c['ms'],
         'plain_ms': c['plain_ms'], 'bound_ms': c['bound_ms'], 'bound_by': c['bound_by'],
         'bound_ms_fp32': c['bound_ms_fp32'], 'library_ms': None,
         'checks': {v['name']: {f: v[f] for f in ('ms', 'plain_ms', 'bound_ms', 'max_abs_err')}
                    for v in crit.values()}},
    ]


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

    # ---- K10: bitwise equal to its plain version (the truncation bootstrap,
    # the recursion and the reward sums: the same f32 operations in the same
    # order, no FMA contraction), the PPO advantage step as the agent calls
    # it, at ppo_lunarlander_cont's 256 x 64, the bench's 64 x 4096, 37 x
    # 1000 (ragged: 32-row stages and 32-column blocks) and bench config 2's
    # 2048 x 4096.  Times: the call (CUDA events, the wrapper's host time
    # included) and the device time (the profiler)
    from elegantrl_tpu_torch.ops import gae as gae_ops
    k10 = {}
    for H, N in ((LUNAR_PPO['horizon'], LUNAR_PPO['envs']), (64, 4096), (37, 1000),
                 (2048, 4096)):
        g = torch.Generator(device=dev).manual_seed(H * N)
        r = torch.randn((H, N), generator=g, device=dev)
        u = (torch.rand((H, N), generator=g, device=dev) > 0.02).float()
        um = (torch.rand((H, N), generator=g, device=dev) > 0.01).float()
        v = torch.randn((H, N), generator=g, device=dev)
        nv = torch.randn(N, generator=g, device=dev)
        fa, fs = kn.gae_vtrace_kernel(r, u, um, v, nv, 0.99, 0.95)
        wa, ws = kn.vtrace_advantages_reference(r, u, um, v, nv, 0.99, 0.95)
        torch.cuda.synchronize()
        err = max(float((fa - wa).abs().max()), float((fs - ws).abs().max()))
        assert torch.equal(fa, wa) and torch.equal(fs, ws), ('K10 differs', H, N, err)

        def k10_call():
            return kn.gae_vtrace_kernel(r, u, um, v, nv, 0.99, 0.95)

        ms = cuda_ms_(k10_call, reps=50, warmup=3)
        device_ms = profiled_ms(torch, k10_call, 20, 'gae_vtrace')
        plain = cuda_ms_(lambda: kn.vtrace_advantages_reference(r, u, um, v, nv, 0.99, 0.95),
                         reps=1 if H > 256 else 5)
        # r, u, unmask, v read and adv, reward_sums written once (24 B a
        # cell), 11 f32 operations a cell; beside it the recursion's own 16 B
        # (r, u, v and adv) and 7 operations, the bound before the fold
        b_ms, b_by = bound(11 * H * N, 4 * (6 * H * N + N))
        b16_ms, _ = bound(7 * H * N, 4 * (4 * H * N + N))
        k10[(H, N)] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                           device_ms=device_ms, bound_ms_16B=b16_ms)
        emit(phase='k10_vs_plain', H=H, N=N, bitwise_equal=True, **k10[(H, N)],
             library_ms=None, tolerance='exact', device=name, nvidia_smi=smi)
    # the PPO advantage step (agents/ppo.py:update) at the bench's 64 x 4096,
    # K10 and the normalisation, bitwise equal to its plain composition
    # (ops/gae.py: apply_truncation_bootstrap, the reverse loop, adv + v,
    # normalize_advantages): its device kernels and ms (the parent's step,
    # the bootstrap's ops, K10 alone and the sum, is timed against it by
    # scripts/torch_compare_chunks.py --only k10)
    H, N = 64, 4096
    g = torch.Generator(device=dev).manual_seed(5)
    r, v = (torch.randn((H, N), generator=g, device=dev) for _ in range(2))
    u = (torch.rand((H, N), generator=g, device=dev) > 0.02).float()
    um = (torch.rand((H, N), generator=g, device=dev) > 0.01).float()
    nv = torch.randn(N, generator=g, device=dev)

    def step_plain():
        rb, ub = gae_ops.apply_truncation_bootstrap(r, u, um, v)
        adv = gae_ops.gae_vtrace(rb, ub, v, nv, 0.99, 0.95)
        return gae_ops.normalize_advantages(adv), adv + v

    def step():
        adv, sums = gae_ops.vtrace_advantages(r, u, um, v, nv, 0.99, 0.95, use_kernel=True)
        return gae_ops.normalize_advantages(adv), sums

    assert all(torch.equal(x, y) for x, y in zip(step(), step_plain())), 'advantage step differs'
    launches_step = len(device_kernels(torch, step, reps=3)) / 3
    step_ms = cuda_ms_(step, reps=50, warmup=3)
    emit(phase='k10_advantage_step', H=H, N=N, bitwise_equal=True,
         device_kernels_a_step=launches_step, ms=step_ms, device=name, nvidia_smi=smi)

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
                 at_64x4096=k10[(64, 4096)], at_37x1000=k10[(37, 1000)],
                 at_2048x4096=k10[(2048, 4096)], advantage_step_kernels=launches_step),
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
    from elegantrl_tpu_torch.ops import probes
    T, R, L = probes.T_DEFAULT, probes.R_DEFAULT, probes.LANES
    results = {}

    def rows_sum(tab, idx):
        return torch.sum(torch.index_select(tab, 0, idx.reshape(-1)[:1])).expand(8, L)

    # one PyTorch expression a probe computing the same function (at most two
    # launches: the row or column read, then the sum or the broadcast copy)
    library = {
        'sublane_dynslice_value': rows_sum, 'sublane_dynslice_ref': rows_sum,
        'scalar_from_vmem': rows_sum,
        'transpose_1xN': lambda x: x.t().expand(x.shape[1], L).contiguous(),
        'dynslice_then_transpose': lambda tab, day: torch.index_select(
            tab, 0, day.reshape(-1)[:1]).t().expand(tab.shape[1], L).contiguous(),
        'lane_dynslice_ref': lambda tab, day: torch.index_select(
            tab, 1, day.reshape(-1)[:1]).expand(tab.shape[0], L).contiguous(),
        'fori_scalar_carry': lambda tab: torch.sum(tab[:probes.STEPS], 0)[:, None].expand(
            tab.shape[1], L).contiguous(),
    }
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
        lib = library[name]
        lib_err = float((lib(*inputs) - got).abs().max())
        assert lib_err <= 1e-4 * float(got.abs().max()), (name, lib_err)
        lib_ms = cuda_ms(torch, lambda: lib(*inputs), reps=50, warmup=3)
        # bytes the function needs: the row(s) it reads, the index, the output
        read = {'transpose_1xN': R, 'fori_scalar_carry': probes.STEPS * R}.get(name, R + 1)
        b_ms, b_by = bound(0, 4 * (read + got.numel()))
        results[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
                             bound_by=b_by, first=got.flatten()[:4].tolist(),
                             random_cases=len(random_cases), library_ms=lib_ms,
                             library_max_abs_diff=lib_err)
        emit(phase='probes_vs_plain', probe=name, out=tuple(got.shape),
             first_values=results[name]['first'], expected_at_script_inputs=True,
             random_inputs=sorted(set(random_cases)), bitwise_equal=True,
             **{k: v for k, v in results[name].items() if k != 'first'},
             tolerance='exact (integer-valued f32)')
    # the probes' entry point, as a user runs it
    script = load_script('scripts', 'torch_probe_ops')
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
             'library_ms': r['library_ms'],
             'main_path': 'scripts/torch_probe_ops.py (no training path)'}
            for name, r in results.items()]


PROBES_SEED = 17


# ------------------------------------------------------------------ parallel

# population_ppo's and population_stock's recipes (scripts/verify_learning.py:398-445)
POP_PPO = dict(members=8, envs=128, net=(64, 64), horizon=200, batch=512, repeat=64.0,
               lr=4e-4, gamma=0.97)
POP_STOCK = dict(members=8, envs=256, net=(128, 128), horizon=128, batch=512, repeat=8.0,
                 lr=2e-4, gamma=0.99)


def parallel_phases(torch, dev, name, smi, bound):
    """The ``parallel/`` phases: the sharded rollouts against their plain
    versions and the single launch (``sharded_rollout_vs_plain``), the main
    path and path A at ``{'dp': 2}`` on one card against dp = 1
    (``main_path_dp2``, ``main_path_td3_dp2``),
    the two population shapes (``main_path_population``), a one-rank NCCL
    group (``distributed_world1``) and ``train_agent`` with ``mesh_axes``,
    ``elastic_restore`` and ``valid_agent`` (``train_agent_mesh``).  Returns
    the sharded wrappers' numbers keyed by the kernels-line entry of the
    kernel they launch."""
    import numpy as np
    import torch.distributed as dist
    from elegantrl_tpu_torch import Config, build_training, train_agent, valid_agent
    from elegantrl_tpu_torch.agents import AgentPPO, AgentTD3
    from elegantrl_tpu_torch.agents.ppo import make_ppo
    from elegantrl_tpu_torch.envs import HopperEnv, PendulumEnv, StockTradingVecEnv
    from elegantrl_tpu_torch.envs.base import vec_reset
    from elegantrl_tpu_torch.ops import fused_rollout as fr, kernels as kn
    from elegantrl_tpu_torch.ops.fused_update import ppo_update
    from elegantrl_tpu_torch.parallel import make_mesh
    from elegantrl_tpu_torch.parallel import population as pop
    from elegantrl_tpu_torch.parallel.distributed import elastic_restore, init_distributed
    from elegantrl_tpu_torch.parallel.mesh import (gather_env_axis, replicate,
                                                   split_env_axis)
    from elegantrl_tpu_torch.utils.checkpoint import tree_leaves

    def gens(seed_, k):
        """``k`` generators on the card in the same state."""
        out = [torch.Generator(device=dev) for _ in range(k)]
        for g_ in out:
            g_.manual_seed(seed_)
        return out

    def least_cluster(fits):
        return next(c for c in fr.ROLLOUT_CLUSTERS if fits(c))

    def ptrs(tree):
        return {t.untyped_storage().data_ptr() for t in tree_leaves(tree)
                if isinstance(t, torch.Tensor) and t.numel()}

    # ---- sharded_rollout_vs_plain.  For each dp: (1) the shards with their
    # folded seeds (fold_seed of one seed from the generator), each shard's
    # launch against its plain version on the same shard and seed, with the
    # tolerances of the single launch's check (K1: whole trajectories within
    # 2e-2, flags equal; K6: at most 1% of lanes, at least one, parted beyond
    # 2e-2; K4: flags, days and market rows equal, at most a quarter of the
    # lanes parted by a lot flip, the others' final rows within 1e-5 of their
    # value, the critic pass within CRITIC_TOL of the plain MLP on the stored
    # states), and two runs bitwise equal; (2) the union with injected noise
    # against the single launch on all envs, both at one cluster size (the
    # least that fits): bitwise equal, every output; (3) ms per rollout at dp
    # = 1 (the single launch), 2 and 4 on the one card.
    sharded = {}

    def report(key, wrapper, replaces, ms, worst, b, extra):
        sharded[key] = dict(wrapper=wrapper, replaces=replaces, ms_by_dp=ms,
                            max_abs_err_per_shard=worst, union_bitwise_single_launch=True,
                            two_runs_bitwise=True, bound_ms=b[0], bound_by=b[1], **extra)
        emit(phase='sharded_rollout_vs_plain', kernel=key, wrapper=wrapper, ms_by_dp=ms,
             max_abs_err_per_shard=worst, union_bitwise_single_launch=True,
             two_runs_bitwise=True, bound_ms=b[0], bound_by=b[1], **extra, device=name,
             nvidia_smi=smi)

    # K1: PPO on Pendulum, the main path's shape
    N, H = NUM_ENVS, HORIZON
    g = torch.Generator(device=dev).manual_seed(61)
    st = make_ppo(NET_DIMS, 3, 1, Config()).init(0, dev)
    st = st._replace(norm_avg=torch.tensor([0.1, -0.2, 0.3], device=dev),
                     norm_std=torch.tensor([0.9, 1.1, 2.0], device=dev))
    with torch.no_grad():
        st.act.std_log.fill_(-0.5)
    env_def = PendulumEnv(num_envs=1)._def
    state, _ = vec_reset(env_def, g, N, dev)
    state = state._replace(t=(torch.arange(N, device=dev, dtype=torch.int32) * 7 % 200))
    nz = torch.cat([torch.randn((H, 1, N), generator=g, device=dev),
                    torch.rand((H, 2, N), generator=g, device=dev)], 1).contiguous()
    body = fr.PENDULUM_BODY
    net = (st.act_flat, st.cri_flat, st.norm_avg, st.norm_std)
    kw = dict(net_dims=NET_DIMS, horizon_len=H, reward_scale=1.0)
    c1 = least_cluster(lambda c: fr.rollout_smem_bytes(body, NET_DIMS, c) <= fr.SMEM_LIMIT)
    D1, D2 = NET_DIMS
    n_params = st.act_flat.numel() + st.cri_flat.numel()
    k1_bound = bound(2 * (2 * (3 * D1 + D1 * D2) + D2 * 2) * N * H,
                     4 * (n_params + 3 * N + 2 + 6 + N * H * (3 + 1 + 5) + 3 * N))
    f_all, i_all = body.pack(state)
    f_all, i_all = f_all.contiguous(), i_all.contiguous()
    fixed = torch.tensor([5, 6], dtype=torch.int32, device=dev)
    k1_launch = cuda_ms(torch, lambda: fr.rollout(*net, f_all, i_all, seed=fixed, **kw),
                        reps=20, warmup=2)
    k1_ms, k1_worst = {}, 0.0
    for dp in (1, 2, 4):
        mesh = make_mesh({'dp': dp}, devices=[dev] * dp)
        fn = fr.make_sharded_fused_rollout(body, NET_DIMS, H, N, 1.0, mesh)
        shards = split_env_axis(mesh, state)
        ga, gb, gc = gens(9, 3)
        if dp == 1:     # the wrapper's own cost: one shard
            k1_ms[dp] = cuda_ms(torch, lambda: fn(st, shards, ga), reps=20, warmup=2)
            continue
        ro, env2, last = fn(st, shards, ga)
        ro2, _, _ = fn(st, shards, gb)
        seed0 = torch.randint(-2 ** 31, 2 ** 31 - 1, (2,), generator=gc, device=dev,
                              dtype=torch.int32)
        torch.cuda.synchronize()
        assert all(torch.equal(getattr(ro, f), getattr(ro2, f))
                   for f in ('states', 'actions', 'logprobs', 'rewards', 'undones', 'unmasks'))
        n = N // dp
        for r in range(dp):
            f, i = body.pack(shards[r])
            want = fr.rollout_reference(*net, f, i, seed=fr.fold_seed(seed0, r), **kw)
            cols = slice(r * n, (r + 1) * n)
            got = dict(states=ro.states[..., cols], actions=ro.actions[..., cols],
                       logprobs=ro.logprobs[:, cols], rewards=ro.rewards[:, cols],
                       values=ro.extras['values'][:, cols])
            assert torch.equal(1.0 - ro.unmasks[:, cols], want.truncates), ('K1 flags', dp, r)
            d = max(float((v - getattr(want, k)).abs().max()) for k, v in got.items())
            assert math.isfinite(d) and d <= 2e-2, ('K1 shard', dp, r, d)
            k1_worst = max(k1_worst, d)
        union, _, _ = fn(st, shards, None, noise=nz, cluster=c1)
        single = fr.rollout(*net, f_all, i_all, noise=nz, cluster=c1, **kw)
        torch.cuda.synchronize()
        assert (torch.equal(union.states, single.states)
                and torch.equal(union.actions, single.actions)
                and torch.equal(union.logprobs, single.logprobs)
                and torch.equal(union.rewards, single.rewards)
                and torch.equal(union.extras['values'], single.values)
                and torch.equal(1.0 - union.undones, single.terminals)
                and torch.equal(1.0 - union.unmasks, single.truncates)), ('K1 union', dp)
        k1_ms[dp] = cuda_ms(torch, lambda: fn(st, shards, ga), reps=20, warmup=2)
    report('fused_rollout', 'make_sharded_fused_rollout',
           'elegantrl_tpu/ops/pallas_rollout.py:908', k1_ms, k1_worst, k1_bound,
           dict(envs=N, horizon=H, cluster_forced=c1, single_launch_ms=k1_launch,
                tolerance={'trajectory': 2e-2, 'union': 'bitwise'}))

    # K6: TD3 on HopperSlip, path A's shape (1024 envs, H 32), dp = 2 and 4
    N6, H6 = PATH_A['envs'], PATH_A['horizon']
    body6 = fr.HOPPER_BODY
    targs = Config(AgentTD3)
    targs.net_dims = OFF_NET
    td3 = AgentTD3.make(OFF_NET, 6, 2, targs).init(7, dev)
    hop = HopperEnv(num_envs=1)._def
    state6, _ = vec_reset(hop, g, N6, dev)
    nz6 = torch.cat([torch.randn((H6, 2, N6), generator=g, device=dev),
                     torch.rand((H6, fr.offpolicy_noise_rows(body6, 'ddpg') - 2, N6),
                                generator=g, device=dev)], 1).contiguous()
    okw = dict(body=body6, head='ddpg', net_dims=OFF_NET, horizon_len=H6, reward_scale=1.0,
               noise_std=0.1, explore_rate=0.25)
    c6 = least_cluster(lambda c: fr.offpolicy_smem_bytes(body6, OFF_NET, 'ddpg', c)
                       <= fr.SMEM_LIMIT)
    f6, i6 = body6.pack(state6)
    f6, i6 = f6.contiguous(), i6.contiguous()
    D1o, D2o = OFF_NET
    k6_bound = bound(2 * (6 * D1o + D1o * D2o + D2o * 2) * N6 * H6,
                     4 * (td3.act.numel() + 2 * (body6.n_f32 + body6.n_i32) * N6
                          + N6 * H6 * (6 + 2 + 3)))
    k6_launch = cuda_ms(torch, lambda: fr.offpolicy_rollout(td3.act, f6, i6, seed=fixed, **okw),
                        reps=20, warmup=2)
    k6_ms, k6_worst, k6_parted = {}, 0.0, 0
    for dp in (1, 2, 4):
        mesh = make_mesh({'dp': dp}, devices=[dev] * dp)
        fn = fr.make_sharded_offpolicy_rollout(body6, 'ddpg', OFF_NET, H6, N6, 1.0, mesh,
                                               noise_std=0.1, explore_rate=0.25)
        shards = split_env_axis(mesh, state6)
        ga, gb, gc = gens(11, 3)
        if dp == 1:
            k6_ms[dp] = cuda_ms(torch, lambda: fn(td3, shards, ga), reps=20, warmup=2)
            continue
        ro, _, _ = fn(td3, shards, ga)
        ro2, _, _ = fn(td3, shards, gb)
        seed0 = torch.randint(-2 ** 31, 2 ** 31 - 1, (2,), generator=gc, device=dev,
                              dtype=torch.int32)
        torch.cuda.synchronize()
        assert all(torch.equal(getattr(ro, f), getattr(ro2, f))
                   for f in ('states', 'actions', 'rewards', 'undones', 'unmasks'))
        n = N6 // dp
        for r in range(dp):
            f, i = body6.pack(shards[r])
            want = fr.offpolicy_rollout_reference(td3.act, f, i, seed=fr.fold_seed(seed0, r),
                                                  **okw)
            cols = slice(r * n, (r + 1) * n)
            lane = torch.stack([(ro.states[:, cols] - want.states).abs().amax((0, 2)),
                                (ro.actions[:, cols] - want.actions).abs().amax((0, 2)),
                                (ro.rewards[:, cols] - want.rewards).abs().amax(0)]).amax(0)
            flags = (((1.0 - ro.undones[:, cols]) != want.terminals)
                     | ((1.0 - ro.unmasks[:, cols]) != want.truncates)).any(0)
            parted = (lane > 2e-2) | flags
            assert int(parted.sum()) <= max(1, int(0.01 * n)), ('K6 shard', dp, r)
            k6_parted += int(parted.sum())
            k6_worst = max(k6_worst, float(lane[~parted].max()))
        union, _, _ = fn(td3, shards, None, noise=nz6, cluster=c6)
        single = fr.offpolicy_rollout(td3.act, f6, i6, noise=nz6, cluster=c6, **okw)
        torch.cuda.synchronize()
        assert (torch.equal(union.states, single.states)
                and torch.equal(union.actions, single.actions)
                and torch.equal(union.rewards, single.rewards)
                and torch.equal(1.0 - union.undones, single.terminals)
                and torch.equal(1.0 - union.unmasks, single.truncates)), ('K6 union', dp)
        k6_ms[dp] = cuda_ms(torch, lambda: fn(td3, shards, ga), reps=20, warmup=2)
    report('fused_rollout[HopperSlip-v0,ddpg]', 'make_sharded_offpolicy_rollout',
           'elegantrl_tpu/ops/pallas_rollout.py:1308', k6_ms, k6_worst, k6_bound,
           dict(envs=N6, horizon=H6, cluster_forced=c6, lanes_parted=k6_parted,
                single_launch_ms=k6_launch,
                tolerance={'trajectory': 2e-2, 'lanes_parted': '1% (at least 1) a shard',
                           'union': 'bitwise'}))

    # K4 with its critic pass: ppo_stock's 256 envs x 128 steps from day T -
    # 61 (every lane ends its episode and resets), dp = 2 (128 a shard) and 4
    stock_def = StockTradingVecEnv(num_envs=1)._def
    sbody = stock_def.kernel_body
    S4, A4 = sbody.state_dim, sbody.action_dim
    T = sbody.tables.close.shape[0]
    N4, H4 = PPO_STOCK['envs'], PPO_STOCK['horizon']
    sst = make_ppo(STOCK_NET, S4, A4, Config()).init(0, dev)
    sst = sst._replace(norm_avg=torch.rand(S4, generator=g, device=dev) * 0.4 - 0.2,
                       norm_std=torch.rand(S4, generator=g, device=dev) + 0.7)
    with torch.no_grad():
        sst.act.std_log.fill_(-0.5)
    f4, _ = sbody.pack(stock_def.init(g, N4, dev))
    i4 = torch.full((1, N4), T - 61, dtype=torch.int32, device=dev)
    state4 = sbody.unpack(f4, i4)
    f4, i4 = f4.contiguous(), i4.contiguous()
    nz4 = torch.cat([torch.randn((H4, A4, N4), generator=g, device=dev),
                     torch.rand((H4, sbody.n_reset, N4), generator=g, device=dev)],
                    1).contiguous()
    snet = (sst.act_flat, sst.cri_flat, sst.norm_avg, sst.norm_std)
    skw = dict(net_dims=STOCK_NET, horizon_len=H4, reward_scale=2.0 ** -8, body=sbody)
    c4 = least_cluster(lambda c: fr._library().stock_rollout_smem_bytes(*STOCK_NET, c, 0)
                       <= fr.SMEM_LIMIT)
    D1s, D2s = STOCK_NET
    L, M = 1 + A4, S4 - 1 - A4
    k4_bound = bound(2 * (L * D1s + D1s * D2s + D2s * A4) * N4 * H4 + 2 * M * D1s * H4
                     + 2 * (L * D1s + D1s * D2s + D2s) * N4 * H4 + 2 * M * D1s * H4,
                     4 * (sst.act_flat.numel() + sst.cri_flat.numel() + 2 * S4
                          + 2 * (sbody.n_f32 + sbody.n_i32) * N4 + H4 * M
                          + N4 * H4 * (S4 + A4 + 5)))
    k4_launch = cuda_ms(torch, lambda: fr.rollout(*snet, f4, i4, seed=fixed, **skw), reps=10,
                        warmup=2)
    k4_ms, k4_worst, k4_parted, k4_critic = {}, 0.0, 0, 0.0
    for dp in (1, 2, 4):
        mesh = make_mesh({'dp': dp}, devices=[dev] * dp)
        fn = fr.make_sharded_fused_rollout(sbody, STOCK_NET, H4, N4, 2.0 ** -8, mesh)
        shards = split_env_axis(mesh, state4)
        ga, gb, gc = gens(13, 3)
        if dp == 1:
            k4_ms[dp] = cuda_ms(torch, lambda: fn(sst, shards, ga), reps=10, warmup=2)
            continue
        ro, env2, _ = fn(sst, shards, ga)
        ro2, _, _ = fn(sst, shards, gb)
        seed0 = torch.randint(-2 ** 31, 2 ** 31 - 1, (2,), generator=gc, device=dev,
                              dtype=torch.int32)
        torch.cuda.synchronize()
        assert all(torch.equal(getattr(ro, f), getattr(ro2, f))
                   for f in ('states', 'actions', 'logprobs', 'rewards', 'undones', 'unmasks'))
        assert torch.equal(ro.extras['values'], ro2.extras['values'])
        n = N4 // dp
        for r in range(dp):
            f, i = sbody.pack(shards[r])
            want = fr.rollout_reference(*snet, f.contiguous(), i.contiguous(),
                                        seed=fr.fold_seed(seed0, r), **skw)
            cols = slice(r * n, (r + 1) * n)
            gs, ga_ = ro.states[..., cols], ro.actions[..., cols]
            assert torch.equal(1.0 - ro.undones[:, cols], want.terminals), ('K4 flags', dp, r)
            assert torch.equal(gs[:, 1 + A4:], want.states[:, 1 + A4:]), ('market rows', dp, r)
            lots = ((gs[:, 1:1 + A4] - want.states[:, 1:1 + A4]).abs() > 1e-6).any(1)
            outs = torch.maximum((ga_ - want.actions).abs().amax(1),
                                 (ro.logprobs[:, cols] - want.logprobs).abs()) > 2e-2
            parted = (lots | outs).any(0)
            assert float(parted.float().mean()) <= 0.25, ('K4 shard', dp, r)
            k4_parted += int(parted.sum())
            kept = ~parted
            if bool(kept.any()):
                out_f = sbody.pack(env2[r])[0]
                rel = ((out_f - want.env_f).abs() / want.env_f.abs().clamp_min(1.0))[:, kept]
                assert float(rel.max()) <= 1e-5, ('K4 final rows', dp, r, float(rel.max()))
                k4_worst = max(k4_worst, float((ga_ - want.actions).abs().amax(1)[:, kept].max()))
            v_ref = fr.critic_values_reference(sst.cri_flat, sst.norm_avg, sst.norm_std, gs,
                                               net_dims=STOCK_NET)
            err = float((ro.extras['values'][:, cols] - v_ref).abs().max())
            assert err <= CRITIC_TOL, ('K4 critic pass', dp, r, err)
            k4_critic = max(k4_critic, err)
        union, _, _ = fn(sst, shards, None, noise=nz4, stock_cluster=c4)
        single = fr.rollout(*snet, f4, i4, noise=nz4, stock_cluster=c4, **skw)
        torch.cuda.synchronize()
        assert (torch.equal(union.states, single.states)
                and torch.equal(union.actions, single.actions)
                and torch.equal(union.logprobs, single.logprobs)
                and torch.equal(union.rewards, single.rewards)
                and torch.equal(union.extras['values'], single.values)
                and torch.equal(1.0 - union.undones, single.terminals)), ('K4 union', dp)
        k4_ms[dp] = cuda_ms(torch, lambda: fn(sst, shards, ga), reps=10, warmup=2)
    report(f'fused_rollout[StockTradingEnv-v2,gaussian,{N4} envs]',
           'make_sharded_fused_rollout', 'elegantrl_tpu/ops/pallas_rollout.py:908', k4_ms,
           k4_worst, k4_bound,
           dict(envs=N4, horizon=H4, stock_cluster_forced=c4, lanes_parted=k4_parted,
                single_launch_ms=k4_launch,
                critic_max_abs_err=k4_critic,
                tolerance={'lanes_parted': 'a quarter a shard', 'final_rows_rel': 1e-5,
                           'critic': CRITIC_TOL, 'union': 'bitwise'}))

    # ---- main_path_dp2: the main path (PPO on Pendulum, 4096 envs, H 64, B
    # 512, repeat 8) at {'dp': 2}, both shards on the one card, against dp =
    # 1 in the same call, without a mesh and on a mesh of one shard ({'dp':
    # 1}, what train_agent's {'dp': -1} makes on one card); 10 rounds each
    # after a warm-up round, the counts reset just before them and read just
    # after; the two dp = 1 paths timed again after dp = 2
    pend_args = {'env_name': 'Pendulum-v1', 'num_envs': N, 'max_step': 200, 'state_dim': 3,
                 'action_dim': 1, 'if_discrete': False}

    def ppo_pendulum():
        a = Config(AgentPPO, PendulumEnv, dict(pend_args))
        a.net_dims, a.horizon_len, a.batch_size, a.repeat_times = NET_DIMS, H, BATCH, REPEAT
        a.random_seed = 0
        return a

    counters = dict(fused_rollout=fr.rollout, critic_values=fr.critic_values,
                    ppo_update=ppo_update, gae_vtrace=kn.gae_vtrace_kernel,
                    fused_mlp3=kn.fused_mlp3)

    def reset_counts():
        for fn_ in counters.values():
            fn_.launches = 0
        fr.rollout.launches_by_body.clear()

    def read_counts():
        return {k: fn_.launches for k, fn_ in counters.items() if fn_.launches}

    def timed(step, rounds):
        step()                                                    # warm-up
        torch.cuda.synchronize()
        reset_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(rounds):
            step()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / rounds, read_counts()

    dp_paths = {}
    for key in (1, '1_mesh', 2, 1, '1_mesh'):
        dp = 2 if key == 2 else 1
        mesh = (None if key == 1 else
                make_mesh({'dp': dp}, devices=[dev] * dp))
        ctx = build_training(ppo_pendulum(), mesh=mesh)
        assert ctx.fused_rollout
        box = [ctx.carry]

        def step():
            box[0], m = ctx.round_fn(box[0])
            assert all(math.isfinite(float(v)) for v in m.values() if v.dim() == 0), m

        round_ms, launches = timed(step, ROUNDS)
        host_ms, busy_ms, idle, events = profiled_rounds(torch, step, 3)
        want = {'fused_rollout': dp * ROUNDS, 'gae_vtrace': ROUNDS, 'ppo_update': ROUNDS,
                'fused_mlp3': ROUNDS}
        assert launches == want, (key, launches)
        replicas = 'one state'
        if mesh is not None:
            s_ = box[0].agent_state
            lead = (s_.act_flat, s_.cri_flat, s_.norm_avg, s_.norm_std)
            reps = replicate(mesh, lead)
            assert all(all(torch.equal(a, b) for a, b in zip(rep, lead)) for rep in reps)
            replicas = ('bitwise equal; the shards share the card, so they share the lead '
                        'tensors' if all(a is b for rep in reps for a, b in zip(rep, lead))
                        else 'bitwise equal')
        if key in dp_paths:
            dp_paths[key]['round_ms_again'] = round_ms
            continue
        dp_paths[key] = dict(round_ms=round_ms, env_steps_per_s=N * H / (round_ms / 1e3),
                             launches=launches, replicas=replicas,
                             profiled=dict(round_ms=host_ms, device_busy_ms=busy_ms,
                                           idle_share=idle, device_events_per_round=events))
    emit(phase='main_path_dp2', envs=N, horizon=H, batch=BATCH, repeat=REPEAT,
         net_dims=NET_DIMS, rounds=ROUNDS, dp2=dp_paths[2], dp1=dp_paths[1],
         dp1_mesh=dp_paths['1_mesh'],
         launches_asserted='K1 2, K10 1, K2 1, K11b 1 (the bootstrap value) a round at dp 2',
         device=name, nvidia_smi=smi)
    sharded['fused_rollout']['main_path_dp2'] = dp_paths

    # ---- main_path_td3_dp2: path A (TD3 on HopperSlip, 1024 envs, H 32, ring
    # 4000 rows, B 1024, repeat 4: 15 updates, one K7 chunk) at {'dp': 2}
    # against dp = 1 in the same call; the ring filled first by kernel
    # rollouts of the union inserted without updates, then 10 timed rounds:
    # two K6 launches a round, K7 and K11a on the union
    from elegantrl_tpu_torch.ops import fused_offpolicy_update as fo
    td3_paths = {}
    for dp in (1, 2):
        a = Config(AgentTD3, HopperEnv, {'env_name': 'HopperSlip-v0', 'num_envs': N6,
                                         'max_step': 1000, 'state_dim': 6, 'action_dim': 2,
                                         'if_discrete': False})
        a.horizon_len, a.batch_size, a.repeat_times = H6, PATH_A['batch'], PATH_A['repeat']
        a.buffer_size, a.learning_rate, a.net_dims = PATH_A['buffer'], PATH_A['lr'], OFF_NET
        a.random_seed, a.gamma = 0, 0.99
        mesh = None if dp == 1 else make_mesh({'dp': 2}, devices=[dev, dev])
        ctx = build_training(a, mesh=mesh)
        assert ctx.fused_rollout
        carry = ctx.carry
        f, i = body6.pack(carry.env_state if mesh is None else gather_env_axis(carry.env_state))
        f, i, buf = f.contiguous(), i.contiguous(), carry.buf_state
        while buf.size < ctx.rb.max_size:
            s_ = torch.randint(-2 ** 31, 2 ** 31 - 1, (2,), generator=carry.gen, device=dev,
                               dtype=torch.int32)
            out = fr.offpolicy_rollout(carry.agent_state.act, f, i, body=body6, head='ddpg',
                                       net_dims=OFF_NET, horizon_len=H6, reward_scale=1.0,
                                       noise_std=0.05, explore_rate=0.25, seed=s_)
            buf = ctx.rb.update(buf, (out.states, out.actions, out.rewards,
                                      1.0 - out.terminals, 1.0 - out.truncates))
            f, i = out.env_f, out.env_i
        env_u, obs_u = body6.unpack(f, i), body6.obs(f, i).T
        carry = carry._replace(buf_state=buf, env_state=env_u if mesh is None else
                               split_env_axis(mesh, env_u),
                               obs=obs_u if mesh is None else split_env_axis(mesh, obs_u))
        box = [carry]

        def step():
            box[0], m = ctx.round_fn(box[0])
            assert all(math.isfinite(float(v)) for v in m.values() if v.dim() == 0), m

        step()                                                     # warm-up
        torch.cuda.synchronize()
        for fn_ in (fr.offpolicy_rollout, fo.ddpg_chunk, kn.buffer_gather_fields):
            fn_.launches = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ROUNDS):
            step()
        end.record()
        torch.cuda.synchronize()
        launches = {'offpolicy_rollout': fr.offpolicy_rollout.launches,
                    'ddpg_update': fo.ddpg_chunk.launches,
                    'buffer_gather_fields': kn.buffer_gather_fields.launches}
        assert launches == {'offpolicy_rollout': dp * ROUNDS, 'ddpg_update': ROUNDS,
                            'buffer_gather_fields': ROUNDS}, (dp, launches)
        round_ms = start.elapsed_time(end) / ROUNDS
        td3_paths[dp] = dict(round_ms=round_ms, env_steps_per_s=N6 * H6 / (round_ms / 1e3),
                             launches=launches, ring_rows=box[0].buf_state.size)
    emit(phase='main_path_td3_dp2', envs=N6, horizon=H6, ring_rows=PATH_A['buffer'],
         batch=PATH_A['batch'], repeat=PATH_A['repeat'], net_dims=OFF_NET, rounds=ROUNDS,
         dp2=td3_paths[2], dp1=td3_paths[1],
         launches_asserted='K6 2, K7 1, K11a 1 a round at dp 2', device=name, nvidia_smi=smi)
    sharded['fused_rollout[HopperSlip-v0,ddpg]']['main_path_td3_dp2'] = td3_paths

    # ---- main_path_population: population_ppo's and population_stock's
    # shapes at full width, 8 members; the member rounds timed through
    # ctx.round_fn (2 a member), then train_agent_population for two
    # generations of one round (evaluation, selection, the copies trained),
    # its launches per member round asserted; every member's agent state
    # (parameters, Adam moments) its own after selection, and a copy trained
    # leaves its source bitwise as it was
    pops = {}
    stock_env_args = {'env_name': 'StockTradingEnv-v2', 'num_envs': POP_STOCK['envs'],
                      'max_step': T - 1, 'state_dim': S4, 'action_dim': A4,
                      'if_discrete': False}
    for label, recipe, env_class, env_args, kernel in (
            ('population_ppo', POP_PPO, PendulumEnv, dict(pend_args, num_envs=POP_PPO['envs']),
             'Pendulum-v1'),
            ('population_stock', POP_STOCK, StockTradingVecEnv, stock_env_args,
             'StockTradingEnv-v2')):
        def pop_args():
            a = Config(AgentPPO, env_class, dict(env_args))
            a.net_dims, a.horizon_len, a.batch_size = recipe['net'], recipe['horizon'], \
                recipe['batch']
            a.repeat_times, a.learning_rate, a.gamma = recipe['repeat'], recipe['lr'], \
                recipe['gamma']
            a.random_seed = 0
            return a

        P = recipe['members']
        args = pop_args()
        ctx = build_training(args)
        assert ctx.fused_rollout
        carries = [pop.member_carry(ctx, args, m, dev) for m in range(P)]
        carries = pop.train_members(ctx, carries, 1)                 # warm-up
        torch.cuda.synchronize()
        reset_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        carries = pop.train_members(ctx, carries, 2)
        end.record()
        torch.cuda.synchronize()
        member_round_ms = start.elapsed_time(end) / (2 * P)
        per_round = {k: v / (2 * P) for k, v in read_counts().items()}
        want = {'fused_rollout': 1.0, 'gae_vtrace': 1.0, 'ppo_update': 1.0, 'fused_mlp3': 1.0}
        if kernel == 'StockTradingEnv-v2':
            want['critic_values'] = 1.0
        assert per_round == want, (label, per_round)
        # a copy shares nothing with its source; training it leaves the source as it was
        src = carries[0]
        before = [np.array(x) for x in tree_leaves(ctx.agent.state_to_numpy(src.agent_state))]
        copy = pop.clone_member(ctx, src, 7919, dev)
        assert not ptrs(copy) & ptrs(src) and not ptrs(copy.agent_state) & ptrs(src.agent_state)
        pop.train_members(ctx, [copy], 1)
        assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(
            before, tree_leaves(ctx.agent.state_to_numpy(src.agent_state))))
        # the entry point: 2 generations of 1 round, evaluation and selection
        # between; depth cut on the stock env to 4 members (an evaluation plays
        # the whole 1112-day episode, ~7 s a member on the card)
        Pe = P if kernel == 'Pendulum-v1' else P // 2
        reset_counts()
        t0 = time.time()
        out = pop.train_agent_population(pop_args(), population_size=Pe, generations=2,
                                         rounds_per_generation=1, eval_episodes=8)
        seconds = time.time() - t0
        launches = read_counts()
        assert all(launches.get(k, 0) == 2 * Pe for k in ('fused_rollout', 'gae_vtrace',
                                                           'ppo_update')), (label, launches)
        assert out['history'].shape == (2, Pe) and np.isfinite(out['history']).all()
        owned = [ptrs(c.agent_state) for c in out['carry']]
        assert all(not owned[a] & owned[b] for a in range(Pe) for b in range(a + 1, Pe)), label
        reduced = ([] if Pe == P else
                   [f'entry-point pass at {Pe} members, not the recipe\'s {P}: each '
                    'evaluation plays the whole 1112-day episode (the member-round timing '
                    f'above runs all {P})'])
        pops[label] = dict(member_round_ms=member_round_ms, launches_per_member_round=per_round,
                           entry_point_members=Pe, entry_point_launches=launches,
                           entry_point_seconds=seconds, history=out['history'].tolist(),
                           reduced=reduced)
        emit(phase='main_path_population', path=label, members=P, envs=recipe['envs'],
             horizon=recipe['horizon'], batch=recipe['batch'], repeat=recipe['repeat'],
             net_dims=recipe['net'], member_round_ms=member_round_ms,
             env_steps_per_s=recipe['envs'] * recipe['horizon'] / (member_round_ms / 1e3),
             launches_per_member_round=per_round, entry_point_members=Pe,
             reduced=reduced, entry_point_launches=launches,
             entry_point_seconds=round(seconds, 3), history=out['history'].tolist(),
             copies_share_no_storage=True, source_unchanged_after_copy_trains=True,
             device=name, nvidia_smi=smi)

    # ---- distributed_world1: a one-rank NCCL group (a rendezvous file), one
    # dp round whose gathers run through it (all_gather, the broadcast)
    with tempfile.TemporaryDirectory() as tmp:
        count = init_distributed('file://' + os.path.join(tmp, 'rendezvous'), 1, 0,
                                 backend='nccl')
        try:
            mesh = make_mesh({'dp': 1})
            assert mesh.distributed and mesh.size == 1 and dist.get_backend() == 'nccl'
            ctx = build_training(ppo_pendulum(), mesh=mesh)
            box = [ctx.carry]

            def step():
                box[0], m = ctx.round_fn(box[0])
                assert all(math.isfinite(float(v)) for v in m.values() if v.dim() == 0), m

            round_ms, launches = timed(step, 3)
            prof = profiled_rounds(torch, step, 3)
            obs = gather_env_axis(box[0].obs)
            assert obs.shape == (N, 3) and bool(torch.isfinite(obs).all())
        finally:
            dist.destroy_process_group()
    emit(phase='distributed_world1', backend='nccl', device_count=count, rounds=3,
         round_ms=round_ms, launches=launches,
         profiled=dict(zip(('round_ms', 'device_busy_ms', 'idle_share',
                            'device_events_per_round'), prof)), device=name, nvidia_smi=smi)

    # ---- train_agent_mesh: train_agent with {'dp': -1} (every card: one
    # here), elastic_restore of its train_carry.npz onto {'dp': 2} on the
    # card, one round, and valid_agent on the saved agent; the same
    # train_agent without a mesh timed beside it (host clock, set-up and
    # evaluation included)
    def no_mesh_seconds():
        with tempfile.TemporaryDirectory() as cwd0:
            a_ = ppo_pendulum()
            a_.cwd, a_.eval_times = cwd0, 2
            a_.eval_per_step = a_.break_step = N * H
            t_ = time.time()
            train_agent(a_)
            return round(time.time() - t_, 3)

    seconds_no_mesh = [no_mesh_seconds()]        # before the mesh's run, and after it
    with tempfile.TemporaryDirectory() as cwd:
        a = ppo_pendulum()
        a.mesh_axes, a.cwd, a.eval_times = {'dp': -1}, cwd, 2
        a.eval_per_step = a.break_step = N * H
        t0 = time.time()
        res = train_agent(a)
        seconds = time.time() - t0
        seconds_no_mesh.append(no_mesh_seconds())
        assert res['recorder'].shape[0] == 2 and np.isfinite(res['recorder']).all()
        mesh2 = make_mesh({'dp': 2}, devices=[dev, dev])
        ctx2 = build_training(ppo_pendulum(), mesh=mesh2)
        restored, _ = elastic_restore(os.path.join(cwd, 'train_carry.npz'), ctx2, {'dp': 2},
                                      devices=[dev, dev])
        assert all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(
            tree_leaves(ctx2.agent.state_to_numpy(restored.agent_state)),
            tree_leaves(ctx2.agent.state_to_numpy(res['agent_state']))))
        out, m = ctx2.round_fn(restored)
        assert bool(torch.isfinite(gather_env_axis(out.obs)).all())
        assert math.isfinite(float(m['obj_critic']))
        played = valid_agent(PendulumEnv, pend_args, NET_DIMS, AgentPPO,
                             os.path.join(cwd, 'agent.npz'), render_times=2)
        assert len(played) == 2 and all(math.isfinite(x) for x, _ in played), played
    emit(phase='train_agent_mesh', mesh_axes={'dp': -1}, evaluations=2,
         total_step=int(res['total_step']), max_r=float(res['max_r']),
         seconds=round(seconds, 3), seconds_no_mesh=seconds_no_mesh,
         restored_onto={'dp': 2}, restored_round_finite=True,
         valid_agent=played, device=name, nvidia_smi=smi)
    sharded['fused_rollout']['population'] = pops['population_ppo']
    sharded[f'fused_rollout[StockTradingEnv-v2,gaussian,{N4} envs]']['population'] = (
        pops['population_stock'])
    return sharded


# ------------------------------------------------------------------ marl/
# The multi-agent trainers at their learning recipes' sizes
# (scripts/verify_learning.py:342-395): TeamChasing with 2 agents in 2
# dimensions.  The JAX package runs no Pallas kernel here; the port runs
# PyTorch ops on the card.
MARL_ROUNDS = 3


def marl_phases(torch, dev, name, smi):
    """Each multi-agent trainer: a few rounds through its ``make_*`` on the
    card, timed (ms a round), every metric finite and every tensor of its
    state on the card; then its ``train_*`` entry point for two rounds, each
    evaluated."""
    from elegantrl_tpu_torch import marl
    from elegantrl_tpu_torch.utils.checkpoint import tree_leaves

    def on_card(*trees):
        leaves = [x for tree in trees for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]
        return bool(leaves) and all(x.device.type == 'cuda' for x in leaves)

    env, denv = marl.make_team_chasing(2, 2), marl.make_team_chasing_discrete(2, 2)
    hid = 64
    runs = {
        'mappo': (env, lambda: marl.make_mappo(env, device=dev), 64, 64),
        'maddpg': (env, lambda: marl.make_maddpg(env, num_envs=64, device=dev), 64, 64),
        'qmix': (denv, lambda: marl.make_qmix(denv, mixer='qmix', device=dev), 32, 64),
        'vdn': (denv, lambda: marl.make_qmix(denv, mixer='vdn', device=dev), 32, 64),
        'mappo_rnn': (env, lambda: marl.make_mappo_rnn(env, hid=hid, device=dev), 64, 64),
        'qmix_rnn': (denv, lambda: marl.make_qmix_rnn(denv, hid=hid, device=dev), 32, 64),
    }
    for trainer, (e, make, n, h) in runs.items():
        gen = torch.Generator(device=dev).manual_seed(0)
        parts = make()
        state = parts[0](torch.Generator().manual_seed(0))
        if trainer in ('qmix', 'vdn'):
            carry = (e.init(gen, n, dev), parts[1](n))
            step = lambda s, c: (lambda o: (o[0], (o[1], o[2]), o[3]))(  # noqa: E731
                parts[2](s, c[0], c[1], gen, n, h))
        elif trainer == 'qmix_rnn':
            carry = (e.init(gen, n, dev), torch.zeros((n, e.num_agents, hid), device=dev),
                     parts[1](n, h))
            step = lambda s, c: (lambda o: (o[0], (o[1], o[2], o[3]), o[4]))(  # noqa: E731
                parts[2](s, c[0], c[1], c[2], gen, n, h))
        elif trainer == 'maddpg':
            carry = ()
            step = lambda s, c: (lambda o: (o[0], (), o[1]))(parts[1](s, gen))  # noqa: E731
        elif trainer == 'mappo_rnn':
            carry = (e.init(gen, n, dev), (torch.zeros((n, e.num_agents, hid), device=dev),
                                           torch.zeros((n, hid), device=dev)))
            step = lambda s, c: (lambda o: (o[0], (o[1], o[2]), o[3]))(  # noqa: E731
                parts[1](s, c[0], c[1], gen, n, h, 16, 4))
        else:
            carry = (e.init(gen, n, dev),)
            step = lambda s, c: (lambda o: (o[0], (o[1],), o[2]))(  # noqa: E731
                parts[1](s, c[0], gen, n, h, 512, 4))
        state, carry, metric = step(state, carry)               # warm-up round
        torch.cuda.synchronize()
        t0 = time.time()
        metrics = []
        for _ in range(MARL_ROUNDS):
            state, carry, metric = step(state, carry)
            metrics.append(float(metric))
        torch.cuda.synchronize()
        round_ms = (time.time() - t0) * 1e3 / MARL_ROUNDS
        assert all(math.isfinite(m) for m in metrics), (trainer, metrics)
        assert on_card(state, carry), trainer
        score = float(parts[-2 if trainer in ('mappo',) else -1](
            state, torch.Generator(device=dev).manual_seed(1)))
        assert math.isfinite(score), (trainer, score)
        # the entry point, two rounds, each evaluated
        kw = {'mappo': dict(num_envs=n, horizon=h, batch_size=512, repeat_times=4),
              'maddpg': dict(num_envs=n), 'qmix': dict(num_envs=n, horizon=h, mixer='qmix'),
              'vdn': dict(num_envs=n, horizon=h, mixer='vdn'),
              'mappo_rnn': dict(num_envs=n, horizon=h, seq_batch=16, repeat_times=4),
              'qmix_rnn': dict(num_envs=n, horizon=h)}[trainer]
        fn = getattr(marl, 'train_' + ('qmix' if trainer == 'vdn' else trainer))
        t1 = time.time()
        final, history = fn(e, num_rounds=2, verbose=False, device=dev, **kw)
        entry_s = time.time() - t1
        assert len(history) == 2 and all(math.isfinite(x) for x in history), (trainer, history)
        assert on_card(final), trainer
        emit(phase=f'marl_{trainer}', envs=n, horizon=h, rounds=MARL_ROUNDS, round_ms=round_ms,
             env_steps_per_s=n * h / (round_ms / 1e3), metrics=metrics, eval_return=score,
             entry_point=dict(rounds=2, history=history, seconds=round(entry_s, 3)),
             every_tensor_on='cuda', kernels='none (PyTorch ops, as the JAX package runs XLA)',
             device=name, nvidia_smi=smi)


# ---------------------------------------------------------------- rlsolver/
# The MaxCut core on the committed 800-node BA instances at the sizes of
# scripts/maxcut_shootout.py:100-115, and PPO on node flips on the committed
# 64-node one.  The simulators' products are torch.matmul (the JAX package
# computes them outside any Pallas kernel); the flip env's V-trace
# advantages take K10.
MAXCUT_INSTANCES = ('syn_BA_800_dense.txt', 'syn_BA_800_sparse.txt')


def rlsolver_phases(torch, dev, name, smi, bound):
    """``rlsolver_maxcut``: each ported MaxCut method on both instances, its
    cut and seconds, gated on its x reproducing its cut in float64 numpy on
    the host and on beating random search at its number of sims;
    ``rlsolver_ppo_maxcut``: ``ppo_maxcut_solve`` on the card, K10 launched
    on its path (counts reset just before, read just after) and held against
    its plain version, bitwise, on the inputs of the path's last call.
    Returns the kernels line's K10 entry for this path."""
    from elegantrl_tpu_torch import rlsolver as rs
    from elegantrl_tpu_torch.ops import gae as gae_ops
    from elegantrl_tpu_torch.ops import kernels as kn

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0

    table = {}
    for inst in MAXCUT_INSTANCES:
        n, edges = rs.read_graph_txt(rs.data_path(inst))
        sim = rs.MaxCutSimulator(edges, n)            # the default device: the card
        assert sim.adj.device.type == 'cuda'
        adj64 = rs.edges_to_adjacency(edges, n).astype(np.float64)

        def host_cut(x):
            x = np.asarray(x.detach().cpu().numpy(), np.float64)
            assert set(np.unique(x)) <= {0.0, 1.0}
            return float(x @ adj64 @ (1.0 - x))

        cells = {}
        for method, sims, fn in (
                ('iSCO', 2048, lambda: rs.isco_solve(sim, gen(1), num_sims=2048, num_steps=360,
                                                     path_length=4)),
                ('MCPG', 2048, lambda: rs.mcpg_solve(sim, gen(2), num_chains=2048,
                                                     num_epochs=40)),
                ('greedy local search', 4096, lambda: rs.greedy_local_search(
                    sim, gen(4), num_sims=4096, num_iters=256)),
                ('simulated annealing', 4096, lambda: rs.simulated_annealing(
                    sim, gen(5), num_sims=4096, num_steps=2048))):
            out, secs = timed(fn)
            cut, x = float(out[0]), out[1]
            assert x.device.type == 'cuda' and host_cut(x) == cut, (inst, method)
            (r_cut, r_x), r_secs = timed(lambda: rs.random_search(sim, gen(9), num_sims=sims,
                                                                  num_rounds=1))
            assert host_cut(r_x) == float(r_cut)
            assert cut > float(r_cut), (inst, method, cut, float(r_cut))
            cells[method] = dict(cut=cut, seconds=secs, sims=sims,
                                 random_search_cut=float(r_cut), random_search_seconds=r_secs)
            emit(phase='rlsolver_maxcut', instance=inst, nodes=n, edges=sim.num_edges,
                 method=method, sims=sims, cut=cut, seconds=round(secs, 3),
                 random_search_cut=float(r_cut), x_reproduces_cut_in_float64=True,
                 device=name, nvidia_smi=smi)
        table[inst] = cells

    # ---- rlsolver_ppo_maxcut: the flip env's generic rollout and autograd
    # update (a one-hidden-layer net: the JAX package's scan and autograd
    # update), K10 once a round
    n, edges = rs.read_graph_txt(rs.data_path('syn_BA_64.txt'))
    sim = rs.MaxCutSimulator(edges, n)
    seen = []
    real = kn.gae_vtrace_kernel

    def spy(*a, **k):      # the agent's K10 call, its inputs kept for the check below
        seen[:] = [a, k]
        return real(*a, **k)

    gae_ops.gae_vtrace_kernel = spy
    real.launches = 0
    try:
        with tempfile.TemporaryDirectory() as cwd:
            out, secs = timed(lambda: rs.ppo_maxcut_solve(sim, seed=0, num_envs=64, cwd=cwd))
    finally:
        gae_ops.gae_vtrace_kernel = real
    launches = real.launches                      # read just after the path
    assert launches > 0 and seen, launches
    x = torch.as_tensor(out['best_x'], device=dev)
    assert abs(float(sim.obj(x[None])[0]) - out['best_cut']) < 1e-4
    adj64 = rs.edges_to_adjacency(edges, n).astype(np.float64)
    xh = out['best_x'].astype(np.float64)
    assert float(xh @ adj64 @ (1 - xh)) == out['best_cut']
    (r, u, um, v, nv, gamma, lam), kw = seen
    fa, fs = real(r, u, um, v, nv, gamma, lam, **kw)
    wa, ws = kn.vtrace_advantages_reference(r, u, um, v, nv, gamma, lam)
    torch.cuda.synchronize()
    assert torch.equal(fa, wa) and torch.equal(fs, ws), 'K10 differs on the ppo_maxcut path'
    H, N = r.shape
    ms = cuda_ms(torch, lambda: real(r, u, um, v, nv, gamma, lam, **kw), reps=50, warmup=3)
    plain_ms = cuda_ms(torch, lambda: kn.vtrace_advantages_reference(r, u, um, v, nv, gamma,
                                                                      lam), reps=5)
    b_ms, b_by = bound(11 * H * N, 4 * (6 * H * N + N))
    (r_cut, _), _ = timed(lambda: rs.random_search(sim, gen(9), num_sims=64, num_rounds=4))
    emit(phase='rlsolver_ppo_maxcut', instance='syn_BA_64.txt', nodes=n, num_envs=64,
         horizon=n, net_dims=(64,), break_step=200_000, best_cut=out['best_cut'],
         random_search_cut=float(r_cut), seconds=round(secs, 3),
         rollout='the generic rollout (no kernel body)', update='autograd (one hidden layer)',
         gae_vtrace_launches=launches, k10_bitwise_equal=True, k10_ms=ms, k10_plain_ms=plain_ms,
         device=name, nvidia_smi=smi)
    return [{'name': 'gae_vtrace[rlsolver_ppo_maxcut]', 'route': 'cuda',
             'source': 'elegantrl_tpu_torch/ops/csrc/kernels.cu',
             'replaces': 'elegantrl_tpu/ops/pallas_kernels.py:146', 'launches': launches,
             'max_abs_err': 0.0, 'ms': ms, 'plain_ms': plain_ms, 'bound_ms': b_ms,
             'bound_by': b_by, 'library_ms': None, 'H': H, 'N': N}], table


# ------------------------------------------- serving, tracing, the other solvers

SERVE_BATCHES = (1, 7, 64, 4096)
SERVE_THREADS, SERVE_REQUESTS = 4, 50
ECO_ROUNDS, CSP_STEPS = 2, 150


def _post_json(url, payload):
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def serve_profiling_phases(torch, dev, name, smi, bound):
    """``serve_policy``: PPO on Pendulum (4096 envs, (128, 128), a few rounds
    of ``train_agent`` through K1 and K2), SAC on Pendulum and DQN on
    CartPole (each saved as ``train_agent`` saves it), each served on the
    card by ``PolicyServer.start(port=0)``: ``/health``, then batches of 1,
    7, 64 and 4096 rows from four client threads of 50 requests each, every
    served action held against the plain version on the card (PPO and DQN:
    ``fused_mlp3_reference`` on the same rows within K11b's tolerance, 1e-5
    of the largest plain output; DQN's argmax ties aside; SAC, whose actor
    K11b does not take: the CPU server's answer within 1e-5), K11b counted
    once a request (the counts reset just before the requests, read just
    after), latencies, requests/s and K11b's time at each batch size
    beside its plain time and its bound.  ``profiling_trace``: three main
    path rounds traced by ``utils/profiling.py:trace`` and read back by
    ``parse_device_trace``.  Returns the kernels line's
    ``fused_mlp3[serve_policy]`` entry."""
    import threading
    from elegantrl_tpu_torch import Config, PolicyServer, build_training, train_agent
    from elegantrl_tpu_torch.agents import AgentDQN, AgentPPO, AgentSAC
    from elegantrl_tpu_torch.agents.ppo import norm_state
    from elegantrl_tpu_torch.envs import CartPoleEnv, PendulumEnv
    from elegantrl_tpu_torch.ops import kernels as kn
    from elegantrl_tpu_torch.ops.fused_rollout import rollout
    from elegantrl_tpu_torch.ops.fused_update import ppo_update
    from elegantrl_tpu_torch.ops.nets import dqn_param_shapes, split_flat
    from elegantrl_tpu_torch.utils.checkpoint import save_tree
    from elegantrl_tpu_torch.utils.profiling import parse_device_trace, sol_report, trace

    pend = {'env_name': 'Pendulum-v1', 'num_envs': NUM_ENVS, 'max_step': 200, 'state_dim': 3,
            'action_dim': 1, 'if_discrete': False}
    cart = {'env_name': 'CartPole-v1', 'num_envs': 64, 'max_step': 500, 'state_dim': 4,
            'action_dim': 2, 'if_discrete': True}

    def main_path_args(cwd):
        a = Config(AgentPPO, PendulumEnv, dict(pend))
        a.horizon_len, a.batch_size, a.repeat_times = HORIZON, BATCH, REPEAT
        a.net_dims, a.random_seed, a.cwd = NET_DIMS, 0, cwd
        return a

    table, k11b_rows = {}, {}
    serve_launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        # ---- the checkpoints
        ckpts = {}
        a = main_path_args(os.path.join(tmp, 'ppo'))
        a.eval_per_step, a.break_step, a.eval_times = NUM_ENVS * HORIZON, 2 * NUM_ENVS * HORIZON, 2
        rollout.launches = ppo_update.launches = 0
        t0 = time.time()
        res = train_agent(a)
        train_s = time.time() - t0
        assert rollout.launches >= 3 and ppo_update.launches >= 3, (rollout.launches,
                                                                    ppo_update.launches)
        ckpts['ppo'] = (AgentPPO, pend, os.path.join(a.cwd, 'agent.npz'))
        emit(phase='serve_policy_train', agent='AgentPPO', env='Pendulum-v1', envs=NUM_ENVS,
             total_step=int(res['total_step']), seconds=round(train_s, 3),
             rollout_launches=rollout.launches, update_launches=ppo_update.launches)
        for key, agent, env_class, env_args in (
                ('sac', AgentSAC, PendulumEnv, dict(pend, num_envs=64)),
                ('dqn', AgentDQN, CartPoleEnv, cart)):
            a = Config(agent, env_class, dict(env_args))
            a.net_dims, a.random_seed, a.buffer_size = NET_DIMS, 0, 2 ** 16
            ctx = build_training(a)
            path = os.path.join(tmp, key, 'agent.npz')
            save_tree(path, ctx.agent.state_to_numpy(ctx.carry.agent_state))
            ckpts[key] = (agent, env_args, path)

        # ---- serve each on the card
        for key, (agent, env_args, path) in ckpts.items():
            srv = PolicyServer(agent, net_dims=NET_DIMS, env_args=dict(env_args),
                               checkpoint=path)
            cpu_srv = PolicyServer(agent, net_dims=NET_DIMS, env_args=dict(env_args),
                                   checkpoint=path, device='cpu')
            assert srv.device.type == dev.type
            S, A = env_args['state_dim'], env_args['action_dim']
            port = srv.start(port=0)
            base = f'http://127.0.0.1:{port}'
            try:
                import urllib.request
                health = json.loads(urllib.request.urlopen(base + '/health', timeout=60).read())
                assert health['ok'] and health['state_dim'] == S, health
                for B in SERVE_BATCHES:
                    g = np.random.default_rng(B)
                    batches = [(g.normal(size=(B, S)) * 2.0).astype(np.float32)
                               for _ in range(SERVE_THREADS * SERVE_REQUESTS)]
                    answers, lat, errors = [None] * len(batches), [0.0] * len(batches), []

                    def client(t):
                        try:
                            for i in range(t, len(batches), SERVE_THREADS):
                                t1 = time.perf_counter()
                                out = _post_json(base + '/act', {'obs': batches[i].tolist()})
                                lat[i] = time.perf_counter() - t1
                                answers[i] = np.asarray(out['action'])
                        except Exception as e:   # re-raised below
                            errors.append(e)

                    requests0 = srv.requests
                    threads = [threading.Thread(target=client, args=(t,))
                               for t in range(SERVE_THREADS)]
                    kn.fused_mlp3.launches = 0
                    t1 = time.perf_counter()
                    for th in threads:
                        th.start()
                    for th in threads:
                        th.join()
                    wall = time.perf_counter() - t1
                    launches = kn.fused_mlp3.launches          # read just after the requests
                    assert not errors, errors
                    n_req = len(batches)
                    assert srv.requests - requests0 == n_req
                    assert launches == (0 if key == 'sac' else n_req), (key, B, launches)
                    serve_launches += launches
                    # every answer against the plain version on the same rows;
                    # K11b's tolerance, 1e-5 of the largest plain output over
                    # the rows served at this batch size (tanh and the argmax
                    # add no error: tanh is 1-Lipschitz, and an argmax is
                    # right where its plain value is the largest, ties aside)
                    st = srv.agent_state
                    worst = scale = 0.0
                    for obs, got in zip(batches, answers):
                        x = torch.as_tensor(obs, device=dev)
                        if key == 'ppo':
                            xn = norm_state(x, st.norm_avg, st.norm_std).contiguous()
                            leaves = [t.contiguous() for t in st.act.mlp.leaves()]
                            ref = kn.fused_mlp3_reference(xn, *leaves)
                            err = float((torch.tanh(ref).cpu() - torch.as_tensor(got)).abs().max())
                            scale = max(scale, float(ref.abs().max()))
                            assert got.shape == (B, A), (key, B, got.shape)
                        elif key == 'dqn':
                            leaves = split_flat(st.q, dqn_param_shapes(S, NET_DIMS, A, False,
                                                                       False))
                            xn, leaves = x, [t.contiguous() for t in leaves]
                            q = kn.fused_mlp3_reference(x, *leaves).cpu()
                            chosen = q[torch.arange(B), torch.as_tensor(got).long()]
                            err = float((q.max(-1).values - chosen).max())
                            scale = max(scale, float(q.abs().max()))
                            assert got.shape == (B,), (key, B, got.shape)
                        else:       # no kernel: the CPU server's answer
                            err = float(np.abs(got - cpu_srv.act(obs)).max())
                            scale = 1.0
                            assert got.shape == (B, A), (key, B, got.shape)
                        worst = max(worst, err)
                    assert worst <= 1e-5 * scale, (key, B, worst, scale)
                    lat_ms = np.sort(np.asarray(lat)) * 1e3
                    cell = dict(rows=B, requests=n_req, threads=SERVE_THREADS,
                                p50_ms=float(np.percentile(lat_ms, 50)),
                                p99_ms=float(np.percentile(lat_ms, 99)),
                                requests_per_s=n_req / wall, rows_per_s=n_req * B / wall,
                                fused_mlp3_launches=launches, max_abs_err=worst,
                                max_abs_plain_out=scale)
                    if key != 'sac':
                        # K11b at this batch size on the last request's rows,
                        # held again and timed (outside the counted window)
                        kern = kn.fused_mlp3(xn, *leaves)
                        ref = kn.fused_mlp3_reference(xn, *leaves)
                        torch.cuda.synchronize()
                        k_err = float((kern - ref).abs().max())
                        assert k_err <= 1e-5 * float(ref.abs().max()), (key, B, k_err)
                        ms = cuda_ms(torch, lambda: kn.fused_mlp3(xn, *leaves), reps=50, warmup=3)
                        plain = cuda_ms(torch, lambda: kn.fused_mlp3_reference(xn, *leaves),
                                        reps=50, warmup=3)
                        D1, D2 = NET_DIMS
                        n_params = sum(t.numel() for t in leaves)
                        b_ms, b_by = bound(2 * B * (S * D1 + D1 * D2 + D2 * A),
                                           4 * (B * S + n_params + B * A))
                        k11b_rows[(key, B)] = dict(max_abs_err=k_err, ms=ms, plain_ms=plain,
                                                   bound_ms=b_ms, bound_by=b_by)
                        cell.update(k11b_ms=ms, k11b_plain_ms=plain, k11b_bound_ms=b_ms,
                                    k11b_bound_by=b_by, k11b_max_abs_err=k_err)
                    table[(key, B)] = cell
                    emit(phase='serve_policy', agent=agent.__name__, env=env_args['env_name'],
                         net_dims=NET_DIMS, **cell,
                         served_as='the rows as given (no padding)', device=name,
                         nvidia_smi=smi)
                health = json.loads(urllib.request.urlopen(base + '/health', timeout=60).read())
                assert health['requests'] == srv.requests
            finally:
                srv.stop()

    # ---- profiling_trace: three main-path rounds traced and read back
    with tempfile.TemporaryDirectory() as run_dir:
        ctx = build_training(main_path_args(run_dir))
        carry, _ = ctx.round_fn(ctx.carry)                        # warm-up round
        torch.cuda.synchronize()
        S, A = 3, 1
        D1, D2 = NET_DIMS
        net_flop = 2 * (S * D1 + D1 * D2 + D2 * 1) + 2 * (S * D1 + D1 * D2 + D2 * A)
        # the nets' products of a round: both nets an env-step, then U =
        # int(H repeat / B) minibatch updates of 3 forwards' worth a sample
        updates = max(1, int(HORIZON * REPEAT / BATCH))
        flop_round = net_flop * NUM_ENVS * HORIZON + 3 * net_flop * BATCH * updates
        attempts = []
        for attempt in range(3):
            with tempfile.TemporaryDirectory() as log_dir:
                with trace(log_dir):
                    for _ in range(3):
                        carry, _ = ctx.round_fn(carry)
                agg = parse_device_trace(log_dir)
            assert agg is not None and 0.0 < agg['busy_frac'] <= 1.0, agg and agg['busy_frac']
            counts = {k: sum(c for op, c in agg['count_by_op'].items() if k in op)
                      for k in ('fused_rollout_kernel', 'ppo_update_kernel')}
            attempts.append(counts)
            if all(c == 3 for c in counts.values()):
                break
        # the profiler can drop device events (see profiled_ms): a trace is
        # taken again, at most three times, and every attempt is reported
        assert all(c == 3 for c in counts.values()), attempts
        sol = sol_report(flop_round * 3, agg['bytes'] or 0.0, agg['busy_s'], chip='H100 SXM')
        top = dict(list(agg['seconds_by_op'].items())[:6])
        emit(phase='profiling_trace', rounds=3, envs=NUM_ENVS, horizon=HORIZON, batch=BATCH,
             busy_s=agg['busy_s'], span_s=agg['span_s'], busy_frac=agg['busy_frac'],
             seconds_by_category=agg['seconds_by_category'], top_ops_s=top,
             kernel_launches=counts, attempts=attempts, bytes=agg['bytes'], flops=agg['flops'],
             sol_compute_util=sol.compute_util, sol_peak_tflops=sol.peak_tflops,
             sol_flop=flop_round * 3, sol=str(sol), device=name, nvidia_smi=smi)

    main = k11b_rows[('ppo', SERVE_BATCHES[-1])]
    return [{'name': 'fused_mlp3[serve_policy]', 'route': 'cuda',
             'source': 'elegantrl_tpu_torch/ops/csrc/kernels.cu',
             'replaces': 'elegantrl_tpu/ops/pallas_kernels.py:172', 'launches': serve_launches,
             'max_abs_err': max(r['max_abs_err'] for r in k11b_rows.values()),
             'ms': main['ms'], 'plain_ms': main['plain_ms'], 'bound_ms': main['bound_ms'],
             'bound_by': main['bound_by'], 'library_ms': None, 'dims': (3, *NET_DIMS, 1),
             'B': SERVE_BATCHES[-1],
             'by_batch': {f'{k}_B{b}': v for (k, b), v in k11b_rows.items()},
             'launches_cover': 'one a request to the PPO and DQN servers'}], table


def _host_cut(x, adj64):
    """The cut of 0/1 ``x`` in float64 numpy on the host."""
    x = np.asarray(x.detach().cpu().numpy() if hasattr(x, 'detach') else x, np.float64)
    assert set(np.unique(x)) <= {0.0, 1.0}
    return float(x @ adj64 @ (1.0 - x))


def _brute(n, value, feasible):
    best = -np.inf
    for mask in range(1 << n):
        x = np.array([(mask >> i) & 1 for i in range(n)], np.float64)
        if feasible(x):
            best = max(best, value(x))
    return best


def rlsolver_more_phases(torch, dev, name, smi):
    """``rlsolver_problems``: graph partitioning, set cover, BILP and
    portfolio on the card on the JAX tests' own instances
    (``tests/test_rlsolver_problems2.py``), each reaching the optimum those
    tests require, and partitioning on ``syn_BA_800_dense.txt`` against the
    best balanced random partition; every x recomputed in float64 numpy on
    the host, objective and feasibility.  ``rlsolver_learned``: ECO-DQN
    trained once on 32 BA-60 graphs (2 x 500 steps, cut from the shootout's
    8 x 500 for the time limit) then greedy with 64 restarts and with eps
    0.05, S2V-DQN at 40 epochs, L2A, RUN-CSP (trained on the same BA-60
    pool, 150 steps) and PI-GNN at their defaults, on
    both 800-node instances, each cut reproduced in float64 and beating
    random search at the same number of parallel solutions; the
    attention-model TSP at ``train_attention_tsp``'s defaults against
    random tours; GraphTRS pretrained at its defaults on ER-64 graphs and
    its embeddings transferred to L2A on an unseen ER-64 graph."""
    from elegantrl_tpu_torch import rlsolver as rs

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0

    # ---- rlsolver_problems
    edges = []
    for block in (range(4), range(4, 8)):
        block = list(block)
        edges += [(block[a], block[b], 1.0) for a in range(4) for b in range(a + 1, 4)]
    bridge = np.array(edges + [(0, 4, 1.0)])
    sim = rs.GraphPartitionSimulator(bridge, 8)
    assert sim.adj.device.type == dev.type
    (_, x), secs = timed(lambda: rs.genetic_algorithm(sim, gen(0), pop_size=128,
                                                       num_generations=16))
    adj64 = rs.edges_to_adjacency(bridge, 8).astype(np.float64)
    xh = x.cpu().numpy().astype(np.float64)
    assert _host_cut(x, adj64) == 1.0 and xh.sum() == 4.0
    emit(phase='rlsolver_problems', problem='graph_partitioning', instance='two K4 + bridge',
         cut=1.0, optimum=1.0, balanced=True, seconds=round(secs, 3), device=name,
         nvidia_smi=smi)

    m = np.zeros((5, 6))
    for i, cols in enumerate(([0, 1, 2], [3, 4, 5], [0, 3], [1, 4], [2, 5])):
        m[i, cols] = 1
    sim = rs.SetCoverSimulator(m)
    (_, x), secs = timed(lambda: rs.genetic_algorithm(sim, gen(1), pop_size=64,
                                                       num_generations=16))
    xh = x.cpu().numpy().astype(np.float64)
    assert (xh @ m >= 1).all() and xh.sum() == 2.0
    emit(phase='rlsolver_problems', problem='set_cover', instance='5 sets over 6 elements',
         size=2.0, optimum=2.0, covers=True, seconds=round(secs, 3), device=name,
         nvidia_smi=smi)

    rng = np.random.default_rng(7)
    c, a = rng.uniform(1, 10, 10), rng.uniform(0, 5, (4, 10))
    b = a.sum(1) * 0.4
    best = _brute(10, lambda x: float(c @ x), lambda x: (a @ x <= b + 1e-9).all())
    sim = rs.BILPSimulator(c, a, b)

    def bilp():
        xs = sim.local_search_sweep(sim.rand_xs(gen(2), 1024), gen(3), num_sweeps=32)
        return sim.best(xs)
    (val, x), secs = timed(bilp)
    xh = x.cpu().numpy().astype(np.float64)
    assert (a @ xh <= b + 1e-9).all() and float(c @ xh) >= 0.99 * best, (float(c @ xh), best)
    emit(phase='rlsolver_problems', problem='bilp', instance='10 vars, 4 constraints (seed 7)',
         value=float(c @ xh), optimum=best, feasible=True, seconds=round(secs, 3),
         device=name, nvidia_smi=smi)

    rng = np.random.default_rng(9)
    mu = rng.uniform(0, 1, 10)
    q = rng.normal(size=(10, 10)) * 0.1
    sigma = q @ q.T + np.eye(10) * 0.05
    best = _brute(10, lambda x: float(mu @ x - x @ sigma @ x), lambda x: x.sum() == 3)
    sim = rs.PortfolioSimulator(mu, sigma, 3)
    (_, x), secs = timed(lambda: rs.simulated_annealing(sim, gen(4), num_sims=512,
                                                         num_steps=512))
    xh = x.cpu().numpy().astype(np.float64)
    value = float(mu @ xh - xh @ sigma @ xh)
    assert xh.sum() == 3 and value >= best - 1e-3, (value, best)
    emit(phase='rlsolver_problems', problem='portfolio_allocation',
         instance='10 assets, k = 3 (seed 9)', value=value, optimum=best, exactly_k=True,
         seconds=round(secs, 3), device=name, nvidia_smi=smi)

    n, edges = rs.read_graph_txt(rs.data_path('syn_BA_800_dense.txt'))
    sim = rs.GraphPartitionSimulator(edges, n)
    adj64 = rs.edges_to_adjacency(edges, n).astype(np.float64)
    (_, x), secs = timed(lambda: rs.greedy_local_search(sim, gen(5), num_sims=4096,
                                                         num_iters=256))
    xh = x.cpu().numpy().astype(np.float64)
    cut = _host_cut(x, adj64)
    assert xh.sum() == n / 2 and float(sim.best(x[None])[0]) == cut
    r_cut, _ = sim.best(sim.rand_xs(gen(6), 4096))     # the best balanced random partition
    assert math.isfinite(float(r_cut)) and cut < float(r_cut), (cut, float(r_cut))
    emit(phase='rlsolver_problems', problem='graph_partitioning',
         instance='syn_BA_800_dense.txt', nodes=n, method='greedy local search', sims=4096,
         cut=cut, balanced=True, random_balanced_cut=float(r_cut), seconds=round(secs, 3),
         device=name, nvidia_smi=smi)

    # ---- rlsolver_learned
    pool_adjs = np.stack([rs.edges_to_adjacency(rs.generate_graph('BA', 60, seed=s), 60)
                          for s in range(32)])
    pool = rs.build_pool(pool_adjs)
    init_fn, round_fn = rs.make_eco_dqn(pool, batch=32, features=64, layers=3,
                                        replay_cap=8192, eps_decay_steps=2000,
                                        target_freq=100, lr_peak=1e-3, lr_final=1e-4,
                                        lr_ramp=300, lr_decay=4000)

    # the training runs are cut for the script's time limit: ECO-DQN to 2 x
    # 500 of the shootout's 8 x 500 steps, RUN-CSP to 150 of 300
    def eco_train():
        ts = init_fn(gen(0))
        for _ in range(ECO_ROUNDS):
            ts, ms = round_fn(ts, 500)
        return ts, ms
    (ts, ms), eco_s = timed(eco_train)
    assert math.isfinite(float(ms['loss'])) and ts.tick == ECO_ROUNDS * 500
    emit(phase='rlsolver_learned', method='ECO-DQN training', pool='32 BA-60',
         steps=ECO_ROUNDS * 500, batch=32, seconds=round(eco_s, 3), loss=float(ms['loss']),
         best=float(ms['best']), device=name, nvidia_smi=smi)
    init_fn, train_fn = rs.make_runcsp(pool_adjs)
    (csp_state, csp_loss), csp_s = timed(lambda: train_fn(init_fn(gen(1)), gen(2), CSP_STEPS))
    assert math.isfinite(float(csp_loss))
    emit(phase='rlsolver_learned', method='RUN-CSP training', pool='32 BA-60', steps=CSP_STEPS,
         seconds=round(csp_s, 3), loss=float(csp_loss), device=name, nvidia_smi=smi)

    table = {}
    for inst in MAXCUT_INSTANCES:
        n, edges = rs.read_graph_txt(rs.data_path(inst))
        sim = rs.MaxCutSimulator(edges, n)
        adj = rs.edges_to_adjacency(edges, n)
        adj64 = adj.astype(np.float64)

        def spins_cut(spins):
            s = np.asarray(spins, np.float64)
            return float((adj64.sum() - s @ adj64 @ s) / 4.0)

        cells = {}
        for method, sims, fn, check in (
                ('ECO-DQN (greedy, 64 restarts)', 64,
                 lambda: rs.eco_greedy_solve(ts.params, adj, num_restarts=64, gen=gen(3)),
                 spins_cut),
                ('ECO-DQN (eps 0.05, 64 restarts)', 64,
                 lambda: rs.eco_greedy_solve(ts.params, adj, num_restarts=64, gen=gen(6),
                                             eps=0.05), spins_cut),
                ('S2V-DQN (40 epochs on the instance)', 256,
                 lambda: rs.s2v_dqn_solve(sim, gen(7), num_epochs=40),
                 lambda x: _host_cut(x, adj64)),
                ('L2A', 512, lambda: rs.l2a_solve(sim, gen(8)), lambda x: _host_cut(x, adj64)),
                ('RUN-CSP (BA-60 pool)', 64,
                 lambda: rs.runcsp_solve(csp_state[0], adj, gen(9)),
                 lambda x: _host_cut(x, adj64)),
                ('PI-GNN', 16, lambda: rs.pignn_maxcut(sim, gen(10)),
                 lambda x: _host_cut(x, adj64))):
            out, secs = timed(fn)
            cut, x = float(out[0]), out[1]
            assert check(x) == cut, (inst, method, check(x), cut)
            (r_cut, r_x), _ = timed(lambda: rs.random_search(sim, gen(11), num_sims=sims,
                                                             num_rounds=1))
            assert _host_cut(r_x, adj64) == float(r_cut)
            assert cut > float(r_cut), (inst, method, cut, float(r_cut))
            cells[method] = dict(cut=cut, seconds=secs, sims=sims, random_search_cut=float(r_cut))
            emit(phase='rlsolver_learned', instance=inst, nodes=n, method=method, sims=sims,
                 cut=cut, seconds=round(secs, 3), random_search_cut=float(r_cut),
                 reproduced_in_float64=True, device=name, nvidia_smi=smi)
        table[inst] = cells

    # the attention-model TSP at train_attention_tsp's defaults (20 cities)
    (am, am_s) = timed(lambda: rs.train_attention_tsp(verbose=False))
    params, _, solve = am
    cities = rs.random_cities(20, seed=11)
    length, tour = solve(params, cities, gen(12))
    tsp = rs.TSPSimulator(cities)
    c64 = np.asarray(cities, np.float64)
    t = tour.cpu().numpy()
    assert sorted(t.tolist()) == list(range(20))
    host_len = float(np.sum(np.linalg.norm(c64[t] - c64[np.roll(t, -1)], axis=-1)))
    assert abs(host_len - float(length)) <= 1e-4 * host_len
    rnd = float(tsp.tour_length(tsp.rand_tours(gen(13), 256)).min())
    assert host_len < rnd, (host_len, rnd)
    emit(phase='rlsolver_learned', method='attention-model TSP', cities=20, train_steps=200,
         train_sims=256, train_seconds=round(am_s, 3), tour_length=host_len,
         random_tours_best_of_256=rnd, device=name, nvidia_smi=smi)

    # GraphTRS pretrain at its defaults, then its transfer to L2A
    (trs, trs_s) = timed(lambda: rs.pretrain_graph_trs(64))
    trs_params, embed, hist = trs
    assert hist[-1][0] < hist[0][0], hist
    edges = rs.generate_graph('ER', 64, seed=777)
    sim = rs.MaxCutSimulator(edges, 64)
    adj64 = rs.edges_to_adjacency(edges, 64).astype(np.float64)
    with torch.no_grad():
        emb = embed(trs_params, torch.as_tensor(adj64[None], dtype=torch.float32, device=dev))[0]
    (l2a, l2a_s) = timed(lambda: rs.l2a_solve(sim, gen(14), node_embed=emb))
    cut = l2a[0]
    assert _host_cut(l2a[1], adj64) == cut
    r_cut, _ = rs.random_search(sim, gen(15), num_sims=512, num_rounds=1)
    assert cut > float(r_cut), (cut, float(r_cut))
    emit(phase='rlsolver_learned', method='GraphTRS pretrain + L2A transfer',
         pretrain='64 ER-64 graphs, 200 steps, batch 16', pretrain_seconds=round(trs_s, 3),
         pretrain_history=hist, instance='ER-64 seed 777 (unseen)', cut=cut,
         l2a_seconds=round(l2a_s, 3), random_search_cut=float(r_cut), device=name,
         nvidia_smi=smi)
    return table


# ------------------------------------------------- rlsolver/vrp.py and tnco.py

def vrptw_host_check(inst, tour):
    """An independent host checker of one VRPTW tour (``tests/test_vrp.py``'s
    ``_validate``): every customer once, capacity, time windows; returns the
    tour's distance, the first leg out of the depot included, in float64."""
    xy = np.asarray(inst['xy'], np.float64)
    dist = lambda a, b: float(np.hypot(*(xy[a] - xy[b])))   # noqa: E731
    seen, pos, clock, cap, total = set(), 0, 0.0, inst['capacity'], 0.0
    for node in np.asarray(tour).tolist():
        total += dist(pos, node)
        if node == 0:
            pos, clock, cap = 0, 0.0, inst['capacity']
            continue
        assert node not in seen, f'customer {node} visited twice'
        seen.add(node)
        start = max(clock + dist(pos, node), inst['ready'][node])
        assert start <= inst['due'][node] + 1e-4, f'window violated at {node}'
        cap -= inst['demand'][node]
        assert cap >= -1e-6, f'capacity violated at {node}'
        clock = start + inst['service'][node]
        pos = node
    assert seen == set(range(1, len(xy))), 'not all customers served'
    return total


def host_contract_log2(bonds, open_, order_pairs):
    """log2 of the multiply count of contracting node pairs in order, by an
    independent evaluator (``tests/test_tnco.py``'s ``host_contract_cost``):
    explicit clusters, float64 dims."""
    n = len(bonds)
    clusters, owner, total = {i: {i} for i in range(n)}, list(range(n)), 0.0

    def ext(cl):
        d = 0.0
        for i in cl:
            d += open_[i] + sum(bonds[i][j] for j in range(n) if j not in cl)
        return d

    for u, v in order_pairs:
        a, b = owner[u], owner[v]
        if a == b:
            continue
        shared = sum(bonds[i][j] for i in clusters[a] for j in clusters[b])
        total += 2.0 ** (ext(clusters[a]) + ext(clusters[b]) - shared)
        clusters[a] |= clusters.pop(b)
        for i in clusters[a]:
            owner[i] = a
    return math.log2(total)


def vrp_tnco_phases(torch, dev, name, smi):
    """``rlsolver_vrp_tnco``: ``vrptw_solve`` with 512 sims on the committed
    ``rand24_vrptw.txt`` and on ``random_vrptw(100, seed=0, num_vehicles=25,
    capacity=200)`` (Solomon's size and C1 capacity), each best tour checked
    by the host checker and its distance recomputed in float64; the TNCO
    greedy (256 sims) and annealing (512 x 256) on ``grid_tn(8, 8,
    bond_log2=2)`` and ``random_tn(64, degree=3, seed=0)``, each result
    recomputed by the host evaluator (the greedy's merges, the annealing's
    priority order); the annealing on a matrix chain against its DP optimum;
    and ``examples_torch/tutorial_rlsolver.py``'s ``main`` on the card."""
    from elegantrl_tpu_torch import rlsolver as rs
    from elegantrl_tpu_torch.rlsolver.graphs import data_path, read_solomon

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0

    for label, inst in (('rand24_vrptw.txt', read_solomon(data_path('rand24_vrptw.txt'))),
                        ('random_vrptw(100, seed=0, num_vehicles=25, capacity=200)',
                         rs.random_vrptw(100, seed=0, num_vehicles=25, capacity=200.0))):
        rs.vrptw_solve(inst, 1, num_sims=64, device=dev)                       # warm-up
        (d, tour, veh), secs = timed(lambda: rs.vrptw_solve(inst, 0, num_sims=512, device=dev))
        host_d = vrptw_host_check(inst, tour)
        assert math.isfinite(d) and veh <= inst['num_vehicles'], (label, d, veh)
        assert abs(host_d - d) <= 1e-4 * host_d, (label, d, host_d)
        emit(phase='rlsolver_vrp_tnco', solver='vrptw_solve', instance=label,
             customers=len(inst['xy']) - 1, num_sims=512, tour_len=len(tour), distance=d,
             distance_float64=host_d, vehicles=veh, vehicle_budget=inst['num_vehicles'],
             seconds=round(secs, 4), device=name, nvidia_smi=smi)

    nets = (('grid_tn(8, 8, bond_log2=2.0)', rs.grid_tn(8, 8, bond_log2=2.0, device=dev)),
            ('random_tn(64, degree=3, seed=0)', rs.random_tn(64, degree=3, seed=0, device=dev)))
    for label, sim in nets:
        bonds = sim.bonds.cpu().double().numpy()
        open_ = sim.open.cpu().double().numpy()
        edges = list(zip(sim.edges_u.tolist(), sim.edges_v.tolist()))
        rand_c = sim.contraction_cost(sim.rand_xs(7, 512))
        (g_c, merges), g_s = timed(lambda: rs.tnco_greedy(sim, 0, num_sims=256))
        (a_c, a_x), a_s = timed(lambda: rs.tnco_anneal(sim, 0, num_sims=512, num_steps=256))
        g_host = host_contract_log2(bonds, open_, merges.tolist())
        order = np.argsort(a_x.cpu().numpy(), kind='stable')
        a_host = host_contract_log2(bonds, open_, [edges[i] for i in order])
        assert abs(g_host - float(g_c)) < 1e-3 and abs(a_host - float(a_c)) < 1e-3, (
            label, float(g_c), g_host, float(a_c), a_host)
        assert float(a_c) <= float(rand_c.min()) + 1e-4, (label, float(a_c), float(rand_c.min()))
        emit(phase='rlsolver_vrp_tnco', solver='tnco', instance=label, nodes=sim.num_nodes,
             edges=sim.num_edges, greedy=dict(num_sims=256, log2_cost=float(g_c),
                                              log2_cost_float64=g_host, seconds=round(g_s, 4)),
             anneal=dict(num_sims=512, num_steps=256, log2_cost=float(a_c),
                         log2_cost_float64=a_host, seconds=round(a_s, 4)),
             random_best_of_512=float(rand_c.min()), random_median=float(rand_c.median()),
             device=name, nvidia_smi=smi)

    dims = [32, 2, 64, 4, 128, 2]
    chain = rs.matrix_chain(dims, device=dev)
    (c_c, _), c_s = timed(lambda: rs.tnco_anneal(chain, 0, num_sims=256, num_steps=128))
    opt = rs.matrix_chain_dp(dims)
    assert abs(2.0 ** float(c_c) - opt) <= 1e-4 * opt, (2.0 ** float(c_c), opt)
    emit(phase='rlsolver_vrp_tnco', solver='tnco_anneal', instance=f'matrix_chain({dims})',
         multiplies=2.0 ** float(c_c), dp_optimum=opt, seconds=round(c_s, 4), device=name)

    tutorial = load_script('examples_torch', 'tutorial_rlsolver')
    out, t_s = timed(lambda: tutorial.main(device=dev))
    assert np.isclose(2.0 ** out['tnco'][0], out['tnco'][1], rtol=1e-4), out['tnco']
    assert math.isfinite(out['vrptw'][0]) and out['maxcut'][3] >= out['maxcut'][0], out
    emit(phase='rlsolver_vrp_tnco', solver='examples_torch/tutorial_rlsolver.py', results=out,
         seconds=round(t_s, 3), device=name)


# ------------------------------------------- helloworld_torch/, examples_torch/

def load_script(tree, name):
    """``tree/name.py`` of this checkout as a module (a driver that imports a
    sibling by name finds it in its own tree)."""
    import importlib.util
    root = os.path.dirname(os.path.abspath(__file__))
    folder = os.path.join(root, tree)
    if root not in sys.path:
        sys.path.insert(0, root)
    sys.path.insert(0, folder)
    try:
        spec = importlib.util.spec_from_file_location(f'{tree}.{name}',
                                                      os.path.join(folder, name + '.py'))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(folder)
    return mod


# Each training driver that needs no gymnasium, as its __main__ calls it by
# default (plan_DDPG_H with its 'quick' arguments: its full variant's ring,
# 2e6 rows x 1024 envs of HopperSlip transitions, is 90 GB), and the set of
# kernels each must launch on the card: (tree, file, function, arguments,
# kernels).  The helloworld tutorial's three calls are the erl tutorials'.
_ON = {'fused_rollout', 'ppo_update', 'gae_vtrace', 'fused_mlp3'}       # K1/K3, K2/K5, K10, K11b
_A2C = {'fused_rollout', 'gae_vtrace', 'fused_mlp3'}                    # no update kernel
_GEN = {'ppo_update', 'gae_vtrace', 'fused_mlp3'}                       # the generic rollout
_STOCK = {'fused_rollout', 'critic_values', 'ppo_update', 'gae_vtrace', 'fused_mlp3'}   # K4
_OFF = {'offpolicy_rollout', 'buffer_gather'}                          # K6/K6', K11a
_DDPG = _OFF | {'ddpg_update', 'fused_mlp3'}                            # K7, K11b
_SAC = _OFF | {'sac_update'}                                           # K8
_DQN = _OFF | {'dqn_update'}                                           # K9
_E, _H = 'examples_torch', 'helloworld_torch'
DRIVER_RUNS = [
    (_E, 'tutorial_helloworld_DQN_DDPG_PPO', 'tutorial_dqn', (), _OFF | {'fused_mlp3'}),
    (_E, 'tutorial_helloworld_DQN_DDPG_PPO', 'tutorial_ddpg', (), _DDPG),
    (_E, 'tutorial_helloworld_DQN_DDPG_PPO', 'tutorial_ppo', (), _ON),
    (_H, 'erl_tutorial_DDPG_TD3_SAC', 'train_for_pendulum', ('AgentTD3',), _DDPG),
    (_H, 'erl_tutorial_DDPG_TD3_SAC', 'train_for_pendulum', ('AgentSAC',), _SAC),
    (_H, 'erl_tutorial_DDPG_TD3_SAC', 'train_for_pendulum', ('AgentModSAC',), _SAC),
    (_E, 'demo_A2C_PPO', 'train_ppo_a2c_for_pendulum', ('AgentPPO',), _ON),
    (_E, 'demo_A2C_PPO', 'train_ppo_a2c_for_pendulum', ('AgentA2C',), _A2C),
    (_E, 'demo_A2C_PPO', 'train_ppo_for_pendulum_many_envs', (), _A2C),   # batch 4096: autograd
    (_E, 'demo_A2C_PPO', 'train_ppo_for_point_chasing', (), _ON),
    (_E, 'demo_A2C_PPO_discrete', 'train_discrete_ppo_for_cartpole', ('AgentDiscretePPO',), _ON),
    (_E, 'demo_A2C_PPO_discrete', 'train_discrete_ppo_for_cartpole', ('AgentDiscreteA2C',), _A2C),
    (_E, 'demo_A2C_PPO_discrete', 'train_discrete_ppo_for_lunar_lander', ('AgentDiscretePPO',),
     _GEN),
] + [(_E, 'demo_DDPG_TD3_SAC', 'train_for_pendulum', (a,), k)
     for a, k in (('AgentDDPG', _DDPG), ('AgentTD3', _DDPG), ('AgentSAC', _SAC),
                  ('AgentModSAC', _SAC))] + [
    (_E, 'demo_DDPG_TD3_SAC_with_PER', 'train_with_per', (a,), k)    # SAC under PER: autograd
    for a, k in (('AgentDDPG', _DDPG), ('AgentTD3', _DDPG), ('AgentSAC', _OFF),
                 ('AgentModSAC', _OFF))] + [
    (_E, 'demo_DQN_variants', 'train_dqn_for_cartpole', (a,), k)
    for a, k in (('AgentDQN', _DQN | {'fused_mlp3'}), ('AgentDoubleDQN', _DQN),
                 ('AgentDuelingDQN', _DQN), ('AgentD3QN', _DQN),
                 ('AgentEmbedDQN', {'buffer_gather'}), ('AgentEnsembleDQN', {'buffer_gather'}))
] + [
    (_E, 'demo_DQN_variants', 'train_dqn_for_point_chasing', (), _DQN),
    (_E, 'demo_FinRL_stock_trading', 'train_ppo_for_stock_trading', (), _STOCK),
] + [(_E, 'plan_DDPG_H', 'demo_offpolicy_h_term', (a, 16, int(1e5)), k)
     for a, k in (('AgentDDPG', _DDPG), ('AgentDDPGHterm', _OFF | {'fused_mlp3'}),
                  ('AgentTD3Hterm', _OFF | {'fused_mlp3'}), ('AgentSACHterm', _OFF),
                  ('AgentModSACHterm', _OFF))] + [
    (_E, 'plan_PPO_H', 'demo_ppo_h_term', ('AgentPPO',), _ON),
    (_E, 'plan_PPO_H', 'demo_ppo_h_term', ('AgentPPOHterm',), {'gae_vtrace', 'fused_mlp3'}),
    (_E, 'plan_Isaac_Gym', 'plan_isaac', ('mock',), _GEN),
    (_E, 'plan_PaperTradingEnv_PPO', 'train', (False,), _STOCK),
    (_E, 'tutorial_Creating_VecEnv', 'main', (), _GEN),
    (_E, 'tutorial_Hopper_v3', 'train_native_hopper', (), _ON),
    (_E, 'tutorial_LunarLanderContinuous_v2', 'train_native', (), _GEN),
    (_E, 'tutorial_Pendulum_v1', 'main', (), _ON),
]
DRIVER_ROUNDS = 2   # each driver's Config cut to 2 rounds and one evaluation
# the count each wrapper keeps by instantiation (body, head, variant, design)
DRIVER_SPLITS = {'fused_rollout': 'launches_by_body', 'critic_values': 'launches_by_kind',
                 'offpolicy_rollout': 'launches_by_kernel', 'ppo_update': 'launches_by_head',
                 'dqn_update': 'launches_by_variant', 'ddpg_update': 'launches_by_variant',
                 'sac_update': 'launches_by_variant'}
_OFF_HEADS = ('ddpg', 'sac', 'modsac', 'dqn', 'dqn_enc', 'dqn_duel')


def driver_key(row_name):
    """The (wrapper, instantiation) of ``driver_phases``' counts that a
    kernels-line row measures, from the row's name; None for a kernel no
    driver reaches (the probes)."""
    family, _, inside = row_name.partition('[')
    parts = [p.strip() for p in inside.rstrip(']').split(',')] if inside else []
    bf = family.endswith('_bf16')
    family = family.removesuffix('_bf16')
    design = ''.join(f',{p}' for p in parts if p.startswith('streamed'))
    if family == 'fused_rollout' and len(parts) > 1 and parts[1] in _OFF_HEADS:
        family = 'offpolicy_rollout'
    if family == 'fused_rollout':
        return family, (parts[0] if parts else 'Pendulum-v1') + ',bf16' * bf + design
    if family == 'offpolicy_rollout':
        return family, f'{parts[0]},{parts[1]}' + ',bf16' * bf + design
    if family == 'critic_values':
        return family, ('bf16' if bf else 'float32') + design
    if family == 'ppo_update':
        return family, 'discrete' if parts == ['discrete'] else 'continuous'
    if family in ('dqn_update', 'ddpg_update', 'sac_update'):
        return family, parts[0]
    if family in ('gae_vtrace', 'fused_mlp3', 'buffer_gather_fields'):
        return {'buffer_gather_fields': 'buffer_gather'}.get(family, family), ''
    return None


def drivers_on_rows(kernels, driver_launches, smi):
    """Writes each instantiation's launches in ``drivers`` on the first
    kernels-line row that measures it (``drivers_launches``; 0 on the rows
    after it that measure the same instantiation at other sizes, and on the
    rows of instantiations no driver launched), names the instantiation
    (``drivers_kernel``), and prints the instantiations no row measures."""
    seen = set()
    for k in kernels:
        key = driver_key(k['name'])
        first = key is not None and key not in seen
        seen.add(key)
        k['drivers_kernel'] = None if key is None else f'{key[0]}[{key[1]}]'
        k['drivers_launches'] = driver_launches.get(key[0], {}).get(key[1], 0) if first else 0
    unmatched = {f'{f}[{i}]': n for f, split in driver_launches.items()
                 for i, n in split.items() if (f, i) not in seen}
    on_rows = sum(k['drivers_launches'] for k in kernels)
    emit(phase='drivers_rows', on_rows=on_rows, unmatched=unmatched,
         total=sum(n for split in driver_launches.values() for n in split.values()),
         nvidia_smi=smi)


def driver_phases(torch, dev, name, smi):
    """``drivers``: each entry of ``DRIVER_RUNS`` as a user calls it, its
    ``train_agent`` replaced in the module's namespace by one that takes the
    ``Config`` the driver built, cuts it to ``DRIVER_ROUNDS`` rounds and one
    evaluation (``eval_per_step`` = the rounds' env steps, ``break_step`` =
    0) and trains it; the launch counts reset just before the driver and
    read just after, and the set of kernels launched must be the entry's.
    ``plan_PaperTradingEnv_PPO`` then paper-trades its trained policy
    through its ``PolicyServer`` on localhost.  Returns the launches summed
    over every driver, by kernel instantiation: ``{family: {key: n}}``, the
    key being the wrapper's own split (``DRIVER_SPLITS``; ``''`` for a
    wrapper with one instantiation)."""
    import importlib
    from elegantrl_tpu_torch import agents
    from elegantrl_tpu_torch.ops import fused_offpolicy_update as fo
    from elegantrl_tpu_torch.ops import fused_rollout as fr
    from elegantrl_tpu_torch.ops import kernels as kn
    from elegantrl_tpu_torch.ops.fused_update import ppo_update
    from elegantrl_tpu_torch.train import runner

    # every kernel wrapper a driver can reach, by the kernels line's family
    counters = {'fused_rollout': fr.rollout, 'critic_values': fr.critic_values,
                'offpolicy_rollout': fr.offpolicy_rollout, 'ppo_update': ppo_update,
                'dqn_update': fo.dqn_chunk, 'ddpg_update': fo.ddpg_chunk,
                'sac_update': fo.sac_chunk, 'gae_vtrace': kn.gae_vtrace_kernel,
                'buffer_gather': kn.buffer_gather_fields, 'buffer_gather_one': kn.buffer_gather,
                'fused_mlp3': kn.fused_mlp3}
    splits = {k: getattr(c, DRIVER_SPLITS[k]) for k, c in counters.items()
              if k in DRIVER_SPLITS}

    def by_instantiation():
        out = {}
        for k, c in counters.items():
            if not c.launches:
                continue
            out[k] = {i: n for i, n in splits[k].items() if n} if k in splits else {'': c.launches}
            assert sum(out[k].values()) == c.launches, (k, c.launches, out[k])
        return out

    total = {}
    tmp = tempfile.mkdtemp(prefix='chip_smoke_drivers_')
    here = os.getcwd()
    os.chdir(tmp)                          # the drivers write ./<env>_<agent>_<seed>/
    try:
        for tree, file, fn, fn_args, want in DRIVER_RUNS:
            mod = load_script(tree, file)
            taken = []

            def cut(args, *a, **k):
                steps = args.num_envs * args.horizon_len * DRIVER_ROUNDS
                taken.append(dict(break_step=args.break_step, eval_per_step=args.eval_per_step))
                args.eval_per_step, args.break_step = steps, 0
                args.device = str(dev)
                return runner.train_agent(args, *a, **k)

            patched = [m for m in (mod, sys.modules.get('demo_DDPG_TD3_SAC'))
                       if m is not None and hasattr(m, 'train_agent')]
            if file == 'tutorial_helloworld_DQN_DDPG_PPO':
                patched += [importlib.import_module(f'helloworld_torch.{e}') for e in (
                    'erl_tutorial_DQN', 'erl_tutorial_PPO', 'erl_tutorial_DDPG_TD3_SAC')]
            for m in patched:
                m.train_agent = cut
            resolved = [getattr(agents, a) if isinstance(a, str) and a.startswith('Agent')
                        else a for a in fn_args]
            for c in counters.values():
                c.launches = 0
            for split in splits.values():
                split.update(dict.fromkeys(split, 0))
            t0 = time.time()
            out = getattr(mod, fn)(*resolved)
            torch.cuda.synchronize()
            secs = time.time() - t0
            launches = by_instantiation()
            for m in patched:
                m.train_agent = runner.train_agent
            result = out[1] if isinstance(out, tuple) else out
            assert len(taken) == 1, (file, fn, taken)
            assert set(launches) == want, (file, fn, fn_args, sorted(launches), sorted(want))
            for k, split in launches.items():
                for i, n in split.items():
                    total.setdefault(k, {})[i] = total.get(k, {}).get(i, 0) + n
            extra = {}
            if file == 'plan_PaperTradingEnv_PPO':
                t1 = time.time()
                extra['paper_trading'] = dict(
                    cumulative_returns=mod.paper_trade(out), seconds=round(time.time() - t1, 3),
                    days='834-1113', served_by='PolicyServer on 127.0.0.1')
                assert math.isfinite(extra['paper_trading']['cumulative_returns'])
            elif isinstance(result, dict):
                assert math.isfinite(result['max_r']), (file, fn, result['max_r'])
                extra['max_r'] = float(result['max_r'])
                extra['total_step'] = int(result['total_step'])
            emit(phase='drivers', driver=f'{tree}/{file}.py:{fn}',
                 args=list(fn_args),
                 cut=dict(rounds=DRIVER_ROUNDS, evaluations=1, **taken[0]),
                 launches=launches, seconds=round(secs, 3), **extra, device=name)
    finally:
        os.chdir(here)
        shutil.rmtree(tmp, ignore_errors=True)
    emit(phase='drivers_total', drivers=len(DRIVER_RUNS), launches=total, nvidia_smi=smi)
    return total


SAC_GRAPH_UPDATES = 8             # WARMUP eager, then the capture's replay and 4 more
SAC_GRAPH_TOL = dict(rtol=1e-5, atol=1e-6)


def sac_graph_phase(torch, dev, name, smi):
    """``helloworld_sac_graph``: the SAC single file's ``Updater`` (eager
    warm-up updates on a side stream, then one captured CUDA graph replayed
    from static ids, noise and row count) against its eager ``update``, two
    agents from the same seed given the same minibatches: the three losses
    after every update, then every parameter and Adam moment, within
    ``SAC_GRAPH_TOL``.  The row count changes every update, so a row count
    fixed at capture would show."""
    sac = load_script('helloworld_torch', 'helloworld_SAC_single_file')
    eager = sac.agent_init(torch.Generator().manual_seed(0), dev)
    graphed = sac.agent_init(torch.Generator().manual_seed(0), dev)
    ring, n, batch, h = sac.Ring(dev), sac.HP['num_envs'], sac.HP['batch'], 100
    gen = torch.Generator(device=dev).manual_seed(0)
    ring.add(torch.randn((h, n, 3), generator=gen, device=dev),
             torch.rand((h, n, 1), generator=gen, device=dev) * 2 - 1,
             torch.randn((h, n), generator=gen, device=dev),
             (torch.rand((h, n), generator=gen, device=dev) > 0.05).float())
    updater = sac.Updater(graphed, ring)

    def worst(a, b):
        err = (a - b).detach().abs()
        return float(err.max()), bool((err <= SAC_GRAPH_TOL['atol']
                                       + SAC_GRAPH_TOL['rtol'] * b.abs()).all())

    loss_err, ok = 0.0, True
    for k in range(SAC_GRAPH_UPDATES):
        rows = h - 1 - 7 * k
        ids = torch.randint(0, rows * n, (batch,), generator=gen, device=dev)
        noise = torch.randn((2, batch, 1), generator=gen, device=dev)
        want = torch.stack(sac.update(eager, *ring.gather(ids, rows), noise[0], noise[1]))
        updater(ids, rows, noise)
        e, o = worst(torch.stack(updater.losses), want)
        loss_err, ok = max(loss_err, e), ok and o
    torch.cuda.synchronize()
    param_err = 0.0
    for ma, mb in ((eager.actor, graphed.actor), (eager.critic, graphed.critic),
                   (eager.critic_tgt, graphed.critic_tgt)):
        for pg, pe in zip(mb.parameters(), ma.parameters()):
            e, o = worst(pg, pe)
            param_err, ok = max(param_err, e), ok and o
    e, o = worst(graphed.alpha_log, eager.alpha_log)
    param_err, ok = max(param_err, e), ok and o
    moment_err = 0.0
    for og, oe in ((graphed.a_opt, eager.a_opt), (graphed.c_opt, eager.c_opt),
                   (graphed.al_opt, eager.al_opt)):
        for pg, pe in zip(og.param_groups[0]['params'], oe.param_groups[0]['params']):
            for f in ('exp_avg', 'exp_avg_sq'):
                e, o = worst(og.state[pg][f], oe.state[pe][f])
                moment_err, ok = max(moment_err, e), ok and o
    emit(phase='helloworld_sac_graph', updates=SAC_GRAPH_UPDATES,
         replays=SAC_GRAPH_UPDATES - sac.Updater.WARMUP, captured=updater.graph is not None,
         loss_max_abs_err=loss_err, param_max_abs_err=param_err,
         adam_moment_max_abs_err=moment_err, tol=SAC_GRAPH_TOL, device=name, nvidia_smi=smi)
    assert updater.graph is not None and ok, (loss_err, param_err, moment_err)


def start_single_files():
    """``helloworld_learns``: the four single files as child processes on the
    card (each its own CUDA context), each timed from its start to its exit
    by a waiting thread."""
    import threading
    root = os.path.dirname(os.path.abspath(__file__))
    runs = {}
    for algo in ('DQN', 'PPO', 'REINFORCE', 'SAC'):
        out = tempfile.TemporaryFile(mode='w+')
        path = os.path.join(root, 'helloworld_torch', f'helloworld_{algo}_single_file.py')
        proc = subprocess.Popen([sys.executable, path], stdout=out, stderr=subprocess.STDOUT,
                                cwd=root)
        run = dict(proc=proc, out=out, t0=time.time(), t1=None)
        threading.Thread(target=lambda r=run: (r['proc'].wait(), r.__setitem__('t1', time.time())),
                         daemon=True).start()
        runs[algo] = run
    return runs


def finish_single_files(runs, name, smi, timeout_s):
    """Waits for the four single files (killing any left at ``timeout_s``
    from its start).  Each must end in its own learning assert: passed (exit
    0, its last line the file's summary) or missed (its ``failed to learn``
    assertion, reported as a miss, as a learning row's miss is); a crash or
    a kill fails the phase."""
    try:
        for algo, r in runs.items():
            try:
                r['proc'].wait(timeout=max(1.0, r['t0'] + timeout_s - time.time()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for r in runs.values():
            if r['proc'].poll() is None:
                r['proc'].kill()
                r['proc'].wait()
    failed = []
    for algo, r in runs.items():
        r['out'].seek(0)
        lines = r['out'].read().splitlines()
        avg = [float(ln.split('avgR')[1].split()[0]) for ln in lines if 'avgR' in ln]
        rc = r['proc'].returncode
        last = lines[-1] if lines else ''
        learned = rc == 0 and last.startswith('helloworld')
        missed = rc == 1 and last.startswith('AssertionError') and 'failed to learn' in last
        emit(phase='helloworld_learns', file=f'helloworld_torch/helloworld_{algo}_single_file.py',
             rc=rc, learned=learned, seconds=round((r['t1'] or time.time()) - r['t0'], 2),
             avgR=avg, last_line=last, device=name, nvidia_smi=smi)
        if not (learned or missed):
            failed.append((algo, rc, lines[-6:]))
    assert not failed, failed


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
        PENDULUM_BODY, ROLLOUT_CLUSTERS, ROLLOUT_LEVELS, STREAM_LANES, STREAMED, noise_rows,
        rollout,
        rollout_fits, rollout_fits_resident, rollout_group_lanes, rollout_level,
        rollout_reference, _design_tag, _library as fr_lib, rollout_smem_bytes as fr_smem)
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
         hbm_tb_s=peak_tbs, tf32_tflops=H100_TF32_TFLOPS, bf16_tflops=H100_BF16_TFLOPS)
    dev = torch.device('cuda')

    def bound(flop, nbytes, tflops=None):
        """The least time, ms, and what bounds it: ``flop`` at ``tflops``
        (the FP32 CUDA-core rate unless given) or ``nbytes`` at the HBM
        rate."""
        t_ops = flop / ((tflops or peak_tflops) * 1e12)
        t_bytes = nbytes / (peak_tbs * 1e12)
        return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops >= t_bytes else 'bytes')

    # ---- 2. build
    t0 = time.time()
    logs = _cuda_build.build(['onpolicy_rollout', 'offpolicy_rollout', 'onpolicy_narrow',
                              'offpolicy_narrow', 'ppo_update', 'dqn_update', 'ddpg_update',
                              'sac_update', 'kernels', 'probes'])
    ptxas = {k: [ln.strip() for ln in v.splitlines() if 'registers' in ln or 'spill' in ln]
             for k, v in logs.items()}
    # the .cu files own the shared-memory layouts; the Python copies that
    # judge eligibility on the CPU must agree with them, for every body
    smem = {'ppo_update': (fu_lib().ppo_update_smem_bytes(), PPO_SMEM_BYTES)}
    for body in KERNEL_ENV_BODIES.values():
        for dims in (NET_DIMS, (64, 64), (256, 256), (96, 160), (384, 384), (512, 512),
                     (1024, 1024), (1024, 256)):
            for c in ROLLOUT_CLUSTERS:
                for bf in (0, 1):
                    # the resident and the streamed layouts, the narrower groups
                    # from the narrow library
                    for level in range(ROLLOUT_LEVELS + 1):
                        smem[f'fused_rollout[{body.env_name},{dims},cluster={c},bf16={bf},'
                             f'level={level}]'] = (
                            fr_lib(level << 1).fused_rollout_smem_bytes(body.kernel_id, *dims, c,
                                                                        bf | level << 1),
                            fr_smem(body, dims, c, bool(bf), level))
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

    def cluster_ms(run, body, n, dims, bf=False):
        """ms of the rollout kernel at each cluster size that fits, and the
        size it picks by itself, in the design the widths take (the
        streamed one where a cluster of 8 does not hold the slices, on the
        widest lane group that fits)."""
        st = rollout_level(body, dims, bf)
        out = {str(c): cuda_ms(torch, lambda: run(c), reps=3 if st else 5)
               for c in ROLLOUT_CLUSTERS if fr_smem(body, dims, c, bf, st) <= 232448}
        out['picked'] = fr_lib(st << 1).fused_rollout_cluster(body.kernel_id, n, *dims, 0,
                                                              int(bf) | st << 1)
        return out

    def stream_bytes(body, dims, h, bf=False):
        """The streamed design's weight stream: both nets' W2 read from L2 by
        every lane group at every step."""
        lanes = rollout_group_lanes(body, dims, bf)
        return 2 * (N // lanes) * h * dims[0] * dims[1] * (2 if bf else 4)

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

    def check_body(body, env_class, dims=NET_DIMS, phase='k3_vs_plain', cluster_envs=(N, 1024)):
        S, A = body.state_dim, body.action_dim
        streamed = not rollout_fits_resident(body, dims)
        tag = f'fused_rollout[{body.env_name},{"categorical" if body.discrete else "gaussian"}]'
        if streamed:
            design = _design_tag(rollout_level(body, dims) << 1, STREAM_LANES)
            tag = tag[:-1] + f',{dims}{design}]'
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
                     reps=5 if streamed else 20, warmup=2)
        plain_ms = cuda_ms(torch, lambda: rollout_reference(*net, f0, i0, horizon_len=H,
                                                            seed=seed, **bkw), reps=2)
        b_ms, b_by = rollout_bound(body, s.act_flat.numel() + s.cri_flat.numel(), dims)
        # the time at each cluster size, at 4096 envs and at the 1024 of the
        # train_agent runs below
        by_c = {n: cluster_ms(lambda c: rollout(*net, f0[:, :n].contiguous(),
                                                i0[:, :n].contiguous(), horizon_len=H,
                                                seed=seed, cluster=c, **bkw), body, n, dims)
                for n in cluster_envs}
        extra = {}
        if streamed:
            extra['stream_bytes'] = stream_bytes(body, dims, H)
        emit(phase=phase, kernel=tag, net_dims=dims, trajectory=report, one_step=one,
             one_step_threshold_flips=n_flip, two_runs_bitwise=True, ms=ms, plain_ms=plain_ms,
             bound_ms=b_ms, bound_by=b_by, cluster_ms=by_c, **extra,
             tolerance={'trajectory': 2e-2, 'share_parted': 0.01, 'one_step': 1e-4,
                        'threshold_flips': 8})
        return dict(name=tag, ms=ms, plain_ms=plain_ms, max_abs_err=max(one.values()),
                    bound_ms=b_ms, bound_by=b_by, cluster_ms=by_c, **extra)

    k3 = {body.env_name: check_body(body, env_class) for body, env_class in (
        (CARTPOLE_BODY, CartPoleEnv), (HOPPER_BODY, HopperEnv),
        (CHASING_BODY, PointChasingVecEnv), (CHASING_DISCRETE_BODY, PointChasingDiscreteEnv))}
    # K1 and K3 at (256, 256): widths the JAX runner takes its kernel at, which
    # the first design refused (both nets in one block); the same checks
    k13_wide = {body.env_name: check_body(body, env_class, (256, 256), 'k13_vs_plain_wide')
                for body, env_class in ((PENDULUM_BODY, PendulumEnv),
                                        (CARTPOLE_BODY, CartPoleEnv))}
    # K1 and K3 past what a cluster of 8 holds, (384, 384) and (1024, 1024):
    # the streamed design (both nets' W2 read from the stream_weights copy in
    # device memory, 16-lane groups), the same checks and tolerances, its
    # time at each cluster size at the main path's 4096 envs
    k13_streamed = {(body.env_name, dims): check_body(body, env_class, dims,
                                                      'k13_vs_plain_streamed', (N,))
                    for body, env_class in ((PENDULUM_BODY, PendulumEnv),
                                            (CARTPOLE_BODY, CartPoleEnv))
                    for dims in ((384, 384), (1024, 1024))}
    # K1 past its 16-lane groups' widest width (1408 in float32): the
    # streamed design on 8-lane groups at (1536, 1536), the same checks
    assert rollout_group_lanes(PENDULUM_BODY, (1536, 1536)) == 8
    k13_narrow = check_body(PENDULUM_BODY, PendulumEnv, (1536, 1536), 'k13_vs_plain_narrow',
                            (N,))

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

    # ---- 7c. the bf16 variants of K1/K3 (bf16 weight slices and tiles, f32
    # sums) against the plain version in bf16, both storage types: Pendulum
    # and CartPole at (128, 128), ppo_pendulum_bf16's (128, 64) at H = 128,
    # and both at (512, 512), the first width at which 'auto' takes bf16 and
    # the widest the float32 kernel's cluster of 8 could not hold; then the
    # float32 kernel with bf16 storage (the obs rounded before acting, bf16
    # states) on every body at the main paths' (128, 128).  Tolerances
    # (BF16_TOL) and their reason as for k6_bf16_vs_plain; two runs bitwise
    # equal in both noise modes.  The control (bf16 compute): the float32
    # kernel on the same one-step inputs against the bf16 plain version must
    # break them (values and log-probabilities carry the net's outputs).
    bfr = torch.bfloat16

    def as_f32(out):
        return out._replace(states=out.states.float())

    def one_step_reduced(o1, w1, samples):
        o1, w1 = as_f32(o1), as_f32(w1)
        flip, sample = fields_differ(o1, w1, float('inf'))
        flip = (flip[0] | (o1.env_i != w1.env_i).any(0)
                | ((o1.env_f - w1.env_f).abs().amax(0) > 0.25))
        sample = torch.maximum(sample[0], (o1.env_f - w1.env_f).abs().amax(0))[~flip]
        one = dict(max_abs=float(sample.max()),
                   share_over_1e4=float((sample > 1e-4).float().mean()), flips=int(flip.sum()))
        one['within'] = (one['flips'] <= BF16_TOL['flip_share'] * samples
                         and one['max_abs'] <= BF16_TOL['one_step']
                         and one['share_over_1e4'] <= BF16_TOL['share_over_1e4'])
        return one

    def check_reduced(body, env_class, dims, compute, store, h, phase):
        s = body_state(body, dims)
        g = torch.Generator(device=dev).manual_seed(23)
        env_def = env_class(num_envs=1)._def
        f0, _ = body.pack(env_def.init(g, N, dev))
        i0 = (torch.arange(N, device=dev, dtype=torch.int32) * 37 % env_def.spec.max_step)[None]
        f0, i0 = f0.contiguous(), i0.contiguous()
        nz = body_noise(body, g, h, N)
        net = (s.act_flat, s.cri_flat, s.norm_avg, s.norm_std)
        bkw = dict(net_dims=dims, reward_scale=1.0, body=body, compute_dtype=compute,
                   store_dtype=bfr if store else None)
        streamed = not rollout_fits_resident(body, dims, compute is not None)
        tag = (f'fused_rollout{"_bf16" if compute else ""}[{body.env_name},{dims},H={h},'
               f'store={"bf16" if store else "f32"}{",streamed" if streamed else ""}]')
        report = {}
        for mode, extra in (('injected', dict(noise=nz)), ('philox', dict(seed=seed))):
            trace = []
            got = rollout(*net, f0, i0, horizon_len=h, **bkw, **extra)
            again = rollout(*net, f0, i0, horizon_len=h, **bkw, **extra)
            want = rollout_reference(*net, f0, i0, horizon_len=h, env_trace=trace, **bkw,
                                     **extra)
            torch.cuda.synchronize()
            assert same_runs(got, again), (tag, mode, 'two runs differ')
            assert got.states.dtype == (bfr if store else torch.float32), tag
            differ, worst = fields_differ(as_f32(got), as_f32(want), BF16_TOL['trajectory'])
            parted = differ.any(0)
            assert int(parted.sum()) <= max(1, int(BF16_TOL['share_parted'] * N)), (
                tag, mode, int(parted.sum()))
            assert float(worst[:, ~parted].max()) <= BF16_TOL['trajectory'], (tag, mode)
            report[mode] = dict(lanes_parted=int(parted.sum()),
                                max_abs_diff_kept=float(worst[:, ~parted].max()))
            if mode == 'injected':
                f_all = torch.cat([f for f, _ in trace], dim=1).contiguous()
                i_all = torch.cat([i for _, i in trace], dim=1).contiguous()
        nz_all = nz.transpose(0, 1).reshape(1, noise_rows(body), h * N).contiguous()
        w1 = rollout_reference(*net, f_all, i_all, horizon_len=1, noise=nz_all, **bkw)
        one = one_step_reduced(rollout(*net, f_all, i_all, horizon_len=1, noise=nz_all, **bkw),
                               w1, h * N)
        assert one['within'], (tag, one)
        res = dict(name=tag, trajectory=report, one_step=one, max_abs_err=one['max_abs'],
                   lanes_parted=max(r['lanes_parted'] for r in report.values()))
        if compute is not None:
            # at a width the float32 kernel does not take, (512, 512), the
            # float32 plain version stands in for it (they agree to 1e-4)
            f32_fn = rollout if rollout_fits(body, dims) else rollout_reference
            control = one_step_reduced(f32_fn(*net, f_all, i_all, horizon_len=1, noise=nz_all,
                                              **dict(bkw, compute_dtype=None)), w1, h * N)
            assert not control['within'], ('the f32 rollout passed BF16_TOL', tag, control)
            res['control_f32_' + ('kernel' if f32_fn is rollout else 'plain')] = control
        ms = cuda_ms(torch, lambda: rollout(*net, f0, i0, horizon_len=h, seed=seed, **bkw),
                     reps=10, warmup=2)
        plain_ms = cuda_ms(torch, lambda: rollout_reference(*net, f0, i0, horizon_len=h,
                                                            seed=seed, **bkw), reps=1)
        S, A = body.state_dim, body.action_dim
        d1, d2 = dims
        # both nets an env-step: the bf16 variant's products at the dense
        # bf16 tensor rate (bound_ms), and at the FP32 CUDA-core rate where
        # this kernel widens them (bound_ms_fp32)
        flop = 2 * (2 * (S * d1 + d1 * d2) + d2 * (A + 1)) * N * h
        nbytes = (4 * (s.act_flat.numel() + s.cri_flat.numel()) + 8 * (body.n_f32 + 1) * N
                  + N * h * ((2 if store else 4) * S + 4 * ((1 if body.discrete else A) + 5)))
        b_ms, b_by = bound(flop, nbytes, H100_BF16_TFLOPS if compute is not None else None)
        variant = int(compute is not None) | (STREAMED if streamed else 0)
        picked = fr_lib().fused_rollout_cluster(body.kernel_id, N, *dims, 0, variant)
        res.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, cluster=picked,
                   smem_bytes=fr_lib().fused_rollout_smem_bytes(body.kernel_id, *dims, picked,
                                                                variant))
        if streamed:
            res['stream_bytes'] = stream_bytes(body, dims, h, compute is not None)
        if compute is not None:
            res['bound_ms_fp32'] = bound(flop, nbytes)[0]
        emit(phase=phase, kernel=tag, envs=N, horizon=h, net_dims=dims,
             two_runs_bitwise_equal=True, **res, tolerance=BF16_TOL, device=name,
             nvidia_smi=smi)
        return res

    k1_bf16 = {(dims, h, store): check_reduced(PENDULUM_BODY, PendulumEnv, dims, bfr, store, h,
                                               'k1_bf16_vs_plain')
               for dims, h, store in (((128, 128), H, False), ((128, 128), H, True),
                                      ((128, 64), 128, False), ((512, 512), H, False))}
    k3_bf16 = {(dims, h, store): check_reduced(CARTPOLE_BODY, CartPoleEnv, dims, bfr, store, h,
                                               'k3_bf16_vs_plain')
               for dims, h, store in (((128, 128), H, False), ((128, 128), H, True),
                                      ((512, 512), H, True))}
    # the bf16 variant of the streamed design at (1024, 1024), on K1 and K3
    k13_bf16_streamed = {body.env_name: check_reduced(body, env_class, (1024, 1024), bfr, False,
                                                      H, 'k13_bf16_vs_plain_streamed')
                         for body, env_class in ((PENDULUM_BODY, PendulumEnv),
                                                 (CARTPOLE_BODY, CartPoleEnv))}
    k13_store_bf16 = {body.env_name: check_reduced(
        body, env_class, NET_DIMS, None, True, H,
        'k1_store_bf16_vs_plain' if body is PENDULUM_BODY else 'k3_store_bf16_vs_plain')
        for body, env_class in ((PENDULUM_BODY, PendulumEnv), (CARTPOLE_BODY, CartPoleEnv),
                                (HOPPER_BODY, HopperEnv), (CHASING_BODY, PointChasingVecEnv),
                                (CHASING_DISCRETE_BODY, PointChasingDiscreteEnv))}

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

    def timed_rounds(task, body, head, phase, kernel_ms, updates=ROUNDS, **hyper):
        """10 timed rounds; ``updates``: K2's launches in them (0 where the
        JAX package runs its scan, and the port autograd)."""
        a = bench_args(task, NUM_ENVS, HORIZON, BATCH)
        for k, v in hyper.items():
            setattr(a, k, v)
        dims = tuple(a.net_dims)
        # the rollout kernel's count: the streamed design's past what a
        # cluster of 8 holds, on the lane groups it takes (float32 here)
        tag = body.env_name + _design_tag(rollout_level(body, dims) << 1, STREAM_LANES)
        ctx = build_training(a)
        carry, _ = ctx.round_fn(ctx.carry)                      # warm-up round
        p0 = [carry.agent_state.act_flat.clone(), carry.agent_state.cri_flat.clone()]
        torch.cuda.synchronize()
        reset_counts()
        kn_ops.gae_vtrace_kernel.launches = 0
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
        launches = {'fused_rollout': by_body.get(tag, 0), 'ppo_update': by_head[head]}
        round_ms = start.elapsed_time(end) / ROUNDS
        mvals = torch.stack(metrics).cpu()
        moved = max(float((carry.agent_state.act_flat - p0[0]).abs().max()),
                    float((carry.agent_state.cri_flat - p0[1]).abs().max()))
        assert launches == {'fused_rollout': ROUNDS, 'ppo_update': updates}, launches
        assert rollout.launches == ROUNDS and ppo_update.launches == updates
        assert kn_ops.gae_vtrace_kernel.launches == ROUNDS
        assert bool(torch.isfinite(mvals).all()), mvals
        assert moved > 0.0
        emit(phase=phase, agent=task[0].__name__, env=task[2], envs=NUM_ENVS, horizon=HORIZON,
             batch=BATCH, repeat=a.repeat_times, net_dims=dims, rounds=ROUNDS, launches=launches,
             gae_vtrace_launches=kn_ops.gae_vtrace_kernel.launches,
             round_ms=round_ms, env_steps_per_s=NUM_ENVS * HORIZON / (round_ms / 1e3),
             **kernel_ms, metrics=dict(zip(sorted(m), mvals[-1].tolist())),
             max_param_change=moved, device=name, nvidia_smi=smi)
        return launches

    small_round_vs_cpu(pendulum, PENDULUM_BODY, 'main_path_small_vs_cpu')
    from elegantrl_tpu_torch.ops import kernels as kn_ops

    # on the card nothing falls back to a plain version where the JAX package
    # takes a kernel: asking for the plain version, or a workload that the
    # JAX package sends to its kernel and this kernel does not fit, raises
    # (at (8228, 8228), bf16 under 'auto', past even the streamed design's
    # narrowest lane groups' widest width, 8224).  Where
    # the JAX package runs XLA ops the card runs PyTorch ops and says so: A2C's
    # update (no kernel in either package), and both halves of a 3-hidden-layer
    # PPO (the generic rollout and the autograd update).
    import contextlib
    import io
    refused = {}
    for task in (pendulum, cartpole):
        for flag, setting in (('use_fused_rollout', ('use_fused_rollout', False)),
                              ('use_fused_rollout', ('net_dims', (8228, 8228))),
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

    # ---- 9a. the main path past what a cluster of 8 holds: PPO on Pendulum at
    # (384, 384) in float32 at the bench's shape, the streamed K1, K10 and K2
    # (which takes these widths) each once a round, 10 rounds
    launches_wide_f32 = timed_rounds(
        pendulum, PENDULUM_BODY, 'continuous', 'main_path_wide_f32', dict(
            fused_rollout_ms=k13_streamed[('Pendulum-v1', (384, 384))]['ms']),
        net_dims=(384, 384), compute_dtype='float32')
    # PPO on Pendulum at (1536, 1536) in float32 at the bench's shape but
    # repeat 1 (512 SGD steps a round, not 4096): K1 on 8-lane streamed
    # groups and K10 once a round, the autograd update (the JAX package's
    # fused update does not fit its VMEM budget there)
    launches_narrow = timed_rounds(
        pendulum, PENDULUM_BODY, 'continuous', 'main_path_narrow', dict(
            fused_rollout_ms=k13_narrow['ms']), updates=0,
        net_dims=(1536, 1536), compute_dtype='float32', repeat_times=1.0)

    # ---- 9b. the bf16 main paths: ppo_pendulum_bf16's shape (4096 envs, H
    # 128, B 4096, (128, 64), bf16 compute, its repeat 512: 16 updates a
    # round), DiscretePPO on CartPole at the bench's shape with bf16 compute
    # and storage, and PPO on Pendulum at (512, 512) with the default
    # compute_dtype 'auto' (bf16 there).  Each: the K1/K3 bf16 variant once a
    # round, K10 once a round, the autograd update (no K2: the JAX package
    # runs its scan under bf16) and the no-grad forwards on PyTorch ops (no
    # K11b: it has no bf16 variant), 10 timed rounds with the counts reset
    # just before them.  Past the widest bf16 width the card raises, naming it.
    def timed_bf16(task, phase, num_envs, horizon, batch, **hyper):
        a = bench_args(task, num_envs, horizon, batch)
        for k, v in hyper.items():
            setattr(a, k, v)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            ctx = build_training(a)
        said = text.getvalue()
        assert ctx.fused_rollout and 'use_fused_update: PyTorch path' in said, said
        assert 'use_mlp3_kernel: PyTorch path' in said, said
        carry, _ = ctx.round_fn(ctx.carry)                      # warm-up round
        p0 = [carry.agent_state.act_flat.clone(), carry.agent_state.cri_flat.clone()]
        torch.cuda.synchronize()
        reset_counts()
        kn_ops.gae_vtrace_kernel.launches = kn_ops.fused_mlp3.launches = 0
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
        launches = {'fused_rollout': by_body, 'ppo_update': sum(by_head.values()),
                    'gae_vtrace': kn_ops.gae_vtrace_kernel.launches,
                    'fused_mlp3': kn_ops.fused_mlp3.launches}
        round_ms = start.elapsed_time(end) / ROUNDS
        mvals = torch.stack(metrics).cpu()
        moved = max(float((carry.agent_state.act_flat - p0[0]).abs().max()),
                    float((carry.agent_state.cri_flat - p0[1]).abs().max()))
        want = {'fused_rollout': {f'{task[2]},bf16': ROUNDS}, 'ppo_update': 0,
                'gae_vtrace': ROUNDS, 'fused_mlp3': 0}
        assert launches == want, (phase, launches)
        assert bool(torch.isfinite(mvals).all()), mvals
        assert moved > 0.0
        if a.storage_dtype == 'bfloat16':
            assert carry.obs.dtype == torch.float32
        emit(phase=phase, agent=task[0].__name__, env=task[2], envs=num_envs, horizon=horizon,
             batch=batch, repeat=a.repeat_times, net_dims=tuple(a.net_dims),
             compute_dtype=a.compute_dtype, storage_dtype=a.storage_dtype, rounds=ROUNDS,
             launches=launches, round_ms=round_ms,
             env_steps_per_s=num_envs * horizon / (round_ms / 1e3),
             metrics=dict(zip(sorted(m), mvals[-1].tolist())), max_param_change=moved,
             device=name, nvidia_smi=smi)
        return launches

    launches_bf16 = timed_bf16(pendulum, 'main_path_bf16', NUM_ENVS, 128, 4096,
                               net_dims=(128, 64), compute_dtype='bfloat16', repeat_times=512,
                               gamma=0.97, learning_rate=1e-3)
    launches_cart_bf16 = timed_bf16(cartpole, 'main_path_cartpole_bf16_storage', NUM_ENVS,
                                    HORIZON, BATCH, compute_dtype='bfloat16',
                                    storage_dtype='bfloat16')
    launches_wide = timed_bf16(pendulum, 'main_path_wide_auto', NUM_ENVS, HORIZON, BATCH,
                               net_dims=(512, 512))
    too_wide = bench_args(pendulum, 256, 32, 128)
    too_wide.net_dims = (8228, 8228)
    try:
        build_training(too_wide)
        raise AssertionError('the card took a bf16 rollout past the widest width')
    except ValueError as e:
        assert 'up to 8224 on Pendulum-v1 in bf16' in str(e), e
        emit(phase='bf16_width_limit', net_dims=(8228, 8228), raised=str(e)[:300])

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

    # ---- 13b. K4's bf16 variants, the host-env, Isaac and pixel main paths
    bf16_host_pixel_kernels = bf16_host_pixel_phases(torch, dev, name, smi, bound, seed)

    # ---- 14. LunarLander (K10, K11a, K11b; K2 and K9 at the slice's widths)
    lunar_kernels = lunar_phases(torch, dev, name, smi, bound, k2_lunar, k9_lunar)

    # ---- 15. the Mosaic probes
    probe_kernels = probe_phases(torch, dev, bound)

    # ---- 15b. parallel/: the sharded rollouts, dp = 2, populations, NCCL, mesh entry point
    sharded = parallel_phases(torch, dev, name, smi, bound)

    # ---- 15c. marl/: every multi-agent trainer on the card
    marl_phases(torch, dev, name, smi)

    # ---- 15d. rlsolver/: the MaxCut core on the 800-node instances, PPO on node flips
    rlsolver_kernels, _ = rlsolver_phases(torch, dev, name, smi, bound)

    # ---- 15e. serve.py (K11b on the served path) and utils/profiling.py
    serve_kernels, _ = serve_profiling_phases(torch, dev, name, smi, bound)

    # ---- 15f. rlsolver/'s other problems and its learned solvers
    rlsolver_more_phases(torch, dev, name, smi)

    # ---- 15g. rlsolver/vrp.py and tnco.py; then the drivers of helloworld_torch/
    # and examples_torch/, the four single files learning beside them in child
    # processes of their own (SAC's, the longest, sets the phase's time)
    vrp_tnco_phases(torch, dev, name, smi)
    sac_graph_phase(torch, dev, name, smi)
    single_files = start_single_files()
    try:
        driver_launches = driver_phases(torch, dev, name, smi)
    finally:
        finish_single_files(single_files, name, smi, timeout_s=420)

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
    # the bf16 variants of K1/K3 (one instantiation per body): one entry per
    # main path, each with that path's launches and the check at its shape
    # (Pendulum: main_path_bf16 at (128, 64) x 128 steps and
    # main_path_wide_auto at (512, 512); CartPole:
    # main_path_cartpole_bf16_storage); every check rides along
    for body_name, checks, n, key in (
            ('Pendulum-v1', k1_bf16, launches_bf16['fused_rollout']['Pendulum-v1,bf16'],
             ((128, 64), 128, False)),
            ('Pendulum-v1', k1_bf16, launches_wide['fused_rollout']['Pendulum-v1,bf16'],
             ((512, 512), H, False)),
            ('CartPole-v1', k3_bf16, launches_cart_bf16['fused_rollout']['CartPole-v1,bf16'],
             ((128, 128), H, True))):
        k = checks[key]
        kernels.append({'name': k['name'], 'route': 'cuda', 'source': rollout_src,
                        'replaces': 'elegantrl_tpu/ops/pallas_rollout.py:600', 'launches': n,
                        'max_abs_err': k['max_abs_err'], 'ms': k['ms'], 'plain_ms': k['plain_ms'],
                        'bound_ms': k['bound_ms'], 'bound_by': k['bound_by'],
                        'bound_ms_fp32': k['bound_ms_fp32'], 'library_ms': None,
                        'checks': {c['name']: {f: c[f] for f in (
                            'ms', 'plain_ms', 'bound_ms', 'bound_ms_fp32', 'max_abs_err',
                            'cluster', 'lanes_parted')} for c in checks.values()}})
    # the streamed design of K1/K3 (fused_rollout_kernel<Body, BF, true>): its
    # entry is main_path_wide_f32's (Pendulum at (384, 384)); every streamed
    # check, float32 and bf16, rides along
    k = k13_streamed[('Pendulum-v1', (384, 384))]
    kernels.append({'name': k['name'], 'route': 'cuda', 'source': rollout_src,
                    'replaces': 'elegantrl_tpu/ops/pallas_rollout.py:600',
                    'launches': launches_wide_f32['fused_rollout'],
                    'max_abs_err': k['max_abs_err'], 'ms': k['ms'], 'plain_ms': k['plain_ms'],
                    'bound_ms': k['bound_ms'], 'bound_by': k['bound_by'], 'library_ms': None,
                    'cluster_ms': k['cluster_ms'], 'stream_bytes': k['stream_bytes'],
                    'checks': {c['name']: {f: c.get(f) for f in (
                        'ms', 'plain_ms', 'bound_ms', 'bound_by', 'bound_ms_fp32',
                        'max_abs_err', 'stream_bytes')}
                        for c in list(k13_streamed.values()) + list(k13_bf16_streamed.values())}})
    # its 8-lane groups (the same kernel, ST 2): main_path_narrow's
    # launches at (1536, 1536)
    k = k13_narrow
    kernels.append({'name': k['name'], 'route': 'cuda', 'source': rollout_src,
                    'replaces': 'elegantrl_tpu/ops/pallas_rollout.py:600',
                    'launches': launches_narrow['fused_rollout'],
                    'max_abs_err': k['max_abs_err'], 'ms': k['ms'], 'plain_ms': k['plain_ms'],
                    'bound_ms': k['bound_ms'], 'bound_by': k['bound_by'], 'library_ms': None,
                    'cluster_ms': k['cluster_ms'], 'stream_bytes': k['stream_bytes'],
                    'lanes': rollout_group_lanes(PENDULUM_BODY, (1536, 1536))})
    # the float32 kernel's bf16-storage checks ride with its entries
    for k in kernels:
        for env_name, c in k13_store_bf16.items():
            if k['name'] in (f'fused_rollout[{env_name},gaussian]',
                             f'fused_rollout[{env_name},categorical]') or (
                    env_name == 'Pendulum-v1' and k['name'] == 'fused_rollout'):
                k['store_bf16'] = {f: c[f] for f in ('name', 'ms', 'plain_ms', 'bound_ms',
                                                     'max_abs_err', 'lanes_parted')}
    kernels += (offpolicy_kernels + stock_kernels + bf16_host_pixel_kernels + lunar_kernels
                + probe_kernels + rlsolver_kernels + serve_kernels)
    # each instantiation's launches in the drivers phase, on its row
    drivers_on_rows(kernels, driver_launches, smi)
    # the sharded wrappers' per-shard launches ride with the kernel they launch
    for k in kernels:
        if k['name'] in sharded:
            k['sharded'] = sharded.pop(k['name'])
    assert not sharded, sorted(sharded)
    assert all(k['launches'] > 0 for k in kernels), [(k['name'], k['launches']) for k in kernels]
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                             'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
