"""The host-rollout round of a host-pool env against the batched path, on the card.

    python scripts/torch_compare_host_round.py [--rounds 10] [--pairs 10]

Builds ModSAC at ``modsac_lander_host``'s shape (16 envs, horizon 64, ring
50,000 rows, batch 1024, repeat 1, reward scale 0.5, net (256, 256)) on
``chip_smoke.py``'s numpy gym-protocol lander (``HostLanderEnv``) twice:
with ``host_rollout=True`` (the default: ``round_fn`` collects the rollout
with ``host_collect_rollout``, the obs up and the actions down through a
``HostLink``'s pinned buffers once a step) and with ``host_rollout=False``
(the env's batched ``step``: an unpinned copy of the actions down and four
copies up a step).  After two warm-up rounds each, it runs ``--pairs``
pairs, each timing ``--rounds`` rounds of both (CUDA events), the side
that goes first alternating from pair to pair, then three more rounds of
each under the profiler, and prints one JSON line: the round times of
every pair, their medians and quartiles, the pairs the host round won,
and per side the profiled round time, the device-busy time, the idle
share and the device events a round, with the card's name and power
limit.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--rounds', type=int, default=10)
    p.add_argument('--pairs', type=int, default=10)
    args = p.parse_args()
    rounds = args.rounds

    import torch
    if not torch.cuda.is_available():
        sys.exit('torch_compare_host_round: this needs a CUDA card')
    import chip_smoke as cs
    from elegantrl_tpu_torch import Config, build_training
    from elegantrl_tpu_torch.agents import AgentModSAC
    from elegantrl_tpu_torch.envs import make_host_env
    from elegantrl_tpu_torch.envs.base import EnvSpec

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    P = cs.MODSAC_HOST
    spec = EnvSpec('HostLander-v0', P['envs'], 1000, 8, 2, False)

    def round_step(host_rollout):
        env = make_host_env(cs.HostLanderEnv, spec, seed=0)
        a = Config(AgentModSAC, env, {'env_name': 'HostLander-v0', 'num_envs': P['envs'],
                                      'max_step': 1000, 'state_dim': 8, 'action_dim': 2,
                                      'if_discrete': False})
        a.net_dims, a.horizon_len = P['net'], P['horizon']
        a.buffer_size, a.batch_size = P['buffer'], P['batch']
        a.repeat_times, a.learning_rate = P['repeat'], P['lr']
        a.reward_scale, a.gamma, a.random_seed = P['reward_scale'], 0.99, 0
        a.host_rollout = host_rollout
        ctx = build_training(a)
        assert ctx.use_host_rollout == host_rollout
        box = [ctx.carry]

        def step():
            box[0], _ = ctx.round_fn(box[0])
        for _ in range(2):        # warm-up; the first fills the ring past one batch
            step()
        torch.cuda.synchronize()
        return step

    steps = {'batched': round_step(False), 'host': round_step(True)}

    def timed(step):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(rounds):
            step()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / rounds

    pairs = []
    for k in range(args.pairs):
        order = ('batched', 'host') if k % 2 == 0 else ('host', 'batched')
        pairs.append({kind: timed(steps[kind]) for kind in order})
    out = {}
    for kind, step in steps.items():
        ms = np.array([pr[kind] for pr in pairs])
        host_ms, busy_ms, idle, events = cs.profiled_rounds(torch, step, 3)
        out[kind] = dict(median_ms=float(np.median(ms)),
                         quartiles_ms=[float(q) for q in np.percentile(ms, [25, 75])],
                         profiled_round_ms=host_ms, device_busy_ms=busy_ms, idle_share=idle,
                         device_events_per_round=events)
    print(json.dumps(dict(path='modsac_lander_host', rounds=rounds, pairs=pairs,
                          host_won=sum(pr['host'] < pr['batched'] for pr in pairs), **out,
                          device=torch.cuda.get_device_name(0), nvidia_smi=smi)), flush=True)


if __name__ == '__main__':
    main()
