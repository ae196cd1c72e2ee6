"""Training loop (counterpart of ``elegantrl_tpu/train/runner.py``).

One on-policy round is: rollout (the fused rollout kernel; on the CPU its
plain version, or the generic ``collect_rollout`` loop outside the kernel's
scope) -> truncation bootstrap and GAE -> minibatch gather -> update (PPO:
the fused update kernel, its plain version on the CPU; A2C: autograd, as
the JAX package has no kernel for it).  One off-policy round is: rollout
(the off-policy heads of the fused rollout kernel, or ``collect_rollout``
where the JAX package runs its scan) -> insert into the replay ring buffer
(``train/replay_buffer.py``, on the run's device; before it the agent's
``pre_update`` hook, the H-term window harvest; after it the
cumulative-return column when ``lambda_fit_cum_r != 0``) -> ``agent.update``
on the buffer (the fused update chunks or the scan path, ``agents/dqn.py``,
``agents/ddpg_td3.py``, ``agents/sac.py``, ``agents/embed_dqn.py``).
``train_agent`` runs rounds on the host, evaluates every
``eval_per_step`` env steps (on ``eval_env_class`` where given), stops at
``break_step``, ``break_score`` or a ``{cwd}/stop`` file, and saves
``agent.npz``, ``recorder.npy``, ``LearningCurve.jpg`` and
``train_carry.npz`` (the whole carry: agent state with its H-term ring,
replay buffer with its PER tree and cumulative-return column, env state,
observations and generator; ``continue_train`` resumes it; off-policy only
when the run is resumable, and then also every ``save_gap`` evaluation
periods) and, with ``if_save_buffer``, ``replay_buffer.npz``.

The agent state's parameters are updated in place (flat buffers), so a
carry handed to ``round_fn`` shares its parameters with the one returned.
``train_agent_single_process``, ``train_agent_multiprocessing`` and
``train_agent_multiprocessing_multi_gpu`` are aliases of ``train_agent``;
``valid_agent`` (``render_agent``) plays a saved agent's greedy episodes.

Host envs (``EnvDef.host_pool``: gymnasium pools, ``envs/host_env.py``;
external batched sims, ``envs/isaac.py``) train in host-rollout mode,
decided once in ``build_training`` (``args.host_rollout``, default True): a
round (``round_fn``) collects its rollout on the pool
(``host_collect_rollout``: the actor on the run's device, the pool stepped
on the host) and then runs the update half (for a rollout collected
elsewhere, ``TrainContext.update_from_rollout``); the evaluator plays its
episodes on its own pool (``env.fresh()``).  With ``args.host_rollout =
False`` both go through the env's batched ``init``/``step`` instead.

Under a mesh (``build_training(args, mesh=)``; ``train_agent`` makes it from
``args.mesh_axes``, ``parallel/mesh.py``) the env state and obs of the carry
are split over the shards: the fused rollout launches its kernel once per
shard (``make_sharded_fused_rollout``, ``make_sharded_offpolicy_rollout``)
where the JAX runner takes its sharded kernel, the generic
``collect_rollout`` runs on the union on the lead device (the JAX package's
partitioned scan computes that one-device program), and the update half
runs on the gathered union in every process, from the same generator, then
takes rank 0's agent state (``broadcast_agent_state``).  A host env keeps
host-rollout mode under a one-process mesh.  ``train_carry.npz`` holds the
union's layout, so a run restores onto another mesh or none
(``parallel/distributed.py:elastic_restore``); across processes rank 0
evaluates and writes the files.
"""

from __future__ import annotations

import os
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from ..agents.base import AgentDef, collect_rollout, resolve_storage_dtype
from ..agents.ppo import resolve_compute_dtype
from ..config import Config, kwargs_filter, resolve_device, select_kernel
from ..envs.base import EnvDef, vec_reset
from ..envs.host_env import HostLink, host_collect_rollout
from ..parallel.mesh import (Shards, broadcast_agent_state, device_scope, gather_env_axis,
                             gather_train_carry, make_mesh, mesh_devices,
                             shard_train_carry, split_env_axis)
from ..utils.checkpoint import load_tree, save_tree, tree_unflatten
from ..utils.jax_params import buffer_state_from_numpy, buffer_state_to_numpy
from .evaluator import Evaluator
from .replay_buffer import ReplayBuffer


class TrainCarry(NamedTuple):
    agent_state: Any
    buf_state: Any          # the replay buffer's BufferState; None on-policy
    env_state: Any
    obs: torch.Tensor
    gen: torch.Generator    # the run's random stream, on the run's device


class TrainContext(NamedTuple):
    env: EnvDef
    agent: AgentDef
    round_fn: Any           # (carry, noise=None, ids=None, update_noise=None) -> (carry, metrics)
    carry: TrainCarry
    steps_per_round: int
    device: torch.device
    fused_rollout: bool
    rb: Any = None          # the ReplayBuffer (off-policy)
    # (carry, rollout, last_obs, ids=None, update_noise=None) -> (carry,
    # metrics): the update half of round_fn for a rollout collected outside
    # it (envs/host_env.py:host_collect_rollout)
    update_from_rollout: Any = None
    # decided once in build_training, where round_fn takes the host rollout
    # with it; the evaluator follows it (the pool is stateful and the
    # carry's obs came from it)
    use_host_rollout: bool = False
    mesh: Any = None        # the mesh the carry is sharded over (parallel/mesh.py), or None


def _resolve_env_def(args: Config) -> EnvDef:
    """Accept an EnvDef, a VecEnv-style instance or class."""
    env_class = args.env_class
    if isinstance(env_class, EnvDef):
        return env_class
    if hasattr(env_class, '_def'):
        return env_class._def
    env = env_class(**kwargs_filter(env_class.__init__, dict(args.env_args or {})))
    if hasattr(env, '_def'):
        return env._def
    raise TypeError(f'{env_class} is not a batched tensor env (no EnvDef)')


def _make_agent(args: Config, buffer) -> AgentDef:
    make = getattr(args.agent_class, 'make', None) or args.agent_class
    return make(args.net_dims, args.state_dim, args.action_dim, args, buffer=buffer)


# agent name -> off-policy head of the fused rollout (ops/fused_rollout.py),
# as the JAX runner's _OFFPOLICY_KERNEL_HEADS: the H-term variants explore as
# their base agents do; EmbedDQN/EnsembleDQN have no head
_OFFPOLICY_KERNEL_HEADS = {
    'AgentDDPG': 'ddpg', 'AgentDDPGHterm': 'ddpg',
    'AgentTD3': 'ddpg', 'AgentTD3Hterm': 'ddpg',
    'AgentSAC': 'sac', 'AgentSACHterm': 'sac',
    'AgentModSAC': 'modsac', 'AgentModSACHterm': 'modsac',
    'AgentDQN': 'dqn', 'AgentDoubleDQN': 'dqn_enc',
    'AgentDuelingDQN': 'dqn_duel', 'AgentD3QN': 'dqn_duel',
}


def jax_rollout_block_chunk(body, discrete: bool, off_policy: bool, num_envs: int,
                            horizon_len: int):
    """The JAX runner's (block, chunk) for its rollout kernel on a TPU, or
    None where no pair fits its VMEM budget and it runs the scan instead
    (``elegantrl_tpu/train/runner.py:_maybe_pallas_rollout``, one chip, no
    interpret mode): the rollout outputs of one (block, chunk) within 4 MiB
    less the market tables; blocks of 2048 down to 128 envs (all envs below
    128); chunks that divide the horizon and are multiples of 8 (or the
    horizon itself); the first block that has a chunk wins.  A TPU figure
    of that package, copied only to decide as it decides."""
    S, A = body.state_dim, body.action_dim
    rows = S + (1 if discrete else A) + (3 if off_policy else 5)
    tab_bytes = body.tables.nbytes if body.tables is not None else 0
    sizes = (num_envs,) if num_envs < 128 else (2048, 1024, 512, 256, 128)
    cands = sorted({1024, 512, 256, 128, 64, 32, 16, 8, horizon_len}, reverse=True)
    for b in sizes:
        if num_envs % b or b > num_envs:
            continue
        ch = next((c for c in cands if c <= horizon_len and horizon_len % c == 0
                   and rows * c * b * 4 <= 4 * 2 ** 20 - tab_bytes), None)
        if ch is not None:
            return b, ch
    return None


def _maybe_fused_rollout(args, env: EnvDef, agent: AgentDef, device: torch.device,
                         num_envs: int, horizon_len: int, reward_scale: float, mesh=None):
    """The fused rollout (``ops/fused_rollout.py``) when ``select_kernel``
    takes it, else None (the generic ``collect_rollout``, on either device).
    The JAX runner takes its kernel (``elegantrl_tpu/train/runner.py:
    _maybe_pallas_rollout``) for an env with a kernel body, its own
    (``EnvDef.kernel_body``, the stock env) or a registered one, that matches
    the env's spec (PointChasing with ``dim != 2`` does not), a 2-hidden-layer
    MLP, and (Discrete)PPO or (Discrete)A2C as the env is discrete or not
    (A2C explores exactly as PPO does; not ``AgentPPOHterm``), or an
    off-policy agent with a kernel head, when a (block, chunk) fits its VMEM
    budget (:func:`jax_rollout_block_chunk`).  The port's kernel fits when
    one of its designs holds the net: a cluster of blocks holding the weight
    slices, or the streamed design, which reads layer 2 from device memory
    and takes every width to (1024, 1024) and past it (``rollout_fits``;
    off-policy ``offpolicy_fits``, for a (body, head) pair it has), in the
    compute and storage types the JAX runner hands its kernel (the bf16
    variants under bf16 compute, the stock body's K4 among them).

    Under a mesh the JAX runner's terms come first: one mesh axis and
    ``num_envs`` a multiple of the shards, or no kernel (``True`` raises);
    then the (block, chunk) of the per-shard env count.  Where they send
    the JAX runner to its sharded kernel, the port takes its per-shard
    launches (``make_sharded_fused_rollout``,
    ``make_sharded_offpolicy_rollout``), whose stock body needs each shard
    to hold whole 32-lane groups (``shard_fits``)."""
    from ..ops.fused_rollout import (KERNEL_ENV_BODIES, kernel_bodies_text,
                                     make_fused_offpolicy_rollout, make_fused_rollout,
                                     make_sharded_fused_rollout,
                                     make_sharded_offpolicy_rollout, offpolicy_fits,
                                     offpolicy_width_limit, rollout_fits,
                                     rollout_width_limit, shard_fits)
    shards = 1
    if mesh is not None:
        shards = mesh.size
        if len(mesh.axis_names) != 1 or num_envs % shards:
            scope = (f'a single mesh axis and num_envs % {shards} == 0 (got '
                     f'axes={mesh.axis_names}, num_envs={num_envs})')
            if getattr(args, 'use_fused_rollout', 'auto') is True:
                raise ValueError(f'use_fused_rollout=True under a mesh needs {scope}')
            select_kernel(args, 'use_fused_rollout', False, False, device, scope)
            return None
    envs_local = num_envs // shards
    in_shards = ('' if mesh is None else
                 f', in shards of {envs_local} envs (whole 32-lane groups on the stock body)')
    spec = env.spec
    net_dims = tuple(args.net_dims)
    body = env.kernel_body or KERNEL_ENV_BODIES.get(spec.env_name)
    if body is not None and (env.host_pool is not None   # a host env has no kernel body
                             or body.state_dim != spec.state_dim
                             or body.action_dim != spec.action_dim):
        body = None
    off_head = _OFFPOLICY_KERNEL_HEADS.get(agent.name)
    bodies = kernel_bodies_text(body)
    # the types the JAX runner hands its kernel (compute_dtype, store_dtype)
    cdt = torch.bfloat16 if resolve_compute_dtype(args, net_dims) == 'bfloat16' else None
    sdt = resolve_storage_dtype(args)
    types = dict(compute_dtype=cdt, store_dtype=sdt)
    bf = cdt is not None   # the kernels' bf16 variants
    precision = 'bf16' if bf else 'float32'

    if agent.if_off_policy:
        jax_takes = (body is not None and len(net_dims) == 2 and off_head is not None
                     and agent.rollout_extras is None
                     and jax_rollout_block_chunk(body, spec.if_discrete, True, envs_local,
                                                 horizon_len) is not None)
        fits = (jax_takes and offpolicy_fits(body, off_head, net_dims, bf)
                and shard_fits(body, num_envs, shards))
        limit = (f'{offpolicy_width_limit(body, off_head, bf)} for {off_head} on '
                 f'{spec.env_name} in {precision}' if jax_takes else
                 'past 1024 on every pair')
        scope = (f'an off-policy agent of {sorted(_OFFPOLICY_KERNEL_HEADS)} with a '
                 f'2-hidden-layer MLP that one of its designs holds (square widths up to '
                 f'{limit}; ops/fused_rollout.py:offpolicy_fits), '
                 f'on an env of '
                 f'{bodies} at its body\'s dimensions whose action space '
                 f'the agent fits; got agent={agent.name}, env={spec.env_name}, '
                 f'net_dims={net_dims}, compute_dtype={cdt or torch.float32}{in_shards}')
        if not select_kernel(args, 'use_fused_rollout', jax_takes, fits, device, scope):
            return None
        print(f'| build_training: fused-rollout path enabled (env={spec.env_name}, '
              f'head={off_head}, net_dims={net_dims}{_shard_note(mesh)})', flush=True)
        # the agents' own hyper defaults (the JAX runner's head_cfg)
        head_cfg = dict(noise_std=float(getattr(args, 'explore_noise_std',
                                                getattr(args, 'explore_noise', 0.05))),
                        explore_rate=float(getattr(args, 'explore_rate', 0.25)),
                        std_clip=(-20.0, 2.0) if off_head == 'modsac' else (-16.0, 2.0))
        if mesh is not None:
            return make_sharded_offpolicy_rollout(body, off_head, net_dims, horizon_len,
                                                  num_envs, reward_scale, mesh, **head_cfg,
                                                  **types)
        return make_fused_offpolicy_rollout(body, off_head, net_dims, horizon_len, num_envs,
                                            reward_scale, **head_cfg, **types)
    want_agents = (('AgentDiscretePPO', 'AgentDiscreteA2C') if spec.if_discrete
                   else ('AgentPPO', 'AgentA2C'))
    jax_takes = (body is not None and agent.name in want_agents and len(net_dims) == 2
                 and jax_rollout_block_chunk(body, spec.if_discrete, False, envs_local,
                                             horizon_len) is not None)
    limit = (f'{rollout_width_limit(body, bf)} on {spec.env_name}' if body is not None
             else 'past 1024 on every body')
    scope = (f'{want_agents[0]} or {want_agents[1]} with a 2-hidden-layer MLP that one '
             f'of its designs holds (square widths up to {limit} in '
             f'{precision}; ops/fused_rollout.py:rollout_fits), on an env of '
             f'{bodies} at its '
             f"body's dimensions; got agent={agent.name}, env={spec.env_name}, "
             f'state_dim={spec.state_dim}, action_dim={spec.action_dim}, '
             f'net_dims={net_dims}{in_shards}')
    if not select_kernel(args, 'use_fused_rollout', jax_takes,
                         jax_takes and rollout_fits(body, net_dims, bf)
                         and shard_fits(body, num_envs, shards), device, scope):
        return None
    print(f'| build_training: fused-rollout path enabled (env={spec.env_name}, '
          f'net_dims={net_dims}, compute={cdt or torch.float32}, '
          f'storage={sdt or torch.float32}{_shard_note(mesh)})', flush=True)
    if mesh is not None:
        return make_sharded_fused_rollout(body, net_dims, horizon_len, num_envs, reward_scale,
                                          mesh, **types)
    return make_fused_rollout(body, net_dims, horizon_len, num_envs, reward_scale, **types)


def _shard_note(mesh) -> str:
    return '' if mesh is None else f', sharded x{mesh.size}'


def build_training(args: Config, mesh=None) -> TrainContext:
    """Env, agent, initial carry and the per-round step function.  With
    ``mesh`` (``parallel/mesh.py:make_mesh``) the carry is built whole on
    the mesh's lead device and sharded env-axis data parallel, as the
    module says."""
    device = resolve_device(args)
    if mesh is not None:
        if mesh.lead.type != device.type:
            raise ValueError(f'build_training: args.device={args.device!r} but the mesh\'s '
                             f'shards are on {[str(d) for d in mesh.devices]}')
        device = mesh.lead
    env = _resolve_env_def(args)
    spec = env.spec
    if args.state_dim is None:
        args.state_dim = spec.state_dim
    if args.action_dim is None:
        args.action_dim = spec.action_dim
    if args.if_discrete is None:
        args.if_discrete = spec.if_discrete
    if args.max_step == 12345:
        args.max_step = spec.max_step
    num_envs = int(args.num_envs)
    horizon_len = int(args.horizon_len)
    reward_scale = float(args.reward_scale)

    rb = None
    if args.if_off_policy:   # the replay buffer lives on the run's device
        rb = ReplayBuffer(max_size=args.buffer_size, state_dim=args.state_dim,
                          action_dim=args.action_dim, num_seqs=num_envs,
                          if_use_per=bool(getattr(args, 'if_use_per', False)),
                          if_discrete=bool(args.if_discrete), args=args, device=device)
    agent = _make_agent(args, rb)
    fast_rollout = _maybe_fused_rollout(args, env, agent, device, num_envs, horizon_len,
                                        reward_scale, mesh)
    if args.random_seed is None:
        args.random_seed = max(0, int(args.gpu_id))
    seed = int(args.random_seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    agent_state = agent.init(seed, device)
    if args.continue_train:
        ckpt = os.path.join(args.cwd, 'agent.npz')
        if os.path.isfile(ckpt):
            agent_state = agent.state_from_numpy(
                load_tree(ckpt, agent.state_to_numpy(agent_state)), device)
            print(f'| train_agent: loaded {ckpt}', flush=True)
    use_host_rollout = env.host_pool is not None and bool(getattr(args, 'host_rollout', True))
    # Under a mesh of several processes each process's pool holds the envs of
    # its own shards, seeded as in the one-process layout, and steps them in
    # host-rollout mode; the rollouts and obs are gathered into the union as
    # the device rollouts' are (the JAX runner steps its pool through
    # io_callback there, elegantrl_tpu/train/runner.py:327-343).
    def union(x, dim: int = 0):
        """This process's rows of a host-pool value, gathered into the union."""
        return gather_env_axis(Shards(list(torch.chunk(x, len(mesh.shards), dim)), mesh), dim)

    host_shard = None   # (lo, hi, union) of this process's pool: host_collect_rollout's
    if env.host_pool is not None and mesh is not None and mesh.world_size > 1:
        if num_envs % mesh.size:
            raise ValueError(f'build_training: num_envs={num_envs} does not divide over the '
                             f'mesh\'s {mesh.size} shards')
        per = num_envs // mesh.size
        host_shard = (mesh.shards[0] * per, (mesh.shards[-1] + 1) * per, union)
        env.host_pool.shard(host_shard[0])
        use_host_rollout = True

    if host_shard is None:
        env_state, obs = vec_reset(env, gen, num_envs, device)   # a host env: its pool's reset
    else:
        env_state, obs = vec_reset(env, gen, host_shard[1] - host_shard[0], device)
        obs_local = obs
        env_state, obs = union(env_state), union(obs)
    buf_state = rb.init() if rb is not None else None
    store_dtype = resolve_storage_dtype(args)
    if use_host_rollout:
        # the pool's current obs as the pool gives them (numpy, or a native
        # pool's tensors) and the rollout's own generator, as the JAX run's
        link = HostLink(env.host_pool, device)
        first = obs if host_shard is None else obs_local
        obs_host = first if link.native else first.cpu().numpy()
        gen_host = torch.Generator(device=device)
        gen_host.manual_seed(seed + 0x705)

    def update_half(carry: TrainCarry, rollout, env_state, obs, ids, update_noise):
        buf_state = carry.buf_state
        if agent.if_off_policy:
            agent_state = carry.agent_state
            if agent.pre_update is not None:      # the H-term window harvest
                agent_state = agent.pre_update(agent_state, rollout, obs)
            buf_state = rb.update(buf_state, (rollout.states, rollout.actions, rollout.rewards,
                                              rollout.undones, rollout.unmasks))
            if rb.if_use_cum_rewards and agent.cum_returns is not None:
                buf_state = rb.update_cum_rewards(buf_state, horizon_len,
                                                  agent.cum_returns(agent_state, rollout, obs))
            agent_state, buf_state, metrics = agent.update(
                agent_state, buf_state, carry.gen, ids=ids, noise=update_noise)
        else:
            agent_state, metrics = agent.update(carry.agent_state, rollout, obs, carry.gen,
                                                ids=ids)
        metrics = dict(metrics, exp_r=rollout.rewards.mean())
        if agent.if_discrete:   # the action histogram of the eval line
            metrics['action_hist'] = torch.bincount(rollout.actions.reshape(-1).long(),
                                                    minlength=int(args.action_dim))
        if mesh is not None:    # the union's update ran in every process
            broadcast_agent_state(mesh, agent_state)
            if not isinstance(env_state, Shards):
                env_state = split_env_axis(mesh, env_state)
            obs = split_env_axis(mesh, obs)
        return TrainCarry(agent_state, buf_state, env_state, obs, carry.gen), metrics

    def update_from_rollout(carry: TrainCarry, rollout, last_obs, ids=None, update_noise=None):
        """The update half of a round for a rollout collected outside it (the
        host-rollout mode); ``ids`` and ``update_noise`` as for round_fn."""
        with device_scope(carry.gen.device):
            return update_half(carry, rollout, carry.env_state, last_obs, ids, update_noise)

    def round_fn(carry: TrainCarry, noise=None, ids=None, update_noise=None):
        """One round.  ``noise`` (the fused rollout's injected-noise tensor;
        in host-rollout mode the host rollout's ``(H, N, A)`` normals),
        ``ids`` (minibatch ids: ``(U, B)`` flat ids, time slices for A2C, or
        ``(U, R)`` time rows off-policy) and ``update_noise`` (TD3's ``(U, B,
        A)`` smoothing noise; SAC's ``(U, 2, B, A)`` next-action and
        policy-gradient noise) replace the draws; tests use them to replay
        the JAX package's round.  In host-rollout mode the rollout runs on
        the pool (``host_collect_rollout``) and the round's update half is
        ``update_from_rollout``'s.  Under a mesh ``noise`` is the union's.
        The round runs with the carry's device current (its generator's: a
        population member's card, or the mesh's lead), where its kernels
        launch."""
        with device_scope(carry.gen.device):
            return _round(carry, noise, ids, update_noise)

    def _round(carry: TrainCarry, noise, ids, update_noise):
        nonlocal obs_host
        if mesh is not None and not isinstance(carry.obs, Shards):
            raise ValueError('round_fn: this context was built with a mesh; its carry is '
                             'sharded (shard_train_carry)')
        if mesh is None and isinstance(carry.obs, Shards):
            raise ValueError('round_fn: the carry is sharded over a mesh this context was '
                             'not built with; build_training(args, mesh=...)')
        if use_host_rollout:
            rollout, obs_host = host_collect_rollout(
                env.host_pool, agent, carry.agent_state, obs_host, gen_host, horizon_len,
                reward_scale, device, noise=noise, link=link, shard=host_shard)
            last = link.up(obs_host)
            if host_shard is not None:   # this process's envs, into the union
                last = union(last)
            return update_half(carry, rollout, carry.env_state, last, ids, update_noise)
        if fast_rollout is not None:
            rollout, env_state, obs = fast_rollout(carry.agent_state, carry.env_state,
                                                   carry.gen, noise=noise)
        else:
            if noise is not None:
                raise ValueError('injected noise needs the fused-rollout path')
            env_state, obs = carry.env_state, carry.obs
            if mesh is not None:   # the one-device program on the union
                env_state, obs = gather_env_axis(env_state), gather_env_axis(obs)
            rollout, env_state, obs = collect_rollout(
                env, carry.agent_state, agent.explore_action, agent.env_action,
                env_state, obs, carry.gen, horizon_len, reward_scale,
                extras_fn=agent.rollout_extras, store_dtype=store_dtype)
        return update_half(carry, rollout, env_state, obs, ids, update_noise)

    carry = TrainCarry(agent_state, buf_state, env_state, obs, gen)
    if args.continue_train:
        full = os.path.join(args.cwd, 'train_carry.npz')
        if os.path.isfile(full):
            carry = _load_carry(full, carry, agent, device)
            print(f'| train_agent: resumed full carry from {full}', flush=True)
            if use_host_rollout:
                # the pool's envs are not in the checkpoint and were reset
                # above: keep the restored agent, buffer and generator, but
                # point obs at the pool's episode starts, so the first stored
                # transition pairs a real (s, a, r, s')
                carry = carry._replace(obs=obs, env_state=env_state)
    if mesh is not None:
        carry = shard_train_carry(mesh, carry, mesh.axis_names[0])
    return TrainContext(env=env, agent=agent, round_fn=round_fn, carry=carry,
                        steps_per_round=horizon_len * num_envs, device=device,
                        fused_rollout=fast_rollout is not None, rb=rb,
                        update_from_rollout=update_from_rollout,
                        use_host_rollout=use_host_rollout, mesh=mesh)


def _carry_tree(carry: TrainCarry, agent: AgentDef) -> dict:
    """The carry as a tree in the JAX package's leaf order (dict keys
    sorted): agent state, buffer (off-policy), env state, obs and the
    generator's state."""
    tree = {'agent_state': agent.state_to_numpy(carry.agent_state),
            'env_state': carry.env_state, 'obs': carry.obs, 'gen': carry.gen.get_state()}
    if carry.buf_state is not None:
        tree['buf_state'] = buffer_state_to_numpy(carry.buf_state)
    return tree


def _load_carry(path: str, carry: TrainCarry, agent: AgentDef, device) -> TrainCarry:
    tree = load_tree(path, _carry_tree(carry, agent))
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    if isinstance(carry.env_state, torch.Tensor):   # a host env's dummy state
        env_state = t(tree['env_state'])
    else:
        env_state = tree_unflatten(carry.env_state, iter([t(x) for x in tree['env_state']]))
    carry.gen.set_state(torch.as_tensor(tree['gen']))
    buf_state = None
    if 'buf_state' in tree:   # back to the ring's storage type
        buf_state = buffer_state_from_numpy(tree['buf_state'], device)
        buf_state = buf_state._replace(
            states=buf_state.states.to(carry.buf_state.states.dtype),
            actions=buf_state.actions.to(carry.buf_state.actions.dtype))
    return TrainCarry(agent.state_from_numpy(tree['agent_state'], device), buf_state,
                      env_state, t(tree['obs']), carry.gen)


def _save_carry(path: str, carry: TrainCarry, agent: AgentDef, write: bool = True) -> None:
    """Write the carry, in the union's layout, through a temporary file, so
    no torn checkpoint is ever left at ``path``.  Across processes every
    process gathers and the one with ``write`` writes."""
    carry = gather_train_carry(carry)
    if write:
        save_tree(path + '.tmp.npz', _carry_tree(carry, agent))
        os.replace(path + '.tmp.npz', path)


def _rank0_flag(mesh, flag: bool) -> bool:
    """Rank 0's ``flag`` in every process of the mesh."""
    if mesh is None or mesh.world_size == 1:
        return flag
    import torch.distributed as dist
    t = torch.tensor([int(flag)], device=mesh.lead)
    dist.broadcast(t, src=0)
    return bool(t.item())


def train_agent(args: Config, if_single_process: bool = True) -> dict:
    """Train and evaluate (``if_single_process`` is kept for the JAX
    package's signature: one process runs rollout, update and evaluation
    either way); returns the recorder (with its wall times), final
    agent state and throughput.  Evaluation runs on ``eval_env_class`` with
    ``eval_env_args`` (default: the training env's args) where given, else on
    the training env.  A resumable run (``continue_train`` or
    ``if_save_buffer``) writes ``train_carry.npz`` every ``save_gap``
    evaluation periods and at the end; an on-policy run always writes it at
    the end, an off-policy one (whose carry holds the replay ring) only when
    resumable.  ``args.mesh_axes`` (``{'dp': n}``) trains over a mesh of the
    cards, or on the CPU of ``'cpu'`` shards (``parallel/mesh.py``); across
    processes rank 0 evaluates, writes the files and decides when to stop."""
    args.init_before_training()
    mesh = None
    if getattr(args, 'mesh_axes', None):
        mesh = make_mesh(args.mesh_axes, mesh_devices(args.mesh_axes, resolve_device(args)))
    lead = mesh is None or mesh.rank == 0
    ctx = build_training(args, mesh=mesh)
    carry, round_fn = ctx.carry, ctx.round_fn
    # a host env owns a stateful pool: the evaluator gets its own instance,
    # so evaluation episodes cannot reset or resize the training pool
    eval_env = ctx.env.fresh() if ctx.env.fresh is not None else ctx.env
    if args.eval_env_class is not None:
        eval_args = Config(args.agent_class, args.eval_env_class,
                           args.eval_env_args or dict(args.env_args))
        eval_env = _resolve_env_def(eval_args)
    evaluator = Evaluator(cwd=args.cwd, env=eval_env, greedy_action=ctx.agent.greedy_action,
                          args=args, device=ctx.device, host_eval=ctx.use_host_rollout)
    rounds_per_eval = max(1, int(args.eval_per_step) // ctx.steps_per_round)
    names = ('obj_critic', 'obj_actor', 'exp_r')
    carry_path = os.path.join(args.cwd, 'train_carry.npz')
    resumable = bool(args.continue_train or args.if_save_buffer)
    carry_gap = max(1, int(getattr(args, 'save_gap', 8)))

    total_step = 0
    periods = 0
    t_start = time.time()
    if_train = True
    while if_train:
        packs, hist = [], 0
        for _ in range(rounds_per_eval):
            carry, metrics = round_fn(carry)
            packs.append(torch.stack([metrics[k].float() for k in names]))
            if 'action_hist' in metrics:
                hist = hist + metrics['action_hist']
        # one host transfer per evaluation period
        obj_c, obj_a, exp_r = torch.stack(packs).mean(0).tolist()
        logging_tuple = (obj_c, obj_a)
        if ctx.agent.if_discrete:
            counts = hist.cpu().numpy()
            frac = counts / max(counts.sum(), 1)
            logging_tuple += (' a:' + ' '.join(f'{f:.2f}' for f in frac),)
        steps = ctx.steps_per_round * rounds_per_eval
        if lead:
            evaluator.evaluate_and_save(carry.agent_state, steps, exp_r, logging_tuple,
                                        ctx.agent.state_to_numpy)
        periods += 1
        if resumable and periods % carry_gap == 0:
            _save_carry(carry_path, carry, ctx.agent, lead)
        total_step += steps
        if_train = _rank0_flag(mesh, total_step <= args.break_step
                               and evaluator.max_r < args.break_score
                               and not os.path.exists(os.path.join(args.cwd, 'stop')))

    used_time = time.time() - t_start
    print(f'| UsedTime: {used_time:>7.0f} | SavedDir: {args.cwd}', flush=True)
    if lead:
        evaluator.save_or_load_recorder(if_save=True)
        evaluator.save_training_curve_jpg()
        save_tree(os.path.join(args.cwd, 'agent.npz'),
                  ctx.agent.state_to_numpy(carry.agent_state))
    if ctx.rb is None or resumable:
        _save_carry(carry_path, carry, ctx.agent, lead)
    if args.if_save_buffer and ctx.rb is not None and lead:
        ctx.rb.save_or_load_history(carry.buf_state, args.cwd, if_save=True)
    return {
        'recorder': np.array(evaluator.recorder, dtype=np.float64),
        'recorder_times': np.array(evaluator.recorder_times, dtype=np.float64),
        'agent_state': carry.agent_state,
        'total_step': total_step,
        'used_time': used_time,
        'steps_per_second': total_step / max(used_time, 1e-9),
        'max_r': evaluator.max_r,
    }


def train_agent_single_process(args: Config) -> dict:
    return train_agent(args)


def train_agent_multiprocessing(args: Config) -> dict:
    """The reference's worker/learner/evaluator processes are one loop
    here, as in the JAX package; this alias keeps its name."""
    return train_agent(args)


def train_agent_multiprocessing_multi_gpu(args: Config) -> dict:
    """Multi-learner training: set ``args.mesh_axes = {'dp': n}`` to shard the
    env axis over the cards (``parallel/mesh.py``; across processes, after
    ``parallel/distributed.py:init_distributed``) instead of spawning a
    learner process per card."""
    return train_agent(args)


def valid_agent(env_class, env_args: dict, net_dims, agent_class, actor_path: str,
                render_times: int = 8, device: str = 'cuda') -> list:
    """Load a saved agent (``agent.npz`` or an evaluator's ``actor__*.npz``,
    both the whole agent state) and play ``render_times`` greedy episodes
    side by side on ``device``; prints and returns the ``(return, steps)``
    pairs.  Envs have no window here, so to render is to print."""
    from .evaluator import make_eval_fn

    args = Config(agent_class, env_class, dict(env_args))
    args.net_dims, args.device = net_dims, device
    dev = resolve_device(args)
    env = _resolve_env_def(args)
    rb = None
    if args.if_off_policy:
        rb = ReplayBuffer(max_size=8, state_dim=args.state_dim, action_dim=args.action_dim,
                          num_seqs=1, if_discrete=bool(args.if_discrete), args=args, device=dev)
    agent = _make_agent(args, rb)
    like = agent.state_to_numpy(agent.init(0, dev))
    print(f"| valid_agent: load actor from: {actor_path}", flush=True)
    agent_state = agent.state_from_numpy(load_tree(actor_path, like), dev)
    eval_fn = make_eval_fn(env, agent.greedy_action, int(render_times), env.spec.max_step, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    returns, steps = eval_fn(agent_state, gen)
    results = []
    for i, (r, st) in enumerate(zip(returns, steps)):
        print(f"|{i:4}  cumulative_reward {float(r):9.3f}  episode_step {int(st):5d}",
              flush=True)
        results.append((float(r), int(st)))
    return results


render_agent = valid_agent
