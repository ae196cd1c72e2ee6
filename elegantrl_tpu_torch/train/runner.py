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
Host-rollout and mesh modes of the JAX runner are not ported: ``args.mesh_axes``
raises.
"""

from __future__ import annotations

import os
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from ..agents.base import AgentDef, collect_rollout
from ..agents.ppo import resolve_compute_dtype
from ..config import Config, kwargs_filter, resolve_device, select_kernel
from ..envs.base import EnvDef, vec_reset
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
                         num_envs: int, horizon_len: int, reward_scale: float):
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
    a cluster of 8 blocks holds the weight slices (``rollout_fits``) or,
    off-policy, when the weights fit one block and it has the (body, head)
    pair."""
    from ..ops.fused_rollout import (KERNEL_ENV_BODIES, SMEM_LIMIT, kernel_bodies_text,
                                     make_fused_offpolicy_rollout, make_fused_rollout,
                                     offpolicy_pair_fits, offpolicy_smem_bytes, rollout_fits)
    spec = env.spec
    net_dims = tuple(args.net_dims)
    body = env.kernel_body or KERNEL_ENV_BODIES.get(spec.env_name)
    if body is not None and (body.state_dim != spec.state_dim
                             or body.action_dim != spec.action_dim):
        body = None
    off_head = _OFFPOLICY_KERNEL_HEADS.get(agent.name)
    bodies = kernel_bodies_text(body)
    if agent.if_off_policy:
        jax_takes = (body is not None and len(net_dims) == 2 and off_head is not None
                     and agent.rollout_extras is None
                     and jax_rollout_block_chunk(body, spec.if_discrete, True, num_envs,
                                                 horizon_len) is not None)
        if jax_takes and resolve_compute_dtype(args, net_dims) != 'float32':
            # the JAX runner hands its kernel the compute type; the port's is f32 only
            raise NotImplementedError(
                'the PyTorch port computes in float32 only; set args.compute_dtype = '
                f"'float32' (got {getattr(args, 'compute_dtype', 'auto')!r} at "
                f'net_dims={net_dims}, which resolves to '
                f'{resolve_compute_dtype(args, net_dims)})')
        fits = (jax_takes and offpolicy_pair_fits(body, off_head)
                and offpolicy_smem_bytes(body.state_dim, net_dims, body.action_dim,
                                         off_head) <= SMEM_LIMIT)
        scope = (f'an off-policy agent of {sorted(_OFFPOLICY_KERNEL_HEADS)} with a '
                 f'2-hidden-layer MLP whose weights fit one block, on an env of '
                 f'{bodies} at its body\'s dimensions whose action space '
                 f'the agent fits; got agent={agent.name}, env={spec.env_name}, '
                 f'net_dims={net_dims}')
        if not select_kernel(args, 'use_fused_rollout', jax_takes, fits, device, scope):
            return None
        print(f'| build_training: fused-rollout path enabled (env={spec.env_name}, '
              f'head={off_head}, net_dims={net_dims})', flush=True)
        # the agents' own hyper defaults (the JAX runner's head_cfg)
        return make_fused_offpolicy_rollout(
            body, off_head, net_dims, horizon_len, num_envs, reward_scale,
            noise_std=float(getattr(args, 'explore_noise_std',
                                    getattr(args, 'explore_noise', 0.05))),
            explore_rate=float(getattr(args, 'explore_rate', 0.25)),
            std_clip=(-20.0, 2.0) if off_head == 'modsac' else (-16.0, 2.0))
    want_agents = (('AgentDiscretePPO', 'AgentDiscreteA2C') if spec.if_discrete
                   else ('AgentPPO', 'AgentA2C'))
    jax_takes = (body is not None and agent.name in want_agents and len(net_dims) == 2
                 and jax_rollout_block_chunk(body, spec.if_discrete, False, num_envs,
                                             horizon_len) is not None)
    scope = (f'{want_agents[0]} or {want_agents[1]} with a 2-hidden-layer MLP whose '
             f'weight slices fit a cluster of 8 blocks (square widths up to 320, 288 on '
             f'PointChasingDiscreteEnv; ops/fused_rollout.py:rollout_fits), on an env of '
             f'{bodies} at its '
             f"body's dimensions; got agent={agent.name}, env={spec.env_name}, "
             f'state_dim={spec.state_dim}, action_dim={spec.action_dim}, '
             f'net_dims={net_dims}')
    if not select_kernel(args, 'use_fused_rollout', jax_takes,
                         jax_takes and rollout_fits(body, net_dims), device, scope):
        return None
    print(f'| build_training: fused-rollout path enabled (env={spec.env_name}, '
          f'net_dims={net_dims})', flush=True)
    return make_fused_rollout(body, net_dims, horizon_len, num_envs, reward_scale)


def build_training(args: Config) -> TrainContext:
    """Env, agent, initial carry and the per-round step function."""
    if getattr(args, 'mesh_axes', None):
        raise NotImplementedError(
            f'args.mesh_axes={args.mesh_axes!r}: the PyTorch port trains on one device; '
            "sharding the env axis is ROADMAP.md's parallel item (parallel/mesh.py)")
    device = resolve_device(args)
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
                                        reward_scale)
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
    env_state, obs = vec_reset(env, gen, num_envs, device)
    buf_state = rb.init() if rb is not None else None

    def round_fn(carry: TrainCarry, noise=None, ids=None, update_noise=None):
        """One round.  ``noise`` (the fused rollout's injected-noise tensor),
        ``ids`` (minibatch ids: ``(U, B)`` flat ids, time slices for A2C, or
        ``(U, R)`` time rows off-policy) and ``update_noise`` (TD3's ``(U, B,
        A)`` smoothing noise; SAC's ``(U, 2, B, A)`` next-action and
        policy-gradient noise) replace the draws from ``carry.gen``; tests use
        them to replay the JAX package's round."""
        if fast_rollout is not None:
            rollout, env_state, obs = fast_rollout(carry.agent_state, carry.env_state,
                                                   carry.gen, noise=noise)
        else:
            if noise is not None:
                raise ValueError('injected noise needs the fused-rollout path')
            rollout, env_state, obs = collect_rollout(
                env, carry.agent_state, agent.explore_action, agent.env_action,
                carry.env_state, carry.obs, carry.gen, horizon_len, reward_scale,
                extras_fn=agent.rollout_extras)
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
        return TrainCarry(agent_state, buf_state, env_state, obs, carry.gen), metrics

    carry = TrainCarry(agent_state, buf_state, env_state, obs, gen)
    if args.continue_train:
        full = os.path.join(args.cwd, 'train_carry.npz')
        if os.path.isfile(full):
            carry = _load_carry(full, carry, agent, device)
            print(f'| train_agent: resumed full carry from {full}', flush=True)
    return TrainContext(env=env, agent=agent, round_fn=round_fn, carry=carry,
                        steps_per_round=horizon_len * num_envs, device=device,
                        fused_rollout=fast_rollout is not None, rb=rb)


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
    env_state = tree_unflatten(carry.env_state, iter(
        [t(x) for x in tree['env_state']]))
    carry.gen.set_state(torch.as_tensor(tree['gen']))
    buf_state = (buffer_state_from_numpy(tree['buf_state'], device)
                 if 'buf_state' in tree else None)
    return TrainCarry(agent.state_from_numpy(tree['agent_state'], device), buf_state,
                      env_state, t(tree['obs']), carry.gen)


def _save_carry(path: str, carry: TrainCarry, agent: AgentDef) -> None:
    """Write the carry through a temporary file, so no torn checkpoint is
    ever left at ``path``."""
    save_tree(path + '.tmp.npz', _carry_tree(carry, agent))
    os.replace(path + '.tmp.npz', path)


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
    resumable."""
    args.init_before_training()
    ctx = build_training(args)
    carry, round_fn = ctx.carry, ctx.round_fn
    eval_env = ctx.env
    if args.eval_env_class is not None:
        eval_args = Config(args.agent_class, args.eval_env_class,
                           args.eval_env_args or dict(args.env_args))
        eval_env = _resolve_env_def(eval_args)
    evaluator = Evaluator(cwd=args.cwd, env=eval_env, greedy_action=ctx.agent.greedy_action,
                          args=args, device=ctx.device)
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
        evaluator.evaluate_and_save(carry.agent_state, steps, exp_r, logging_tuple,
                                    ctx.agent.state_to_numpy)
        periods += 1
        if resumable and periods % carry_gap == 0:
            _save_carry(carry_path, carry, ctx.agent)
        total_step += steps
        if_train = (total_step <= args.break_step
                    and evaluator.max_r < args.break_score
                    and not os.path.exists(os.path.join(args.cwd, 'stop')))

    used_time = time.time() - t_start
    print(f'| UsedTime: {used_time:>7.0f} | SavedDir: {args.cwd}', flush=True)
    evaluator.save_or_load_recorder(if_save=True)
    evaluator.save_training_curve_jpg()
    save_tree(os.path.join(args.cwd, 'agent.npz'), ctx.agent.state_to_numpy(carry.agent_state))
    if ctx.rb is None or resumable:
        _save_carry(carry_path, carry, ctx.agent)
    if args.if_save_buffer and ctx.rb is not None:
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
    """One card: the JAX package's mesh mode is not ported, so this alias
    trains on ``args.device`` alone."""
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
