"""Population training (counterpart of ``elegantrl_tpu/parallel/population.py``):
generational evolution of ``P`` members, each with its own env batch and
random stream.

A generation runs each member's rounds through the one ``round_fn`` of
``build_training``, member after member, so every member's round launches
its kernels at full single-agent width (the JAX package's per-member loop,
``population.py:59-78``, which keeps its Pallas kernels out of ``vmap``).
Then every member is evaluated (``train/evaluator.py:make_eval_fn``, the
mean return of its greedy episodes), and truncation selection overwrites
the bottom half with copies of the top half (:func:`selection_src`); each
slot takes a copy of its source (nothing is shared: the agent state is
updated in place) and a fresh generator.  Under ``mesh_axes={'pop': n}``
the members go to the mesh's devices in contiguous blocks of ``P / n``, as
``shard_map`` splits them; one process only.  A member's rounds
(``round_fn``) and its evaluation run with its card current.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..envs.base import vec_reset
from ..train.evaluator import make_eval_fn
from ..train.runner import TrainCarry, build_training
from ..utils.checkpoint import tree_leaves, tree_unflatten
from .mesh import device_scope


def member_seed(random_seed: int, m: int) -> int:
    """Member ``m``'s seed: its agent's initial weights, env batch and
    generator (the JAX package folds ``m`` into the run's key)."""
    return (int(random_seed) << 20) + int(m)


def member_carry(ctx, args: Config, m: int, device) -> TrainCarry:
    """Member ``m``'s initial carry on ``device``, from :func:`member_seed`."""
    seed = member_seed(args.random_seed, m)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    env_state, obs = vec_reset(ctx.env, gen, int(args.num_envs), torch.device(device))
    buf_state = ctx.rb.init(device) if ctx.rb is not None else None
    return TrainCarry(ctx.agent.init(seed, device), buf_state, env_state, obs, gen)


def train_members(ctx, carries: List[TrainCarry], rounds: int,
                  draws: Optional[list] = None) -> List[TrainCarry]:
    """Each member's ``rounds`` rounds, member after member.  ``draws[m][r]``,
    where given, are the keyword arguments of member ``m``'s round ``r``
    (``noise``, ``ids``, ``update_noise``: tests replay the JAX package's)."""
    out = []
    for m, carry in enumerate(carries):
        for r in range(rounds):
            carry, _ = ctx.round_fn(carry, **(draws[m][r] if draws is not None else {}))
        out.append(carry)
    return out


def selection_src(scores: np.ndarray) -> np.ndarray:
    """Truncation selection as the JAX package computes it: slot ``m`` takes
    member ``src[m]``; the top ``P - P // 2`` in descending order of score,
    then the top ``P // 2`` again (``np.argsort(-scores)``, ties included)."""
    population_size = len(scores)
    order = np.argsort(-np.asarray(scores))
    half = population_size // 2
    return np.concatenate([order[:population_size - half], order[:half]])


def _copy(tree, device):
    return tree_unflatten(tree, iter([v.to(device, copy=True) if isinstance(v, torch.Tensor)
                                      else v for v in tree_leaves(tree)]))


def clone_member(ctx, carry: TrainCarry, seed: int, device) -> TrainCarry:
    """A copy of ``carry`` on ``device`` that shares no storage with it (the
    agent state rebuilt through its numpy form, so its modules view the new
    flat buffers) and a generator seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    agent = ctx.agent
    return TrainCarry(agent.state_from_numpy(agent.state_to_numpy(carry.agent_state), device),
                      None if carry.buf_state is None else _copy(carry.buf_state, device),
                      _copy(carry.env_state, device), _copy(carry.obs, device), gen)


def _member_devices(ctx, population_size: int, mesh_axes) -> list:
    if not mesh_axes:
        return [ctx.device] * population_size
    from .mesh import make_mesh, mesh_devices
    mesh = make_mesh(mesh_axes, mesh_devices(mesh_axes, ctx.device))
    if mesh.world_size > 1:
        raise NotImplementedError('train_agent_population: a mesh of one process; got '
                                  f'{mesh.world_size}')
    if population_size % mesh.size:
        raise ValueError(f'train_agent_population: population_size={population_size} is not '
                         f'a multiple of the mesh\'s {mesh.size} devices')
    per = population_size // mesh.size
    return [mesh.devices[m // per] for m in range(population_size)]


def train_agent_population(args: Config, population_size: int = 8, generations: int = 4,
                           rounds_per_generation: int = 8, eval_episodes: int = 8,
                           mesh_axes: Optional[Dict[str, int]] = None,
                           verbose: bool = True) -> Dict[str, Any]:
    """Generational evolution over ``population_size`` members; returns the
    best member's agent state and score, the per-generation scores
    (``history``, ``(generations, population_size)``) and ``carry``, the
    members' carries (a list; the JAX package stacks its members on a
    leading axis)."""
    if args.random_seed is None:
        args.random_seed = 0
    ctx = build_training(args)
    env, agent = ctx.env, ctx.agent
    if env.host_pool is not None:
        # round_fn keeps the host pool and its obs in its closure, which
        # members would share (the JAX package's members would step one pool)
        raise NotImplementedError(f'train_agent_population: the host env {env.spec.env_name} '
                                  'has one pool; members need envs of their own')
    devices = _member_devices(ctx, population_size, mesh_axes)
    carries = [member_carry(ctx, args, m, dev) for m, dev in enumerate(devices)]
    eval_fns = {dev: make_eval_fn(env, agent.greedy_action, eval_episodes, int(args.max_step),
                                  dev) for dev in set(devices)}

    history = []
    t0 = time.time()
    steps_per_gen = rounds_per_generation * int(args.horizon_len) * int(args.num_envs)
    for g in range(generations):
        carries = train_members(ctx, carries, rounds_per_generation)
        scores = []
        for m, (carry, dev) in enumerate(zip(carries, devices)):
            gen = torch.Generator(device=dev)
            gen.manual_seed(member_seed(1000 + g, m))
            with device_scope(dev):
                scores.append(float(np.mean(eval_fns[dev](carry.agent_state, gen)[0])))
        scores = np.asarray(scores, np.float32)
        order = np.argsort(-scores)
        history.append(scores.copy())
        if verbose:
            print(f"| popgen {g}: best {scores[order[0]]:9.2f} "
                  f"median {np.median(scores):9.2f} worst {scores[order[-1]]:9.2f} "
                  f"steps/member {steps_per_gen * (g + 1):.2e} "
                  f"time {time.time() - t0:6.1f}s", flush=True)
        if g == generations - 1:
            break
        src = selection_src(scores)
        carries = [clone_member(ctx, carries[int(src[m])], m + (g + 1) * 7919, devices[m])
                   for m in range(population_size)]

    best = int(np.argmax(history[-1]))
    return {'best_agent_state': carries[best].agent_state,
            'best_score': float(history[-1][best]),
            'history': np.stack(history),
            'carry': carries}
