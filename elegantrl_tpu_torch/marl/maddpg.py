"""MADDPG: multi-agent DDPG with a centralized joint critic, counterpart of
``elegantrl_tpu/marl/maddpg.py``.

- parameter-shared deterministic tanh actors over local observations with
  Gaussian exploration noise;
- one centralized critic Q(global state, all actions) on the shared team
  reward;
- a replay ring over joint transitions and soft target updates.

The JAX package runs no Pallas kernel here; on the card the port runs
PyTorch ops.  A round's draws come from one ``torch.Generator`` or from
``draws``: ``act`` ``(H, N, M, A)`` exploration normals, ``env``, ``reset``
(as ``marl/mappo.py``) and ``ids`` ``(U, B)`` ring ids.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..agents.base import AdamState, grad_step, make_optimizer
from ..ops.nets import soft_update
from .env import (MultiAgentEnvDef, flat_tree, mlp_tree_apply, mlp_tree_init, trainer_device,
                  tree_grad, tree_views, where_done)
from .mappo import rollout_draws, rollout_return


class MADDPGState(NamedTuple):
    actor: list
    actor_target: list
    critic: list
    critic_target: list
    a_opt: AdamState
    c_opt: AdamState
    buf: tuple          # (obs, gs, acts, rew, undone, next_obs, next_gs, ptr, size)
    env_states: Any
    act_flat: torch.Tensor
    act_target_flat: torch.Tensor
    cri_flat: torch.Tensor
    cri_target_flat: torch.Tensor


def make_maddpg(env: MultiAgentEnvDef, net_dims=(128, 128), gamma: float = 0.97,
                lr: float = 5e-4, tau: float = 5e-3, explore_noise: float = 0.1,
                buf_size: int = 50_000, batch_size: int = 256, num_envs: int = 16,
                device=None):
    """``(init, train_round, evaluate)`` as the JAX package's, the state on
    ``device`` (None: the card; without a GPU that raises and names
    ``device='cpu'``)."""
    dev = trainer_device(device, 'make_maddpg')
    assert not env.if_discrete
    M, A = env.num_agents, env.action_dim
    joint_a = M * A
    optimizer = make_optimizer(lr, 3.0)

    def init(gen: torch.Generator) -> MADDPGState:
        """The nets (from ``gen``, a CPU generator, as ``marl/mappo.py``), an
        empty ring and ``num_envs`` fresh envs."""
        act_flat, actor = flat_tree(mlp_tree_init(gen, (env.obs_dim, *net_dims, A), 0.1), dev)
        cri_flat, critic = flat_tree(
            mlp_tree_init(gen, (env.state_dim + joint_a, *net_dims, 1), 0.5), dev)
        z = lambda *shape: torch.zeros(shape, device=dev)  # noqa: E731
        m = buf_size
        zero_i = torch.zeros((), dtype=torch.int32, device=dev)
        buf = (z(m, num_envs, M, env.obs_dim), z(m, num_envs, env.state_dim),
               z(m, num_envs, M, A), z(m, num_envs), z(m, num_envs),
               z(m, num_envs, M, env.obs_dim), z(m, num_envs, env.state_dim), zero_i,
               zero_i.clone())
        act_t, cri_t = act_flat.clone(), cri_flat.clone()
        fresh = env.init(gen, num_envs, gen.device)
        return MADDPGState(actor, tree_views(act_t, actor), critic, tree_views(cri_t, critic),
                           AdamState(0, torch.zeros_like(act_flat), torch.zeros_like(act_flat)),
                           AdamState(0, torch.zeros_like(cri_flat), torch.zeros_like(cri_flat)),
                           buf, type(fresh)(*[x.to(dev) for x in fresh]), act_flat, act_t,
                           cri_flat, cri_t)

    def act(actor, obs):
        return torch.tanh(mlp_tree_apply(actor, obs))      # (..., M, A)

    def q_joint(critic, gs, joint_actions):
        x = torch.cat([gs, joint_actions.reshape(gs.shape[:-1] + (joint_a,))], dim=-1)
        return mlp_tree_apply(critic, x)[..., 0]

    def train_round(state: MADDPGState, gen: torch.Generator, horizon: int = 64,
                    repeat: int = 1, draws: Optional[dict] = None):
        """The rollout into the ring, then ``horizon * repeat`` updates of the
        critic and the actor with soft target updates.  Returns ``(state,
        mean reward)``."""
        dev = state.act_flat.device
        env_states, items = state.env_states, []
        with torch.no_grad():
            for t in range(horizon):
                obs, gs = env.obs(env_states), env.global_state(env_states)
                a = act(state.actor, obs)
                z = (torch.randn(a.shape, generator=gen, device=dev) if draws is None
                     else draws['act'][t])
                a = torch.clamp(a + explore_noise * z, -1.0, 1.0)
                new, reward, terminal, truncate = env.step(
                    env_states, a, gen, None if draws is None else draws['env'][t])
                done = terminal | truncate
                fresh = env.init(gen, num_envs, dev, rollout_draws(draws, t))
                env_states = where_done(done, fresh, new)
                items.append((obs, gs, a, reward, 1.0 - done.float(), env.obs(env_states),
                              env.global_state(env_states)))
        items = [torch.stack(x) for x in zip(*items)]
        *data, ptr, size = state.buf
        idx = (ptr + torch.arange(horizon, device=dev)) % buf_size
        data = [d.index_put((idx,), x) for d, x in zip(data, items)]
        ptr = (ptr + horizon) % buf_size
        size = torch.clamp(size + horizon, max=buf_size)
        n_upd = max(1, horizon * repeat)
        s = max(int(size), 1)
        ids_all = (draws['ids'] if draws is not None else
                   torch.randint(0, int(size) * num_envs, (n_upd, batch_size), generator=gen,
                                 device=dev))
        actor, critic = state.actor, state.critic
        act_t_flat, cri_t_flat = state.act_target_flat, state.cri_target_flat
        a_opt, c_opt = state.a_opt, state.c_opt
        for u in range(n_upd):
            ids = ids_all[u].to(dev).long()
            i0, i1 = ids % s, ids // s
            obs, gs, acts, r, und, nobs, ngs = (d[i0, i1] for d in data)
            with torch.no_grad():
                next_a = act(tree_views(act_t_flat, actor), nobs)
                target = r + gamma * und * q_joint(tree_views(cri_t_flat, critic), ngs, next_a)

            def c_loss(cp):
                return torch.mean(torch.square(q_joint(cp, gs, acts) - target))

            _, g = tree_grad(c_loss, state.cri_flat, critic)
            c_opt = grad_step(optimizer, state.cri_flat, c_opt, g)
            cri_t_flat = soft_update(cri_t_flat, state.cri_flat, tau)

            def a_loss(ap):
                return -torch.mean(q_joint(critic, gs, act(ap, obs)))

            _, g = tree_grad(a_loss, state.act_flat, actor)
            a_opt = grad_step(optimizer, state.act_flat, a_opt, g)
            act_t_flat = soft_update(act_t_flat, state.act_flat, tau)
        new = state._replace(actor_target=tree_views(act_t_flat, actor),
                             critic_target=tree_views(cri_t_flat, critic), a_opt=a_opt,
                             c_opt=c_opt, buf=(*data, ptr, size), env_states=env_states,
                             act_target_flat=act_t_flat, cri_target_flat=cri_t_flat)
        return new, items[3].mean()

    def evaluate(state: MADDPGState, gen: torch.Generator, num_episodes: int = 16,
                 draws: Optional[dict] = None):
        return rollout_return(env, lambda obs: act(state.actor, obs), gen, num_episodes,
                              state.act_flat.device, draws)

    return init, train_round, evaluate


def train_maddpg(env: MultiAgentEnvDef, num_envs: int = 16, num_rounds: int = 80,
                 seed: int = 0, verbose: bool = True, device=None):
    """Train MADDPG on ``device`` (None: the card; without a GPU that raises
    and names ``device='cpu'``).  Returns ``(state, history)``.  The JAX
    package runs XLA ops here, the port PyTorch ops."""
    dev = trainer_device(device, 'train_maddpg')
    init, train_round, evaluate = make_maddpg(env, num_envs=num_envs, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = init(torch.Generator().manual_seed(seed))
    history = []
    for i in range(num_rounds):
        state, _ = train_round(state, gen)
        if (i + 1) % max(1, num_rounds // 8) == 0:
            score = float(evaluate(state, torch.Generator(device=dev).manual_seed(8000 + i)))
            history.append(score)
            if verbose:
                print(f'| maddpg round {i + 1}: eval avgR {score:9.3f}', flush=True)
    return state, history
