"""QMIX: cooperative multi-agent Q-learning with monotonic mixing,
counterpart of ``elegantrl_tpu/marl/qmix.py`` (``mixer='vdn'``: additive
mixing, VDN).

- a parameter-shared per-agent Q MLP over local obs;
- the mixer ``Q_tot = |w2(s)| . elu(|w1(s)| . q_agents + b1(s)) + b2(s)``
  (absolute hypernetwork weights: monotonic), or the sum of the agents' Q;
- epsilon-greedy team exploration, a transition replay ring ``(capacity,
  N, ...)``, double-Q targets, the Huber loss and soft target updates.

The JAX package runs no Pallas kernel here; on the card the port runs
PyTorch ops.  A round's draws come from one ``torch.Generator`` or from
``draws``: ``coin`` ``(H, N, M)`` exploration uniforms, ``rand`` ``(H, N,
M)`` random actions, ``env`` and ``reset`` (as ``marl/mappo.py``) and
``ids`` ``(G, B)`` ring ids.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..agents.base import AdamState, grad_step, make_optimizer
from ..ops.nets import soft_update
from .env import (MultiAgentEnvDef, flat_tree, mlp_tree_apply, mlp_tree_init, trainer_device,
                  tree_grad, tree_views, where_done)
from .mappo import rollout_draws, rollout_return


class QMixParams(NamedTuple):
    agent_q: list      # obs -> per-action Q
    hyper_w1: list     # state -> (M * mix_dim)
    hyper_b1: list     # state -> mix_dim
    hyper_w2: list     # state -> mix_dim
    hyper_b2: list     # state -> 1


class QMixState(NamedTuple):
    params: QMixParams      # views of flat
    target: QMixParams      # views of target_flat
    opt: AdamState
    flat: torch.Tensor
    target_flat: torch.Tensor


def hyper_init(gen: torch.Generator, state_dim: int, M: int, mix_dim: int) -> list:
    """The four one-layer hypernetworks of the mixer, as the JAX package
    initialises them (orthogonal, gain 0.05: early ``Q_tot`` near the mean of
    the agents' Q, so the agent nets get gradient from the first round)."""
    return [mlp_tree_init(gen, (state_dim, out), out_std=0.05)
            for out in (M * mix_dim, mix_dim, mix_dim, 1)]


def make_mixer(mixer: str, M: int, mix_dim: int):
    """``mix(p, q_taken (..., M), gs (..., S)) -> Q_tot (...)`` over params
    ``p`` with the hypernetworks ``hyper_w1 .. hyper_b2``."""
    def mix(p, q_taken, gs):
        if mixer == 'vdn':
            return torch.sum(q_taken, dim=-1)
        w1 = torch.abs(mlp_tree_apply(p.hyper_w1, gs)).reshape(gs.shape[:-1] + (M, mix_dim))
        b1 = mlp_tree_apply(p.hyper_b1, gs)
        w2 = torch.abs(mlp_tree_apply(p.hyper_w2, gs))
        b2 = mlp_tree_apply(p.hyper_b2, gs)[..., 0]
        h = F.elu(torch.einsum('...m,...md->...d', q_taken, w1) + b1)
        return torch.sum(h * w2, dim=-1) + b2
    return mix


def explore(gen, greedy, A: int, explore_rate: float, draws, t):
    """Epsilon-greedy over ``greedy`` (N, M): a uniform coin against
    ``explore_rate`` picks a uniform random action."""
    if draws is None:
        rand = torch.randint(0, A, greedy.shape, generator=gen, device=greedy.device)
        coin = torch.rand(greedy.shape, generator=gen, device=greedy.device)
    else:
        rand, coin = draws['rand'][t].to(greedy.device), draws['coin'][t]
    return torch.where(coin < explore_rate, rand.to(greedy.dtype), greedy)


def huber(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """optax's ``huber_loss`` with delta 1, elementwise."""
    return F.huber_loss(x, y, reduction='none', delta=1.0)


def make_qmix(env: MultiAgentEnvDef, net_dims=(64, 64), mix_dim: int = 32,
              gamma: float = 0.99, lr: float = 5e-4, tau: float = 5e-3,
              explore_rate: float = 0.2, mixer: str = 'qmix', buffer_len: int = 512,
              batch_size: int = 1024, grad_steps: int = 4, device=None):
    """``(init, init_buffer, train_round, evaluate)`` as the JAX package's;
    ``mixer`` 'qmix' or 'vdn', ``buffer_len`` the ring's capacity along time
    (each slot one transition of every env); the state and ring on
    ``device`` (None: the card; without a GPU that raises and names
    ``device='cpu'``)."""
    dev = trainer_device(device, 'make_qmix')
    assert env.if_discrete
    assert mixer in ('qmix', 'vdn')
    M, A = env.num_agents, env.action_dim
    optimizer = make_optimizer(lr, 3.0)
    mix = make_mixer(mixer, M, mix_dim)

    def init(gen: torch.Generator) -> QMixState:
        params = QMixParams(mlp_tree_init(gen, (env.obs_dim, *net_dims, A), out_std=0.1),
                            *hyper_init(gen, env.state_dim, M, mix_dim))
        flat, params = flat_tree(params, dev)
        target_flat = flat.clone()
        return QMixState(params, tree_views(target_flat, params),
                         AdamState(0, torch.zeros_like(flat), torch.zeros_like(flat)), flat,
                         target_flat)

    def agent_qs(p, obs):
        return mlp_tree_apply(p.agent_q, obs)

    def init_buffer(num_envs: int):
        """The replay ring: ``(buffer_len, N, ...)`` tensors, then ptr and size."""
        def z(shape, dtype=torch.float32):
            return torch.zeros((buffer_len, num_envs) + shape, dtype=dtype, device=dev)
        data = (z((M, env.obs_dim)), z((env.state_dim,)), z((M,), torch.int32), z(()), z(()),
                z((M, env.obs_dim)), z((env.state_dim,)))
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return (data, zero, zero.clone())

    def train_round(state: QMixState, env_states, buffer, gen: torch.Generator,
                    num_envs: int, horizon: int, draws: Optional[dict] = None):
        """The rollout into the ring, then ``grad_steps`` updates.  Returns
        ``(state, env_states, buffer, mean loss)``."""
        dev = state.flat.device
        batch = []
        with torch.no_grad():
            for t in range(horizon):
                obs, gs = env.obs(env_states), env.global_state(env_states)
                greedy = torch.argmax(agent_qs(state.params, obs), dim=-1)
                actions = explore(gen, greedy, A, explore_rate, draws, t).to(torch.int32)
                new, reward, terminal, truncate = env.step(
                    env_states, actions, gen, None if draws is None else draws['env'][t])
                done = terminal | truncate
                fresh = env.init(gen, num_envs, dev, rollout_draws(draws, t))
                env_states = where_done(done, fresh, new)
                batch.append((obs, gs, actions, reward, 1.0 - done.float(),
                              env.obs(env_states), env.global_state(env_states)))
        batch = [torch.stack(x) for x in zip(*batch)]
        data, ptr, size = buffer
        idx = (ptr + torch.arange(horizon, device=dev)) % buffer_len
        data = tuple(d.index_put((idx,), x) for d, x in zip(data, batch))
        ptr = (ptr + horizon) % buffer_len
        size = torch.clamp(size + horizon, max=buffer_len)
        s = int(size)
        ids_all = (draws['ids'] if draws is not None else
                   torch.randint(0, s * num_envs, (grad_steps, batch_size), generator=gen,
                                 device=dev))
        params, target_flat, opt, losses = state.params, state.target_flat, state.opt, []
        for g_step in range(grad_steps):
            ids = ids_all[g_step].to(dev).long()
            t_ids, n_ids = ids % s, ids // s
            obs, gs, acts, r, und, nobs, ngs = (d[t_ids, n_ids] for d in data)
            target = tree_views(target_flat, params)
            with torch.no_grad():
                # double-Q: the online net's argmax, valued by the target net
                n_act = torch.argmax(agent_qs(params, nobs), dim=-1)
                n_taken = torch.gather(agent_qs(target, nobs), -1, n_act[..., None])[..., 0]
                target_tot = r + gamma * und * mix(target, n_taken, ngs)

            def loss_fn(p):
                q = agent_qs(p, obs)
                taken = torch.gather(q, -1, acts.long()[..., None])[..., 0]
                return torch.mean(huber(mix(p, taken, gs), target_tot))

            loss, g = tree_grad(loss_fn, state.flat, params)
            opt = grad_step(optimizer, state.flat, opt, g)
            target_flat = soft_update(target_flat, state.flat, tau)
            losses.append(loss)
        new = state._replace(target=tree_views(target_flat, params), opt=opt,
                             target_flat=target_flat)
        return new, env_states, (data, ptr, size), torch.stack(losses).mean()

    def evaluate(state: QMixState, gen: torch.Generator, num_episodes: int = 16,
                 draws: Optional[dict] = None):
        return rollout_return(env, lambda obs: torch.argmax(agent_qs(state.params, obs), -1),
                              gen, num_episodes, state.flat.device, draws)

    return init, init_buffer, train_round, evaluate


def train_qmix(env: MultiAgentEnvDef, num_envs: int = 32, horizon: int = 64,
               num_rounds: int = 100, seed: int = 0, verbose: bool = True,
               mixer: str = 'qmix', device=None):
    """Train QMIX (or VDN) on ``device`` (None: the card; without a GPU that
    raises and names ``device='cpu'``).  Returns ``(state, history)``.  The
    JAX package runs XLA ops here, the port PyTorch ops."""
    dev = trainer_device(device, 'train_qmix')
    init, init_buffer, train_round, evaluate = make_qmix(env, mixer=mixer, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = init(torch.Generator().manual_seed(seed))
    env_states = env.init(gen, num_envs, dev)
    buffer = init_buffer(num_envs)
    history = []
    for i in range(num_rounds):
        state, env_states, buffer, _ = train_round(state, env_states, buffer, gen, num_envs,
                                                   horizon)
        if (i + 1) % max(1, num_rounds // 8) == 0:
            score = float(evaluate(state, torch.Generator(device=dev).manual_seed(7000 + i)))
            history.append(score)
            if verbose:
                print(f'| qmix round {i + 1}: eval avgR {score:9.3f}', flush=True)
    return state, history
