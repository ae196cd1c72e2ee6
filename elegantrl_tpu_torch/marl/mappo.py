"""MAPPO: multi-agent PPO with a centralized critic (CTDE), counterpart of
``elegantrl_tpu/marl/mappo.py``.

- one parameter-shared Gaussian MLP actor over every agent's local obs;
- a critic over the global state; the shared team reward drives one GAE
  stream per env;
- the PPO clipped surrogate with per-agent ratios, averaged over agents.

The JAX package runs no Pallas kernel here (its round is one jitted XLA
program); on the card the port runs PyTorch ops, as on the CPU.  Every
draw of a round comes from one ``torch.Generator`` or from ``draws`` (the
JAX draws, for tests): ``act`` ``(H, N, M, A)`` action normals, ``env``
``(H, N, dim)`` walker uniforms, ``reset`` the fresh envs' normals
``((H, N, dim), (H, N, M, dim))`` and ``ids`` ``(U, B)`` minibatch ids.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..agents.base import AdamState, grad_step, make_optimizer
from ..ops import dists
from ..ops.gae import gae_vtrace
from .env import (MultiAgentEnvDef, flat_tree, mlp_tree_apply, mlp_tree_init, trainer_device,
                  tree_grad, where_done)


class MAPPOState(NamedTuple):
    actor: dict            # {'mlp': [(w, b), ...], 'std_log': (1, A)}: views of act_flat
    critic: list           # views of cri_flat
    act_opt: AdamState
    cri_opt: AdamState
    act_flat: torch.Tensor
    cri_flat: torch.Tensor


def _draw(draws, name, t, make):
    """Draw ``name`` at step ``t`` from ``draws`` when given, else ``make()``."""
    return make() if draws is None else draws[name][t]


def rollout_draws(draws, t):
    """The env's reset normals of step ``t`` from ``draws`` (None: draw)."""
    return None if draws is None else tuple(x[t] for x in draws['reset'])


def make_mappo(env: MultiAgentEnvDef, net_dims=(128, 128), args=None, device=None):
    """``(init, train_round, evaluate, greedy)`` as the JAX package's, the
    state on ``device`` (None: the card; without a GPU that raises and names
    ``device='cpu'``)."""
    dev = trainer_device(device, 'make_mappo')
    gamma = float(getattr(args, 'gamma', 0.99))
    lam = float(getattr(args, 'lambda_gae_adv', 0.95))
    clip = float(getattr(args, 'ratio_clip', 0.25))
    lr = float(getattr(args, 'learning_rate', 3e-4))
    lambda_entropy = float(getattr(args, 'lambda_entropy', 0.001))
    clip_grad = float(getattr(args, 'clip_grad_norm', 3.0))
    optimizer = make_optimizer(lr, clip_grad)
    M, A = env.num_agents, env.action_dim

    def init(gen: torch.Generator) -> MAPPOState:
        """The nets as the JAX package initialises them, drawn from ``gen`` (a
        CPU generator, as ``torch.nn.init`` takes)."""
        actor = {'mlp': mlp_tree_init(gen, (env.obs_dim, *net_dims, A), out_std=0.1),
                 'std_log': torch.zeros((1, A))}
        critic = mlp_tree_init(gen, (env.state_dim, *net_dims, 1), out_std=0.5)
        act_flat, actor = flat_tree(actor, dev)
        cri_flat, critic = flat_tree(critic, dev)
        z = torch.zeros_like
        return MAPPOState(actor, critic, AdamState(0, z(act_flat), z(act_flat)),
                          AdamState(0, z(cri_flat), z(cri_flat)), act_flat, cri_flat)

    def greedy(actor, obs):
        return torch.tanh(mlp_tree_apply(actor['mlp'], obs))

    def train_round(state: MAPPOState, env_states, gen: torch.Generator, num_envs: int,
                    horizon: int, batch_size: int, repeat_times: int,
                    draws: Optional[dict] = None):
        """One round: the rollout, GAE, then ``H N repeat / B`` SGD steps of
        the critic and the actor.  Returns ``(state, env_states, mean
        reward)``."""
        dev = state.act_flat.device
        obs_l, gs_l, act_l, logp_l, rew_l, und_l = ([] for _ in range(6))
        std = torch.exp(state.actor['std_log'])
        with torch.no_grad():
            for t in range(horizon):
                obs = env.obs(env_states)                           # (N, M, O)
                gs = env.global_state(env_states)                   # (N, S)
                mean = mlp_tree_apply(state.actor['mlp'], obs)
                z = _draw(draws, 'act', t, lambda: torch.randn(mean.shape, generator=gen,
                                                               device=dev))
                a = mean + std * z
                logp = torch.sum(dists.normal_logprob(a, mean, std), dim=-1)   # (N, M)
                new_states, reward, terminal, truncate = env.step(
                    env_states, torch.tanh(a), gen,
                    None if draws is None else draws['env'][t])
                done = terminal | truncate
                fresh = env.init(gen, num_envs, dev, rollout_draws(draws, t))
                env_states = where_done(done, fresh, new_states)
                obs_l.append(obs), gs_l.append(gs), act_l.append(a), logp_l.append(logp)
                rew_l.append(reward), und_l.append(1.0 - done.float())
            OBS, GS, ACT, LOGP, R, U = map(torch.stack, (obs_l, gs_l, act_l, logp_l, rew_l,
                                                         und_l))
            V = mlp_tree_apply(state.critic, GS)[..., 0]
            next_v = mlp_tree_apply(state.critic, env.global_state(env_states))[..., 0]
            adv = gae_vtrace(R, U, V, next_v, gamma, lam)
            target = adv + V
            adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-5)

        n_upd = max(1, horizon * num_envs * repeat_times // batch_size)
        ids_all = (draws['ids'] if draws is not None else
                   torch.randint(0, horizon * num_envs, (n_upd, batch_size), generator=gen,
                                 device=dev))
        actor, critic = state.actor, state.critic
        a_opt, c_opt = state.act_opt, state.cri_opt
        for u in range(n_upd):
            ids = ids_all[u].to(dev).long()
            i0, i1 = ids % horizon, ids // horizon
            obs_b, gs_b, act_b, logp_b = OBS[i0, i1], GS[i0, i1], ACT[i0, i1], LOGP[i0, i1]
            adv_b, tgt_b = adv[i0, i1], target[i0, i1]

            def c_loss(cp):
                v = mlp_tree_apply(cp, gs_b)[..., 0]
                return torch.mean(torch.square(v - tgt_b))

            _, g = tree_grad(c_loss, state.cri_flat, critic)
            c_opt = grad_step(optimizer, state.cri_flat, c_opt, g)

            def a_loss(ap):
                mean = mlp_tree_apply(ap['mlp'], obs_b)
                sd = torch.exp(ap['std_log'])
                new_logp = torch.sum(dists.normal_logprob(act_b, mean, sd), -1)
                ratio = torch.exp(new_logp - logp_b)                 # (B, M)
                surr = torch.minimum(adv_b[:, None] * ratio,
                                     adv_b[:, None] * torch.clamp(ratio, 1 - clip, 1 + clip))
                ent = torch.sum(dists.normal_entropy(sd.expand_as(mean)), -1)
                return -(torch.mean(surr) - lambda_entropy * torch.mean(ent))

            _, g = tree_grad(a_loss, state.act_flat, actor)
            a_opt = grad_step(optimizer, state.act_flat, a_opt, g)
        return state._replace(act_opt=a_opt, cri_opt=c_opt), env_states, R.mean()

    def evaluate(state: MAPPOState, gen: torch.Generator, num_episodes: int = 16,
                 draws: Optional[dict] = None):
        """The greedy policy's mean return over ``num_episodes`` episodes of
        up to ``max_step`` steps; ``draws``: ``init`` normals and ``env``
        ``(max_step, E, dim)`` uniforms."""
        return rollout_return(env, lambda obs: greedy(state.actor, obs), gen, num_episodes,
                              state.act_flat.device, draws)

    return init, train_round, evaluate, greedy


def rollout_return(env: MultiAgentEnvDef, policy, gen, num_episodes: int, device,
                   draws: Optional[dict] = None, step_hidden=None, hidden=None):
    """Mean return of ``policy(obs)`` over ``num_episodes`` fresh episodes
    of up to ``max_step`` steps, each env frozen once done (the JAX
    evaluators' loop).  A recurrent policy passes ``step_hidden(h, obs) ->
    (h', action)`` and its zero ``hidden`` instead; a done episode keeps
    its hidden state."""
    with torch.no_grad():
        states = env.init(gen, num_episodes, device, None if draws is None else draws['init'])
        done = torch.zeros(num_episodes, dtype=torch.bool, device=device)
        ret = torch.zeros(num_episodes, device=device)
        h = hidden
        for t in range(env.max_step):
            obs = env.obs(states)
            if step_hidden is None:
                a = policy(obs)
            else:
                h2, a = step_hidden(h, obs)
                h = torch.where(done.reshape((-1,) + (1,) * (h.dim() - 1)), h, h2)
            new, reward, terminal, truncate = env.step(
                states, a, gen, None if draws is None else draws['env'][t])
            ret = ret + reward * (~done).float()
            states = where_done(done, states, new)
            done = done | terminal | truncate
    return ret.mean()


def train_mappo(env: MultiAgentEnvDef, args=None, num_envs: int = 64, horizon: int = 128,
                batch_size: int = 512, repeat_times: int = 16, num_rounds: int = 40,
                seed: int = 0, verbose: bool = True, device=None):
    """Train MAPPO for ``num_rounds`` rounds on ``device`` (None: the card;
    without a GPU that raises and names ``device='cpu'``).  The JAX package
    runs XLA ops here, the port PyTorch ops.  Returns ``(state, history)``, the evaluations of
    eight evenly spaced rounds."""
    dev = trainer_device(device, 'train_mappo')
    init, train_round, evaluate, _ = make_mappo(env, args=args, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = init(torch.Generator().manual_seed(seed))
    env_states = env.init(gen, num_envs, dev)
    history = []
    for i in range(num_rounds):
        state, env_states, _ = train_round(state, env_states, gen, num_envs, horizon,
                                           batch_size, repeat_times)
        if (i + 1) % max(1, num_rounds // 8) == 0:
            score = float(evaluate(state, torch.Generator(device=dev).manual_seed(9000 + i)))
            history.append(score)
            if verbose:
                print(f'| mappo round {i + 1}: eval avgR {score:9.3f}', flush=True)
    return state, history
