"""Recurrent QMIX: GRU agent networks with TD(λ) targets over sequences,
counterpart of ``elegantrl_tpu/marl/qmix_rnn.py``.

- one parameter-shared GRU Q-network over the agent axis
  (``marl/mappo_rnn.py:gru_step``);
- a sequence replay ring: each slot holds one whole round ``(horizon + 1,
  N, ...)`` and the round-initial hidden state, so updates re-run the GRU
  from true stored hiddens with the episode resets replayed;
- TD(λ) targets from a reverse pass over the mixed target values, ``y_t =
  r_t + γ u_t ((1 - λ) Q̄_tot(t + 1) + λ y_{t + 1})``, bootstrapped from
  ``Q̄_tot(H)``; double-Q action selection and the monotonic mixer of
  ``marl/qmix.py``.

The JAX package runs no Pallas kernel here; on the card the port runs
PyTorch ops.  A round's draws come from one ``torch.Generator`` or from
``draws``: ``coin``, ``rand``, ``env`` and ``reset`` (as
``marl/qmix.py``), then per update ``slot`` ``(G,)`` and ``ids`` ``(G,
seq_batch)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..agents.base import AdamState, grad_step, make_optimizer
from ..ops.nets import soft_update
from .env import (MultiAgentEnvDef, flat_tree, mlp_tree_apply, mlp_tree_init, trainer_device,
                  tree_grad, tree_views, where_done)
from .mappo import rollout_draws, rollout_return
from .mappo_rnn import gru_init, gru_step
from .qmix import explore, huber, hyper_init, make_mixer


class QMixRnnParams(NamedTuple):
    emb: list          # obs -> hid embedding
    gru: dict          # GRU cell
    head: list         # hid -> per-action Q
    hyper_w1: list     # state -> (M * mix_dim)
    hyper_b1: list     # state -> mix_dim
    hyper_w2: list     # state -> mix_dim
    hyper_b2: list     # state -> 1


class QMixRnnState(NamedTuple):
    params: QMixRnnParams     # views of flat
    target: QMixRnnParams     # views of target_flat
    opt: AdamState
    flat: torch.Tensor
    target_flat: torch.Tensor


def make_qmix_rnn(env: MultiAgentEnvDef, hid: int = 64, mix_dim: int = 32,
                  gamma: float = 0.99, lam: float = 0.6, lr: float = 5e-4, tau: float = 5e-3,
                  explore_rate: float = 0.2, mixer: str = 'qmix', slots: int = 8,
                  seq_batch: int = 16, grad_steps: int = 2, device=None):
    """``(init, init_buffer, train_round, evaluate)`` as the JAX package's;
    ``slots`` whole rounds of replay, ``seq_batch`` env sequences an update,
    ``lam`` the TD(λ) coefficient; the state and ring on ``device`` (None:
    the card; without a GPU that raises and names ``device='cpu'``)."""
    dev = trainer_device(device, 'make_qmix_rnn')
    assert env.if_discrete
    assert mixer in ('qmix', 'vdn')
    M, A = env.num_agents, env.action_dim
    optimizer = make_optimizer(lr, 3.0)
    mix = make_mixer(mixer, M, mix_dim)

    def init(gen: torch.Generator) -> QMixRnnState:
        params = QMixRnnParams(mlp_tree_init(gen, (env.obs_dim, hid)), gru_init(gen, hid, hid),
                               mlp_tree_init(gen, (hid, A), out_std=0.1),
                               *hyper_init(gen, env.state_dim, M, mix_dim))
        flat, params = flat_tree(params, dev)
        target_flat = flat.clone()
        return QMixRnnState(params, tree_views(target_flat, params),
                            AdamState(0, torch.zeros_like(flat), torch.zeros_like(flat)), flat,
                            target_flat)

    def q_cell(p, h, obs):
        """One recurrent Q step: obs (..., M, O), h (..., M, hid)."""
        h2 = gru_step(p.gru, h, torch.tanh(mlp_tree_apply(p.emb, obs)))
        return h2, mlp_tree_apply(p.head, h2)

    def init_buffer(num_envs: int, horizon: int):
        """The sequence ring: ``(slots, horizon [+ 1], N, ...)`` tensors and
        the round-initial hiddens, then ptr and size."""
        def z(lead, shape, dtype=torch.float32):
            return torch.zeros((slots, lead, num_envs) + shape, dtype=dtype, device=dev)
        data = (z(horizon + 1, (M, env.obs_dim)), z(horizon + 1, (env.state_dim,)),
                z(horizon, (M,), torch.int32), z(horizon, ()), z(horizon, ()),
                torch.zeros((slots, num_envs, M, hid), device=dev))
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return (data, zero, zero.clone())

    def train_round(state: QMixRnnState, env_states, h0, buffer, gen: torch.Generator,
                    num_envs: int, horizon: int, draws: Optional[dict] = None):
        """Returns ``(state, env_states, h_end, buffer, mean loss)``."""
        dev = state.flat.device
        h, seq = h0, []
        with torch.no_grad():
            for t in range(horizon):
                obs, gs = env.obs(env_states), env.global_state(env_states)
                h2, q = q_cell(state.params, h, obs)
                actions = explore(gen, torch.argmax(q, dim=-1), A, explore_rate, draws,
                                  t).to(torch.int32)
                new, reward, terminal, truncate = env.step(
                    env_states, actions, gen, None if draws is None else draws['env'][t])
                done = terminal | truncate
                fresh = env.init(gen, num_envs, dev, rollout_draws(draws, t))
                env_states = where_done(done, fresh, new)
                undone = 1.0 - done.float()
                h = h2 * undone[:, None, None]      # reset at episode boundaries
                seq.append((obs, gs, actions, reward, undone))
        OBS, GS, ACT, R, U = (torch.stack(x) for x in zip(*seq))
        # the post-rollout obs and state, so sequences hold t = 0 .. H
        OBS = torch.cat([OBS, env.obs(env_states)[None]], 0)
        GS = torch.cat([GS, env.global_state(env_states)[None]], 0)
        data, ptr, size = buffer
        data = tuple(d.index_put((ptr.long(),), x)
                     for d, x in zip(data, (OBS, GS, ACT, R, U, h0)))
        ptr = (ptr + 1) % slots
        size = torch.clamp(size + 1, max=slots)
        if draws is None:
            slot_all = torch.randint(0, int(size), (grad_steps,), generator=gen, device=dev)
            ids_all = torch.randint(0, num_envs, (grad_steps, seq_batch), generator=gen,
                                    device=dev)
        else:
            slot_all, ids_all = draws['slot'], draws['ids']
        params, target_flat, opt, losses = state.params, state.target_flat, state.opt, []
        for g_step in range(grad_steps):
            slot, ids = int(slot_all[g_step]), ids_all[g_step].to(dev).long()
            obs_s, gs_s = data[0][slot][:, ids], data[1][slot][:, ids]
            act_s, r_s, u_s = data[2][slot][:, ids], data[3][slot][:, ids], data[4][slot][:, ids]
            hb0 = data[5][slot][ids]
            # the undone mask entering step t (a reset after step t - 1)
            u_in = torch.cat([torch.ones_like(u_s[:1]), u_s], 0)     # (H + 1, B)
            target = tree_views(target_flat, params)

            def rescan(p):
                hh, qs = hb0, []
                for t in range(horizon + 1):
                    hh, q = q_cell(p, hh * u_in[t][:, None, None], obs_s[t])
                    qs.append(q)
                return torch.stack(qs)                               # (H + 1, B, M, A)

            with torch.no_grad():
                q_tgt = rescan(target)

            def loss_fn(p):
                q_seq = rescan(p)
                with torch.no_grad():
                    # double-Q: the online argmax picks, the target net values
                    n_act = torch.argmax(q_seq[1:], dim=-1)
                    n_taken = torch.gather(q_tgt[1:], -1, n_act[..., None])[..., 0]
                    qbar = mix(target, n_taken, gs_s[1:])             # (H, B)
                    ys, y = [], qbar[-1]
                    for t in reversed(range(horizon)):              # TD(lambda)
                        y = r_s[t] + gamma * u_s[t] * ((1 - lam) * qbar[t] + lam * y)
                        ys.append(y)
                    ys = torch.stack(ys[::-1])
                taken = torch.gather(q_seq[:-1], -1, act_s.long()[..., None])[..., 0]
                return torch.mean(huber(mix(p, taken, gs_s[:-1]), ys))

            loss, g = tree_grad(loss_fn, state.flat, params)
            opt = grad_step(optimizer, state.flat, opt, g)
            target_flat = soft_update(target_flat, state.flat, tau)
            losses.append(loss)
        new = state._replace(target=tree_views(target_flat, params), opt=opt,
                             target_flat=target_flat)
        return new, env_states, h, (data, ptr, size), torch.stack(losses).mean()

    def evaluate(state: QMixRnnState, gen: torch.Generator, num_episodes: int = 16,
                 draws: Optional[dict] = None):
        dev = state.flat.device

        def step_hidden(h, obs):
            h2, q = q_cell(state.params, h, obs)
            return h2, torch.argmax(q, dim=-1)
        return rollout_return(env, None, gen, num_episodes, dev, draws, step_hidden,
                              torch.zeros((num_episodes, M, hid), device=dev))

    return init, init_buffer, train_round, evaluate


def train_qmix_rnn(env: MultiAgentEnvDef, num_envs: int = 32, horizon: int = 64,
                   num_rounds: int = 100, seed: int = 0, verbose: bool = True,
                   mixer: str = 'qmix', lam: float = 0.6, hid: int = 64, device=None):
    """Train the recurrent QMIX on ``device`` (None: the card; without a GPU
    that raises and names ``device='cpu'``).  Returns ``(state, history)``.
    The JAX package runs XLA ops here, the port PyTorch ops."""
    dev = trainer_device(device, 'train_qmix_rnn')
    init, init_buffer, train_round, evaluate = make_qmix_rnn(env, hid=hid, mixer=mixer, lam=lam,
                                                             device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = init(torch.Generator().manual_seed(seed))
    env_states = env.init(gen, num_envs, dev)
    h = torch.zeros((num_envs, env.num_agents, hid), device=dev)
    buffer = init_buffer(num_envs, horizon)
    history = []
    for i in range(num_rounds):
        state, env_states, h, buffer, _ = train_round(state, env_states, h, buffer, gen,
                                                      num_envs, horizon)
        if (i + 1) % max(1, num_rounds // 8) == 0:
            score = float(evaluate(state, torch.Generator(device=dev).manual_seed(7100 + i)))
            history.append(score)
            if verbose:
                print(f'| qmix_rnn round {i + 1}: eval avgR {score:9.3f}', flush=True)
    return state, history
