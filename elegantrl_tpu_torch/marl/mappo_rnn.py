"""Recurrent MAPPO: GRU policies with PopArt value normalization (CTDE),
counterpart of ``elegantrl_tpu/marl/mappo_rnn.py``.

- one parameter-shared GRU actor over the agent axis, and a recurrent
  critic over the global state with a PopArt head: it predicts normalized
  values, the return statistics are updated once a round and the head is
  rescaled so that its unnormalized predictions are kept;
- full-rollout BPTT: updates sample whole env sequences and re-run the GRUs
  from the stored round-initial hidden state, with the resets at episode
  boundaries replayed from the stored done mask.

The JAX package runs no Pallas kernel here; on the card the port runs
PyTorch ops.  A round's draws come from one ``torch.Generator`` or from
``draws``: ``act``, ``env``, ``reset`` (as ``marl/mappo.py``) and ``ids``
``(U, seq_batch)`` env ids.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..agents.base import AdamState, grad_step, make_optimizer
from ..ops import dists
from ..ops.gae import gae_vtrace
from .env import (MultiAgentEnvDef, dense_init, flat_tree, mlp_tree_apply, mlp_tree_init,
                  trainer_device, tree_grad, where_done)
from .mappo import rollout_draws, rollout_return


# ---------------------------------------------------------------- GRU cell

def gru_init(gen: torch.Generator, in_dim: int, hid: int) -> dict:
    """The reset, update and candidate gates, each ``{'w': (in + hid, hid),
    'b': (hid,)}`` as the JAX package's ``linear_init`` draws them."""
    def gate():
        w, b = dense_init(gen, in_dim + hid, hid)
        return {'w': w, 'b': b}
    return {'r': gate(), 'z': gate(), 'n': gate()}


def gru_step(p: dict, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``h' = GRU(h, x)``; h (..., hid), x (..., in_dim)."""
    xh = torch.cat([x, h], dim=-1)
    r = torch.sigmoid(xh @ p['r']['w'] + p['r']['b'])
    z = torch.sigmoid(xh @ p['z']['w'] + p['z']['b'])
    n = torch.tanh(torch.cat([x, r * h], dim=-1) @ p['n']['w'] + p['n']['b'])
    return (1.0 - z) * n + z * h


# ---------------------------------------------------------------- PopArt

class PopArt(NamedTuple):
    mu: torch.Tensor      # ()
    nu: torch.Tensor      # () second moment
    w: torch.Tensor       # (hid, 1) normalized-value head
    b: torch.Tensor       # (1,)

    @property
    def sigma(self):
        return torch.sqrt(torch.clamp(self.nu - self.mu ** 2, min=1e-4))


def popart_update(pa: PopArt, targets: torch.Tensor, beta: float = 3e-4) -> PopArt:
    """EMA the return statistics once a round and rescale the head so its
    unnormalized outputs are kept."""
    mu2 = (1 - beta) * pa.mu + beta * targets.mean()
    nu2 = (1 - beta) * pa.nu + beta * torch.mean(targets ** 2)
    old_sigma = pa.sigma
    new = PopArt(mu2, nu2, pa.w, pa.b)
    scale = old_sigma / new.sigma
    return PopArt(mu2, nu2, pa.w * scale, (old_sigma * pa.b + pa.mu - mu2) / new.sigma)


class MAPPORnnState(NamedTuple):
    actor: dict       # {'emb', 'gru', 'head', 'std_log'}: views of act_flat
    critic: dict      # {'emb', 'gru', 'popart'}: views of cri_flat
    act_opt: AdamState
    cri_opt: AdamState
    act_flat: torch.Tensor
    cri_flat: torch.Tensor


def make_mappo_rnn(env: MultiAgentEnvDef, hid: int = 64, args=None, device=None):
    """``(init, train_round, evaluate)`` as the JAX package's, the state on
    ``device`` (None: the card; without a GPU that raises and names
    ``device='cpu'``)."""
    dev = trainer_device(device, 'make_mappo_rnn')
    gamma = float(getattr(args, 'gamma', 0.99))
    lam = float(getattr(args, 'lambda_gae_adv', 0.95))
    clip = float(getattr(args, 'ratio_clip', 0.25))
    lr = float(getattr(args, 'learning_rate', 3e-4))
    lambda_entropy = float(getattr(args, 'lambda_entropy', 0.001))
    clip_grad = float(getattr(args, 'clip_grad_norm', 3.0))
    optimizer = make_optimizer(lr, clip_grad)
    M, A = env.num_agents, env.action_dim

    def init(gen: torch.Generator) -> MAPPORnnState:
        actor = {'emb': mlp_tree_init(gen, (env.obs_dim, hid)), 'gru': gru_init(gen, hid, hid),
                 'head': mlp_tree_init(gen, (hid, A), out_std=0.1),
                 'std_log': torch.zeros((1, A))}
        emb, gru = mlp_tree_init(gen, (env.state_dim, hid)), gru_init(gen, hid, hid)
        w = dense_init(gen, hid, 1, out_std=0.5)[0]
        critic = {'emb': emb, 'gru': gru,
                  'popart': PopArt(torch.zeros(()), torch.ones(()), w, torch.zeros((1,)))}
        act_flat, actor = flat_tree(actor, dev)
        cri_flat, critic = flat_tree(critic, dev)
        z = torch.zeros_like
        return MAPPORnnState(actor, critic, AdamState(0, z(act_flat), z(act_flat)),
                             AdamState(0, z(cri_flat), z(cri_flat)), act_flat, cri_flat)

    def actor_cell(ap, h, obs):
        """One recurrent actor step: obs (..., M, O), h (..., M, hid)."""
        h2 = gru_step(ap['gru'], h, torch.tanh(mlp_tree_apply(ap['emb'], obs)))
        return h2, mlp_tree_apply(ap['head'], torch.tanh(h2))

    def critic_cell(cp, h, gs, normalized: bool):
        """One recurrent critic step: gs (..., S), h (..., hid)."""
        h2 = gru_step(cp['gru'], h, torch.tanh(mlp_tree_apply(cp['emb'], gs)))
        pa = cp['popart']
        v_norm = (torch.tanh(h2) @ pa.w)[..., 0] + pa.b[0]
        return h2, v_norm if normalized else v_norm * pa.sigma + pa.mu

    def train_round(state: MAPPORnnState, env_states, hiddens, gen: torch.Generator,
                    num_envs: int, horizon: int, seq_batch: int, repeat_times: int,
                    draws: Optional[dict] = None):
        """Returns ``(state, env_states, (h_act, h_cri), mean reward)``."""
        dev = state.act_flat.device
        h_act0, h_cri0 = hiddens
        h_act, h_cri = h_act0, h_cri0
        seq = []
        std = torch.exp(state.actor['std_log'])
        with torch.no_grad():
            for t in range(horizon):
                obs, gs = env.obs(env_states), env.global_state(env_states)
                h_act2, mean = actor_cell(state.actor, h_act, obs)
                z = (torch.randn(mean.shape, generator=gen, device=dev) if draws is None
                     else draws['act'][t])
                a = mean + std * z
                logp = torch.sum(dists.normal_logprob(a, mean, std), dim=-1)
                h_cri2, v = critic_cell(state.critic, h_cri, gs, normalized=False)
                new, reward, terminal, truncate = env.step(
                    env_states, torch.tanh(a), gen, None if draws is None else draws['env'][t])
                done = terminal | truncate
                fresh = env.init(gen, num_envs, dev, rollout_draws(draws, t))
                env_states = where_done(done, fresh, new)
                undone = 1.0 - done.float()
                h_act = h_act2 * undone[:, None, None]   # reset at episode boundaries
                h_cri = h_cri2 * undone[:, None]
                seq.append((obs, gs, a, logp, v, reward, undone))
            OBS, GS, ACT, LOGP, V, R, U = (torch.stack(x) for x in zip(*seq))
            _, next_v = critic_cell(state.critic, h_cri, env.global_state(env_states), False)
            adv = gae_vtrace(R, U, V, next_v, gamma, lam)
            target = adv + V
            adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-5)
            # PopArt: the statistics once a round, the head rescaled in place
            pa = popart_update(state.critic['popart'], target)
            for old, new in zip(state.critic['popart'], pa):
                old.copy_(new)
            tgt_norm = (target - pa.mu) / pa.sigma

        n_upd = max(1, num_envs * repeat_times // seq_batch)
        ids_all = (draws['ids'] if draws is not None else
                   torch.randint(0, num_envs, (n_upd, seq_batch), generator=gen, device=dev))
        actor, critic = state.actor, state.critic
        a_opt, c_opt = state.act_opt, state.cri_opt
        for k in range(n_upd):
            ids = ids_all[k].to(dev).long()
            obs_s, gs_s, act_s, logp_s = OBS[:, ids], GS[:, ids], ACT[:, ids], LOGP[:, ids]
            adv_s, tgt_s, u_s = adv[:, ids], tgt_norm[:, ids], U[:, ids]
            ha0, hc0 = h_act0[ids], h_cri0[ids]

            def c_loss(cp):
                h, vs = hc0, []
                for t in range(horizon):
                    h2, v = critic_cell(cp, h, gs_s[t], normalized=True)
                    h = h2 * u_s[t][:, None]
                    vs.append(v)
                return torch.mean(torch.square(torch.stack(vs) - tgt_s))

            _, g = tree_grad(c_loss, state.cri_flat, critic)
            c_opt = grad_step(optimizer, state.cri_flat, c_opt, g)

            def a_loss(ap):
                h, means = ha0, []
                for t in range(horizon):
                    h2, mean = actor_cell(ap, h, obs_s[t])
                    h = h2 * u_s[t][:, None, None]
                    means.append(mean)
                mean_seq = torch.stack(means)
                sd = torch.exp(ap['std_log'])
                new_logp = torch.sum(dists.normal_logprob(act_s, mean_seq, sd), -1)
                ratio = torch.exp(new_logp - logp_s)                       # (H, B, M)
                surr = torch.minimum(adv_s[..., None] * ratio,
                                     adv_s[..., None] * torch.clamp(ratio, 1 - clip, 1 + clip))
                ent = torch.sum(dists.normal_entropy(sd.expand_as(mean_seq)), -1)
                return -(torch.mean(surr) - lambda_entropy * torch.mean(ent))

            _, g = tree_grad(a_loss, state.act_flat, actor)
            a_opt = grad_step(optimizer, state.act_flat, a_opt, g)
        return (state._replace(act_opt=a_opt, cri_opt=c_opt), env_states, (h_act, h_cri),
                R.mean())

    def evaluate(state: MAPPORnnState, gen: torch.Generator, num_episodes: int = 16,
                 draws: Optional[dict] = None):
        dev = state.act_flat.device

        def step_hidden(h, obs):
            h2, mean = actor_cell(state.actor, h, obs)
            return h2, torch.tanh(mean)
        return rollout_return(env, None, gen, num_episodes, dev, draws, step_hidden,
                              torch.zeros((num_episodes, M, hid), device=dev))

    return init, train_round, evaluate


def train_mappo_rnn(env: MultiAgentEnvDef, args=None, num_envs: int = 64, horizon: int = 128,
                    seq_batch: int = 16, repeat_times: int = 4, num_rounds: int = 40,
                    hid: int = 64, seed: int = 0, verbose: bool = True, device=None):
    """Train the recurrent MAPPO on ``device`` (None: the card; without a GPU
    that raises and names ``device='cpu'``).  Returns ``(state, history)``.
    The JAX package runs XLA ops here, the port PyTorch ops."""
    dev = trainer_device(device, 'train_mappo_rnn')
    init, train_round, evaluate = make_mappo_rnn(env, hid=hid, args=args, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = init(torch.Generator().manual_seed(seed))
    env_states = env.init(gen, num_envs, dev)
    hiddens = (torch.zeros((num_envs, env.num_agents, hid), device=dev),
               torch.zeros((num_envs, hid), device=dev))
    history = []
    for i in range(num_rounds):
        state, env_states, hiddens, _ = train_round(state, env_states, hiddens, gen, num_envs,
                                                    horizon, seq_batch, repeat_times)
        if (i + 1) % max(1, num_rounds // 8) == 0:
            score = float(evaluate(state, torch.Generator(device=dev).manual_seed(9000 + i)))
            history.append(score)
            if verbose:
                print(f'| mappo_rnn round {i + 1}: eval avgR {score:9.3f}', flush=True)
    return state, history
