"""S2V-DQN: graph-RL MaxCut solver (counterpart of
``elegantrl_tpu/rlsolver/s2v_dqn.py``; "Learning Combinatorial
Optimization Algorithms over Graphs").

An MPNN embeds each node, a Q head scores each node's flip, and an
epsilon-greedy agent flips nodes to raise the cut, trained by one-step
Q-learning over a horizon of parallel episodes; the reward is the cut's
improvement over the best seen this episode.  The message passing is dense
adjacency products batched over the episodes, on the simulator's device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops.nets import soft_update
from . import _learn
from ._draws import as_draws
from .maxcut import MaxCutSimulator

_OBS_DIM = 3  # per-node features: spin, normalized flip gain, best-gain flag


class S2VParams(NamedTuple):
    w_in: torch.Tensor    # (OBS, D) node-feature lift
    w_msg: torch.Tensor   # (D, D) neighbour aggregation
    w_self: torch.Tensor  # (D, D)
    w_q1: torch.Tensor    # (2D, D) q head layer 1
    w_q2: torch.Tensor    # (D, 1)


class S2VState(NamedTuple):
    params: S2VParams
    target: S2VParams
    opt: tuple


def _init_params(gen, dim: int, device) -> S2VParams:
    g = _learn.init_generator(gen)
    return S2VParams(
        w_in=_learn.orthogonal(g, (_OBS_DIM, dim), device),
        w_msg=_learn.orthogonal(g, (dim, dim), device, 0.5),
        w_self=_learn.orthogonal(g, (dim, dim), device, 0.5),
        w_q1=_learn.orthogonal(g, (2 * dim, dim), device),
        w_q2=_learn.orthogonal(g, (dim, 1), device, 0.1))


def make_s2v_dqn(sim: MaxCutSimulator, embed_dim: int = 64, msg_rounds: int = 3,
                 gamma: float = 0.95, lr: float = 1e-3):
    """Returns ``(init, q_values, train_round, solve)`` over
    :class:`S2VState`, on the simulator's device."""
    adj = sim.adj
    dev = sim.device
    deg = torch.sum(adj, dim=-1) + 1e-6
    opt = _learn.adam(lr, clip=3.0)

    def node_obs(xs):
        """``(S, N, OBS)``: spin, normalized flip gain, is-best-gain flag."""
        gains = sim.flip_gains(xs) / deg
        best = (gains >= torch.max(gains, dim=-1, keepdim=True).values).to(torch.float32)
        return torch.stack([2.0 * xs - 1.0, gains, best], dim=-1)

    def q_values(params: S2VParams, xs):
        """``(S, N)`` per-node Q: the MPNN over the dense adjacency."""
        h = torch.relu(node_obs(xs) @ params.w_in)                  # (S, N, D)
        for _ in range(msg_rounds):
            msg = torch.einsum('ij,sjd->sid', adj, h) / deg[None, :, None]
            h = torch.relu(h @ params.w_self + msg @ params.w_msg)
        pooled = torch.mean(h, dim=1, keepdim=True)                 # (S, 1, D)
        cat = torch.cat([h, pooled.expand(h.shape)], dim=-1)        # (S, N, 2D)
        return (torch.relu(cat @ params.w_q1) @ params.w_q2)[..., 0]

    def init(gen) -> S2VState:
        params = _init_params(gen, embed_dim, dev)
        return S2VState(params, params, _learn.adam_init(params))

    def flip(xs, action):
        rows = torch.arange(xs.shape[0], device=dev)
        xs = xs.clone()
        xs[rows, action] = 1.0 - xs[rows, action]
        return xs

    def train_round(state: S2VState, gen, eps: float, num_sims: int = 64,
                    horizon: int = 32, draws=None):
        """A horizon of transitions from fresh random states (``'rand_xs'``;
        each step a random node ``'node'`` taken where the uniform
        ``'explore'`` is below ``eps``), then one TD step over all of them
        toward ``r + gamma max Q_target(s')``; the target follows at rate
        0.01.  Returns ``(state, loss)``."""
        d = as_draws(gen, dev, draws)
        xs = sim.rand_xs(d, num_sims)
        best = sim.obj(xs)
        XS, A, R, XS2 = [], [], [], []
        with torch.no_grad():
            for _ in range(int(horizon)):
                greedy = torch.argmax(q_values(state.params, xs), dim=-1)
                rand = d.randint('node', sim.num_nodes, greedy.shape)
                explore = d.rand('explore', greedy.shape) < eps
                action = torch.where(explore, rand, greedy)
                xs2 = flip(xs, action)
                obj2 = sim.obj(xs2)
                reward = torch.clamp(obj2 - best, min=0.0) / sim.num_nodes
                best = torch.maximum(best, obj2)
                XS.append(xs), A.append(action), R.append(reward), XS2.append(xs2)
                xs = xs2
            XS, A, R, XS2 = map(torch.stack, (XS, A, R, XS2))
            next_q = torch.stack([torch.max(q_values(state.target, x), dim=-1).values
                                  for x in XS2])
            labels = R + gamma * next_q                               # (H, S)

        def loss_fn(params):
            qs = torch.stack([q_values(params, x) for x in XS])       # (H, S, N)
            q_taken = torch.gather(qs, -1, A[..., None])[..., 0]
            return torch.mean(torch.square(q_taken - labels))

        params, opt_state, loss, _ = _learn.step(opt, state.params, state.opt, loss_fn)
        target = soft_update(state.target, params, 0.01)
        return S2VState(params, target, opt_state), loss

    def solve(state: S2VState, gen, num_sims: int = 256, horizon: int = 64, draws=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Greedy rollouts from random states (``'rand_xs'``), each sim
        keeping its best; returns the best ``(obj, x)``."""
        xs = sim.rand_xs(as_draws(gen, dev, draws), num_sims)
        best, best_xs = sim.obj(xs), xs
        with torch.no_grad():
            for _ in range(int(horizon)):
                xs = flip(xs, torch.argmax(q_values(state.params, xs), dim=-1))
                obj = sim.obj(xs)
                better = obj > best
                best = torch.where(better, obj, best)
                best_xs = torch.where(better[:, None], xs, best_xs)
        i = torch.argmax(best)
        return best[i], best_xs[i]

    return init, q_values, train_round, solve


def s2v_dqn_solve(sim: MaxCutSimulator, gen, num_epochs: int = 60, embed_dim: int = 64,
                  num_sims: int = 64, horizon: int = 32) -> Tuple[float, torch.Tensor]:
    """Train an S2V-DQN on the instance (epsilon from 1 down to 0.05 over
    70% of the epochs) and return its best greedy solution."""
    init, _, train_round, solve = make_s2v_dqn(sim, embed_dim=embed_dim)
    d = as_draws(gen, sim.device)
    state = init(d)
    for epoch in range(num_epochs):
        eps = max(0.05, 1.0 - epoch / max(num_epochs * 0.7, 1))
        state, _ = train_round(state, d, eps, num_sims, horizon)
    obj, x = solve(state, d)
    return float(obj), x
