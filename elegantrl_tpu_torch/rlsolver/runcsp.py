"""RUN-CSP-style amortized MaxCut solver (counterpart of
``elegantrl_tpu/rlsolver/runcsp.py``; Toenshoff et al., "Graph Neural
Networks for Maximum Constraint Satisfaction").

A recurrent GNN with shared weights is unrolled T message-passing steps:
each node keeps a hidden state and emits a soft assignment after every
step, and the loss is the time-discounted expected number of violated
constraints (for MaxCut, the probability an edge is uncut).  Trained once
on a pool of instances (a padded ``(G, n, n)`` dense stack: the messages
are batched adjacency products), it is applied to unseen graphs in one
forward unroll from ``num_runs`` random hidden states.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import _learn
from ._draws import as_draws, solver_device


class RunCSPParams(NamedTuple):
    w_msg: torch.Tensor    # (d, d) neighbour message
    w_upd: torch.Tensor    # (2d, d) GRU-style candidate
    w_gate: torch.Tensor   # (2d, d) update gate
    w_out: torch.Tensor    # (d, 1) soft assignment head
    b_out: torch.Tensor    # (1,)


def init_runcsp(gen, dim: int = 32, device=None) -> RunCSPParams:
    """Glorot-uniform weights (the head's halved), from a CPU generator
    seeded by ``gen``."""
    device = solver_device(device, 'init_runcsp')
    g = _learn.init_generator(gen)
    return RunCSPParams(
        w_msg=_learn.glorot(g, (dim, dim), device),
        w_upd=_learn.glorot(g, (2 * dim, dim), device),
        w_gate=_learn.glorot(g, (2 * dim, dim), device),
        w_out=_learn.glorot(g, (dim, 1), device) * 0.5,
        b_out=torch.zeros(1, device=device))


def _unroll(params: RunCSPParams, adj: torch.Tensor, h0: torch.Tensor, steps: int):
    """adj ``(..., n, n)``, h0 ``(..., n, d)`` -> (the soft assignments of
    each step ``(steps, ..., n)``, the last h).  A message is divided by the
    count of the node's nonzero entries."""
    norm = torch.clamp(torch.sum(torch.abs(adj) > 0, -1, keepdim=True), min=1).to(h0.dtype)
    h, ps = h0, []
    for _ in range(int(steps)):
        msg = (adj @ (h @ params.w_msg)) / norm
        hm = torch.cat([h, msg], -1)
        gate = torch.sigmoid(hm @ params.w_gate)
        cand = torch.tanh(hm @ params.w_upd)
        h = (1.0 - gate) * h + gate * cand
        ps.append(torch.sigmoid((h @ params.w_out + params.b_out)[..., 0]))
    return torch.stack(ps), h


def _uncut_prob(adj: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The expected uncut edge weight, ``sum_ij w_ij [p_i p_j + (1-p_i)(1-p_j)]
    / 2``, each graph of ``adj (G, n, n)`` against its own rows of ``p (...,
    G, n)`` (a plain product would pair the step axis with the graph axis)."""
    pq = torch.einsum('...gn,gnm->...gm', p, adj)
    tot = torch.sum(adj, (-2, -1)) / 2.0
    cut_soft = torch.sum(p * torch.sum(adj, -1) + (1.0 - 2.0 * p) * pq, -1) / 2.0
    return tot - cut_soft


def make_runcsp(adjs: np.ndarray, dim: int = 32, steps: int = 24, lr: float = 2e-3,
                discount: float = 0.9, device=None):
    """Train pool ``adjs (G, n, n)`` on ``device`` (None: the card).  Returns
    ``(init_fn, train_fn)``: ``init_fn(gen) -> (params, opt_state)``;
    ``train_fn(state, gen, iters, draws=None) -> (state, last loss)`` runs
    ``iters`` Adam steps, each from fresh random hidden states for every
    pool graph (draw ``'h0'``, standard normals ``(G, n, dim)``, halved)."""
    device = solver_device(device, 'make_runcsp')
    pool = torch.as_tensor(np.asarray(adjs), dtype=torch.float32, device=device)
    g, n, _ = pool.shape
    opt = _learn.adam(lr)
    # later steps weigh more (the paper's convergence shaping)
    wts = discount ** torch.arange(steps - 1, -1, -1, dtype=torch.float32, device=device)
    wts = wts / torch.sum(wts)

    def init_fn(gen):
        params = init_runcsp(gen, dim, device)
        return params, _learn.adam_init(params)

    def loss_fn(params, h0):
        ps, _ = _unroll(params, pool, h0, steps)       # (steps, G, n)
        viol = _uncut_prob(pool, ps)                   # (steps, G)
        return torch.mean(torch.sum(wts[:, None] * viol, 0))

    def train_fn(state, gen, iters: int, draws=None):
        d = as_draws(gen, device, draws)
        params, opt_state = state
        loss = None
        for _ in range(int(iters)):
            h0 = d.normal('h0', (g, n, dim)) * 0.5
            params, opt_state, loss, _ = _learn.step(opt, params, opt_state,
                                                     lambda p: loss_fn(p, h0))
        return (params, opt_state), loss

    return init_fn, train_fn


def runcsp_solve(params: RunCSPParams, adj: np.ndarray, gen=None, num_runs: int = 64,
                 steps: int = 48, draws=None) -> Tuple[float, np.ndarray]:
    """Amortized inference on an unseen graph, on the params' device:
    ``num_runs`` random hidden states (draw ``'h0'``; ``gen=None`` seeds a
    generator with 0, as the JAX package takes ``PRNGKey(0)``), the unroll,
    every step's assignment rounded; returns the best cut and its x."""
    device = params.w_msg.device
    a = torch.as_tensor(np.asarray(adj), dtype=torch.float32, device=device)[None]
    n = a.shape[-1]
    dim = params.w_msg.shape[0]
    h0 = as_draws(0 if gen is None else gen, device, draws).normal('h0', (num_runs, n, dim)) * 0.5
    with torch.no_grad():
        ps, _ = _unroll(params, a, h0, steps)         # (steps, K, n)
        x = (ps > 0.5).to(torch.float32)
        cuts = torch.sum((x @ a[0]) * (1.0 - x), -1)  # (steps, K)
        i = torch.argmax(cuts.reshape(-1))
        best, xb = cuts.reshape(-1)[i], x.reshape(-1, n)[i]
    return float(best), xb.cpu().numpy()
