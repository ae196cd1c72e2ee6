"""Physics-inspired GNN solver for QUBO problems (counterpart of
``elegantrl_tpu/rlsolver/pignn.py``; Schuetz, Brubaker & Katzgraber, Nature
Machine Intelligence 4, 2022).

The binary assignment is relaxed to node probabilities ``p = GNN(embeddings,
A_hat)``; the QUBO energy ``p^T Q p`` is minimized by gradient descent on a
single instance, and ``x_i = [p_i > 0.5]`` projects it back.
``num_replicas`` replicas (different embedding inits) train at once as one
leading axis of every parameter, under one Adam whose moments are
elementwise (so each replica's stay its own); the best projected solution
of any replica at any step is kept on the device.  The GCN propagation is a
dense ``(N, N)`` product, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import _learn
from ._draws import as_draws


def normalized_adjacency(adj) -> torch.Tensor:
    """Symmetric GCN propagation matrix ``D^-1/2 (A + I) D^-1/2``."""
    a = torch.as_tensor(adj, dtype=torch.float32)
    a = a + torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    d = torch.sum(a, dim=-1)
    inv_sqrt = torch.where(d > 0, torch.rsqrt(d), torch.zeros_like(d))
    return a * inv_sqrt[:, None] * inv_sqrt[None, :]


def maxcut_qubo(adj) -> torch.Tensor:
    """QUBO matrix with ``x^T Q x == -cut(x)`` for binary ``x`` (the
    diagonal takes the linear term through ``x_i^2 == x_i``)."""
    a = torch.as_tensor(adj, dtype=torch.float32)
    return a - torch.diag(torch.sum(a, dim=-1))


def mis_qubo(adj, penalty: float = 2.0) -> torch.Tensor:
    """QUBO with ``x^T Q x == -(|set| - penalty * conflicts)``."""
    a = torch.as_tensor(adj, dtype=torch.float32)
    return (penalty / 2.0) * a - torch.eye(a.shape[0], dtype=a.dtype, device=a.device)


def _init_params(d, num: int, num_nodes: int, embed_dim: int, hidden_dim: int) -> dict:
    """``num`` replicas' parameters, stacked: the embeddings normal times
    ``1/sqrt(E)``, the weights uniform in ``+-1/sqrt(fan_in)`` (draws
    ``'embed'``, ``'w0'``, ``'w1'``: standard normals and uniforms on [0, 1))."""
    s0, s1 = 1.0 / np.sqrt(embed_dim), 1.0 / np.sqrt(hidden_dim)
    dev = d.device
    return {
        'embed': d.normal('embed', (num, num_nodes, embed_dim)) * s0,
        'w0': d.rand('w0', (num, embed_dim, hidden_dim)) * (s0 - (-s0)) + (-s0),
        'b0': torch.zeros((num, hidden_dim), device=dev),
        'w1': d.rand('w1', (num, hidden_dim, 1)) * (s1 - (-s1)) + (-s1),
        'b1': torch.zeros((num, 1), device=dev),
    }


def _forward(params: dict, a_hat: torch.Tensor) -> torch.Tensor:
    """Two-layer GCN over trainable node embeddings: every replica's
    per-node probabilities ``(R, N)``."""
    h = torch.relu(a_hat @ (params['embed'] @ params['w0']) + params['b0'][:, None, :])
    logits = a_hat @ (h @ params['w1']) + params['b1'][:, None, :]
    return torch.sigmoid(logits[..., 0])


def _energy(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``p_r^T Q p_r`` for each replica's row of ``p``."""
    return torch.sum(p * (p @ q.T), dim=-1)


def pignn_minimize(q, adj, gen, num_replicas: int = 16, embed_dim: int = None,
                   hidden_dim: int = None, num_steps: int = 500, lr: float = 1e-2,
                   draws=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Minimize ``x^T Q x`` over binary ``x`` with a replicated PI-GNN on
    ``q``'s device.  Returns ``(best_q_value, best_x)``: the lowest
    projected energy any replica reached at any step, and its 0/1 ``x``."""
    q = torch.as_tensor(q, dtype=torch.float32)
    adj = torch.as_tensor(adj, dtype=torch.float32, device=q.device)
    n = q.shape[0]
    if embed_dim is None:
        embed_dim = max(8, int(np.sqrt(n)))
    if hidden_dim is None:
        hidden_dim = max(4, embed_dim // 2)
    a_hat = normalized_adjacency(adj)
    d = as_draws(gen, q.device, draws)
    params = _init_params(d, num_replicas, n, embed_dim, hidden_dim)
    opt = _learn.adam(lr)
    opt_state = _learn.adam_init(params)

    def projected(p):
        with torch.no_grad():
            x = (_forward(p, a_hat) > 0.5).to(torch.float32)
            return _energy(q, x), x

    best_e, best_x = projected(params)
    for _ in range(int(num_steps)):
        # the replicas are independent, so the gradient of their summed
        # energies is each replica's own
        params, opt_state, _, _ = _learn.step(
            opt, params, opt_state, lambda p: torch.sum(_energy(q, _forward(p, a_hat))))
        e, x = projected(params)
        better = e < best_e
        best_e = torch.where(better, e, best_e)
        best_x = torch.where(better[:, None], x, best_x)
    i = torch.argmin(best_e)
    return best_e[i], best_x[i]


def _polish(sim, x: torch.Tensor, d, sweeps: int) -> torch.Tensor:
    """The simulator's flip sweeps on the projected solution: the pure
    relaxation underperforms on locally structured graphs (Angelini &
    Ricci-Tersenghi, Nat. Mach. Intell. 5, 2023), and a few sweeps close
    most of that gap."""
    if sweeps <= 0:
        return x
    xs = x[None, :]
    if hasattr(sim, 'local_search_sweep'):
        xs = sim.local_search_sweep(xs, d, num_sweeps=sweeps)
    elif hasattr(sim, 'local_search'):
        xs = sim.local_search(xs, d, num_sweeps=sweeps)
    return xs[0]


def pignn_maxcut(sim, gen, polish_sweeps: int = 4, draws=None, **kwargs
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PI-GNN on a :class:`~.maxcut.MaxCutSimulator`, then the polish
    (``'coin'`` draws).  Returns ``(best_cut, best_x)``;
    ``polish_sweeps=0`` gives the paper's pure projection."""
    d = as_draws(gen, sim.device, draws)
    _, x = pignn_minimize(maxcut_qubo(sim.adj), sim.adj, d, **kwargs)
    x = _polish(sim, x, d, polish_sweeps)
    return sim.obj(x[None, :])[0], x


def pignn_mis(sim, gen, polish_sweeps: int = 4, draws=None, **kwargs
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PI-GNN on a :class:`~.mis.MISSimulator`, then the polish.  Returns
    ``(best_obj, best_x)``, the simulator's penalized set size."""
    d = as_draws(gen, sim.device, draws)
    _, x = pignn_minimize(mis_qubo(sim.adj, penalty=float(sim.penalty)), sim.adj, d, **kwargs)
    x = _polish(sim, x, d, polish_sweeps)
    return sim.obj(x[None, :])[0], x
