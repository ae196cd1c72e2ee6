"""Tensor-network contraction ordering (TNCO): batched simulator and solvers
(counterpart of ``elegantrl_tpu/rlsolver/tnco.py``).

* A tensor network is an ``(N, N)`` symmetric matrix of **log2 bond
  dimensions** (0 = no bond; parallel bonds add in log space) plus optional
  per-node open legs.  Everything stays in log2, so the costs of 50+-qubit
  circuits never overflow.
* A candidate contraction order is a real-valued **priority per edge**:
  edges are contracted in priority order, each contraction merging the two
  endpoint *clusters* and summing over all bonds between them at once.
  Evaluation walks the priority-sorted edges once, all ``S`` candidates in
  each step: a ``(S, N, N)`` cluster log-dim matrix, ``(S, N)`` labels and
  open legs, each candidate's row and column writes made by batched index
  ops.
* Objective = -log2(total scalar multiplications) (maximise, as the other
  simulators' ``if_maximize``); the peak intermediate tensor size is
  tracked alongside.

Solvers: batched randomized greedy construction (min-cost pair a step with
Gumbel tie noise) and batched simulated annealing over edge priorities.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ._draws import as_draws, solver_device

_NEG = -1e30   # log2-space "impossible" marker


class TNCOSimulator:
    """Batched contraction-cost evaluation for one tensor network."""

    def __init__(self, bonds_log2: np.ndarray, open_log2: Optional[np.ndarray] = None,
                 device=None):
        self.device = solver_device(device, type(self).__name__)
        bonds = np.asarray(bonds_log2, np.float32)
        assert bonds.ndim == 2 and bonds.shape[0] == bonds.shape[1]
        assert np.allclose(bonds, bonds.T), "bond matrix must be symmetric"
        assert np.all(np.diag(bonds) == 0.0), "no self-bonds"
        self.num_nodes = int(bonds.shape[0])
        iu, ju = np.nonzero(np.triu(bonds, 1))
        self.edges_u = torch.as_tensor(iu, dtype=torch.int64, device=self.device)
        self.edges_v = torch.as_tensor(ju, dtype=torch.int64, device=self.device)
        self.num_edges = int(len(iu))
        self.bonds = torch.as_tensor(bonds, device=self.device)
        if open_log2 is None:
            open_log2 = np.zeros(self.num_nodes, np.float32)
        self.open = torch.as_tensor(np.asarray(open_log2, np.float32), device=self.device)
        self.if_maximize = True

    def rand_xs(self, gen, num_sims: int, draws=None) -> torch.Tensor:
        """Candidate edge priorities, (num_sims, num_edges) (``'rand_xs'``)."""
        return as_draws(gen, self.device, draws).normal('rand_xs', (num_sims, self.num_edges))

    def _contract(self, xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(S, E) priorities -> (S,) log2 total multiplies, (S,) log2 peak
        tensor.  An edge internalised by an earlier merge (``lu == lv``)
        leaves the state as it was: its writes then put back what they
        read."""
        S, n = xs.shape[0], self.num_nodes
        order = torch.argsort(xs, dim=-1, stable=True)
        us, vs = self.edges_u[order], self.edges_v[order]           # (S, E)
        rows = torch.arange(S, device=xs.device)
        C = self.bonds.expand(S, n, n).clone()
        open_ = self.open.expand(S, n).clone()
        labels = torch.arange(n, device=xs.device).expand(S, n).clone()
        total = torch.full((S,), _NEG, device=xs.device)
        peak = torch.full((S,), _NEG, device=xs.device)
        for e in range(self.num_edges):
            lu, lv = labels[rows, us[:, e]], labels[rows, vs[:, e]]
            already = lu == lv
            c_u, c_v = C[rows, lu], C[rows, lv]                     # (S, N)
            o_u, o_v = open_[rows, lu], open_[rows, lv]
            shared = c_u[rows, lv]
            ru = torch.sum(c_u, dim=-1) + o_u
            rv = torch.sum(c_v, dim=-1) + o_v
            cost = ru + rv - shared          # log2 multiply count of this step
            out_sz = ru + rv - 2.0 * shared
            total = torch.where(already, total, torch.logaddexp2(total, cost))
            peak = torch.where(already, peak, torch.maximum(peak, out_sz))
            row = c_u + c_v
            row[rows, lu] = 0.0
            row[rows, lv] = 0.0
            row = torch.where(already[:, None], c_u, row)
            # row lu, then column lu, then zero lv's row and column
            C[rows, lu, :] = row
            C[rows, :, lu] = row
            zero = torch.where(already[:, None], row, torch.zeros_like(row))
            C[rows, lv, :] = zero
            C[rows, :, lv] = zero
            open_[rows, lu] = torch.where(already, o_u, o_u + o_v)
            open_[rows, lv] = torch.where(already, o_u, torch.zeros_like(o_u))
            labels = torch.where(labels == lv[:, None], lu[:, None], labels)
        return total, peak

    def contraction_cost(self, xs: torch.Tensor) -> torch.Tensor:
        """(S, E) priorities -> (S,) log2 total scalar multiplications."""
        return self._contract(xs)[0]

    def peak_size(self, xs: torch.Tensor) -> torch.Tensor:
        """(S, E) priorities -> (S,) log2 largest intermediate tensor."""
        return self._contract(xs)[1]

    def obj(self, xs: torch.Tensor) -> torch.Tensor:
        return -self.contraction_cost(xs)

    def best(self, xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        objs = self.obj(xs)
        i = torch.argmax(objs)
        return objs[i], xs[i]


def matrix_chain(dims, device=None) -> TNCOSimulator:
    """Matrix-chain multiplication as a TNCO instance: matrices
    ``A_i in R^{dims[i] x dims[i+1]}`` in a chain, open legs at the ends.
    Its optimum is the classic O(N^3) DP's (`matrix_chain_dp`)."""
    n = len(dims) - 1
    bonds = np.zeros((n, n), np.float32)
    for i in range(n - 1):
        bonds[i, i + 1] = bonds[i + 1, i] = np.log2(dims[i + 1])
    open_ = np.zeros(n, np.float32)
    open_[0] = np.log2(dims[0])
    open_[-1] += np.log2(dims[-1])
    return TNCOSimulator(bonds, open_, device=device)


def matrix_chain_dp(dims) -> float:
    """Exact minimum multiply count for a matrix chain (host DP)."""
    n = len(dims) - 1
    m = [[0.0] * n for _ in range(n)]
    for span in range(1, n):
        for i in range(n - span):
            j = i + span
            m[i][j] = min(m[i][k] + m[k + 1][j] + dims[i] * dims[k + 1] * dims[j + 1]
                          for k in range(i, j))
    return float(m[0][n - 1])


def random_tn(num_nodes: int, degree: int = 3, max_log2: float = 3.0, seed: int = 0,
              device=None) -> TNCOSimulator:
    """Random connected tensor network: a spanning-tree backbone plus extra
    edges to reach ~``degree * N / 2`` bonds, log2 dims uniform in
    [1, max_log2]."""
    rng = np.random.default_rng(seed)
    bonds = np.zeros((num_nodes, num_nodes), np.float32)

    def add(i, j):
        if i != j and bonds[i, j] == 0.0:
            bonds[i, j] = bonds[j, i] = rng.uniform(1.0, max_log2)

    perm = rng.permutation(num_nodes)
    for a, b in zip(perm[:-1], perm[1:]):       # connected backbone
        add(int(a), int(b))
    extra = max(0, degree * num_nodes // 2 - (num_nodes - 1))
    for _ in range(extra * 4):
        if np.count_nonzero(np.triu(bonds, 1)) >= num_nodes - 1 + extra:
            break
        i, j = rng.integers(0, num_nodes, 2)
        add(int(i), int(j))
    return TNCOSimulator(bonds, device=device)


def grid_tn(rows: int, cols: int, bond_log2: float = 1.0, device=None) -> TNCOSimulator:
    """Square-grid (PEPS-like) network: the classic hard family where the
    contraction order changes the exponent of the cost."""
    n = rows * cols
    bonds = np.zeros((n, n), np.float32)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            if c + 1 < cols:
                bonds[i, i + 1] = bonds[i + 1, i] = bond_log2
            if r + 1 < rows:
                bonds[i, i + cols] = bonds[i + cols, i] = bond_log2
    return TNCOSimulator(bonds, device=device)


def tnco_greedy(sim: TNCOSimulator, gen, num_sims: int = 256, noise: float = 0.3,
                draws=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched randomized greedy: each of ``num_sims`` replicas repeatedly
    contracts the connected cluster pair with the lowest cost + Gumbel noise
    (``'gumbel'``, one ``(S, N, N)`` draw a step).  Returns (best log2
    multiply count, (N-1, 2) merge sequence of the best replica; ``[-1,
    -1]`` once one cluster is left)."""
    d = as_draws(gen, sim.device, draws)
    S, n, dev = int(num_sims), sim.num_nodes, sim.device
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    rows = torch.arange(S, device=dev)
    C = sim.bonds.expand(S, n, n).clone()
    open_ = sim.open.expand(S, n).clone()
    alive = torch.ones((S, n), dtype=torch.bool, device=dev)
    total = torch.full((S,), _NEG, device=dev)
    inf = torch.tensor(float('inf'), device=dev)
    merges = []
    for _ in range(n - 1):
        ext = torch.sum(C, dim=2) + open_                           # (S, N) log2 ext dims
        cost = ext[:, :, None] + ext[:, None, :] - C                # pairwise contract
        pair = alive[:, :, None] & alive[:, None, :] & ~eye
        connected = (C > 0.0) & pair
        # disconnected components fall back to outer products, deferred
        # behind every connected pair by a large log2 penalty
        cand = torch.where(connected, cost, torch.where(pair, cost + 1e3, inf))
        g = noise * d.gumbel('gumbel', (S, n, n))
        idx = torch.argmin((cand + g).reshape(S, n * n), dim=-1)
        a, b = idx // n, idx % n
        step_cost = ext[rows, a] + ext[rows, b] - C[rows, a, b]
        do = torch.sum(alive, dim=-1) > 1          # a no-op once one cluster is left
        total = torch.where(do, torch.logaddexp2(total, step_cost), total)
        row = C[rows, a] + C[rows, b]
        row[rows, a] = 0.0
        row[rows, b] = 0.0
        C2 = C.clone()
        C2[rows, a, :] = row
        C2[rows, :, a] = row
        C2[rows, b, :] = 0.0
        C2[rows, :, b] = 0.0
        C = torch.where(do[:, None, None], C2, C)
        o_a, o_b = open_[rows, a], open_[rows, b]
        open2 = open_.clone()
        open2[rows, a] = o_a + o_b
        open2[rows, b] = 0.0
        open_ = torch.where(do[:, None], open2, open_)
        alive2 = alive.clone()
        alive2[rows, b] = False
        alive = torch.where(do[:, None], alive2, alive)
        merges.append(torch.where(do[:, None], torch.stack([a, b], dim=1),
                                  torch.full((S, 2), -1, dtype=torch.int64, device=dev)))
    merges = torch.stack(merges, dim=1) if merges else torch.zeros(
        (S, 0, 2), dtype=torch.int64, device=dev)
    i = torch.argmin(total)
    return total[i], merges[i]


def tnco_anneal(sim: TNCOSimulator, gen, num_sims: int = 512, num_steps: int = 256,
                sigma: float = 0.5, temp0: float = 1.0,
                draws=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched simulated annealing over edge priorities: Gaussian proposal
    (``'prop'``), Metropolis accept on the log2-cost delta (``'accept'``)
    with a geometric temperature decay, from ``'rand_xs'``.  Returns (best
    log2 multiply count, best (E,) priorities)."""
    d = as_draws(gen, sim.device, draws)
    S = int(num_sims)
    xs = sim.rand_xs(d, S)
    costs = sim.contraction_cost(xs)
    i0 = torch.argmin(costs)
    best_c, best_x = costs[i0], xs[i0]
    ts = torch.as_tensor(np.linspace(0.0, 1.0, num_steps, endpoint=False, dtype=np.float32),
                         device=sim.device)
    for t in range(int(num_steps)):
        prop = xs + sigma * d.normal('prop', tuple(xs.shape))
        pc = sim.contraction_cost(prop)
        temp = temp0 * torch.pow(0.02, ts[t])          # t in [0, 1)
        accept = (pc < costs) | (d.rand('accept', (S,)) < torch.exp2((costs - pc) / temp))
        xs = torch.where(accept[:, None], prop, xs)
        costs = torch.where(accept, pc, costs)
        i = torch.argmin(costs)
        better = costs[i] < best_c
        best_c = torch.where(better, costs[i], best_c)
        best_x = torch.where(better, xs[i], best_x)
    return best_c, best_x
