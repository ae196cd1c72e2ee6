"""QAOA for MaxCut on an exact statevector (counterpart of
``elegantrl_tpu/rlsolver/qaoa.py``).

The p-layer circuit, ``|+>^n`` then p layers of ``exp(-i gamma_l C)`` (the
diagonal cost phase) and ``exp(-i beta_l X_q)`` on every qubit, simulated
on the ``(2^n,)`` complex statevector; the parameters ascend ``<C>`` with
its gradient through autograd (the JAX package's through ``jax.grad``).
The answer is the best cut among the 64 most probable basis states.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ._draws import solver_device


def _cut_values(edges: np.ndarray, num_nodes: int) -> np.ndarray:
    """(2^n,) cut value of every basis state (bit i: the side of node i)."""
    idx = np.arange(1 << num_nodes, dtype=np.int64)
    cuts = np.zeros(1 << num_nodes, np.float32)
    for i, j, w in np.asarray(edges):
        cuts += np.float32(w) * (((idx >> int(i)) & 1) != ((idx >> int(j)) & 1))
    return cuts


def _apply_mixer(psi: torch.Tensor, beta: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """exp(-i beta X_q) on every qubit: cos(b) psi - i sin(b) X psi."""
    c, s = torch.cos(beta), torch.sin(beta)
    for q in range(num_nodes):
        p = psi.reshape(1 << (num_nodes - q - 1), 2, 1 << q)
        psi = (c * p - 1j * s * torch.flip(p, dims=(1,))).reshape(-1)
    return psi


def qaoa_maxcut(edges: np.ndarray, num_nodes: int, gen=None, p_layers: int = 3,
                num_steps: int = 150, lr: float = 0.05, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(best_cut, x, expectation)``; ``num_nodes <= 16`` (the
    statevector holds 2^n complex64).  Deterministic: ``gen`` is taken for
    the other solvers' signature and not drawn from."""
    n = int(num_nodes)
    assert n <= 16, "statevector QAOA is for small instances (n <= 16)"
    device = solver_device(device, 'qaoa_maxcut')
    cuts = torch.as_tensor(_cut_values(edges, n), device=device)
    dim = 1 << n
    psi0 = torch.full((dim,), 1.0 / np.sqrt(dim), dtype=torch.complex64, device=device)

    def expectation(gammas, betas):
        psi = psi0
        for gamma, beta in zip(gammas, betas):
            psi = _apply_mixer(psi * torch.exp(-1j * gamma * cuts), beta, n)
        probs = torch.square(torch.abs(psi))
        return torch.sum(probs * cuts), probs

    layers = torch.arange(1, p_layers + 1, dtype=torch.float32, device=device)
    gammas, betas = 0.1 * layers, 0.5 / layers
    for _ in range(int(num_steps)):     # plain gradient ascent on <C>
        g, b = gammas.detach().requires_grad_(True), betas.detach().requires_grad_(True)
        dg, db = torch.autograd.grad(expectation(g, b)[0], (g, b))
        gammas, betas = gammas + lr * dg, betas + lr * db
    with torch.no_grad():
        exp_c, probs = expectation(gammas, betas)
    top = torch.argsort(-probs, stable=True)[:64]    # measure: the most probable states
    best_i = top[torch.argmax(cuts[top])]
    bits = (best_i >> torch.arange(n, device=device)) & 1
    return cuts[best_i], bits.to(torch.float32), exp_c
