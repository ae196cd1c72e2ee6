"""MaxCut's SDP relaxation in low-rank Burer-Monteiro form, with hyperplane
rounding (counterpart of ``elegantrl_tpu/rlsolver/sdp.py``).

Solves ``max 1/4 sum_ij W_ij (1 - <v_i, v_j>)`` with ``||v_i|| = 1`` over
``V`` in ``R^{n x k}`` (``k ~ sqrt(2n)``) by projected gradient ascent on
the sphere, one ``(n, n) x (n, k)`` product a step, then rounds with many
random hyperplanes at once and keeps the best cut.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ._draws import as_draws, solver_device
from .graphs import edges_to_adjacency


def sdp_maxcut(edges: np.ndarray, num_nodes: int, gen, rank: int = 0, num_steps: int = 300,
               lr: float = 0.1, num_roundings: int = 1024, device=None,
               draws=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(best_cut, x)`` with x in {0, 1}^n.  ``rank=0``: ``ceil(sqrt(2
    n))``, the Burer-Monteiro threshold.  Draws: the start (``'v0'``,
    normals ``(n, k)``) and the hyperplanes (``'round'``, ``(k, R)``)."""
    device = solver_device(device, 'sdp_maxcut')
    n = int(num_nodes)
    k = rank or max(2, int(math.ceil(math.sqrt(2.0 * n))))
    adj = torch.as_tensor(edges_to_adjacency(edges, num_nodes), device=device)
    d = as_draws(gen, device, draws)
    v = d.normal('v0', (n, k))
    v = v / torch.linalg.vector_norm(v, dim=1, keepdim=True)
    for _ in range(int(num_steps)):
        # the gradient of -1/4 tr(W V V^T) is -1/2 W V; its tangent part on
        # each sphere, then a retraction by normalisation
        g = -0.5 * (adj @ v)
        g = g - torch.sum(g * v, dim=1, keepdim=True) * v
        v = v + lr * g
        v = v / torch.linalg.vector_norm(v, dim=1, keepdim=True)
    xs = ((v @ d.normal('round', (k, num_roundings))) > 0).to(torch.float32).T   # (R, n)
    cuts = torch.sum((xs @ adj) * (1.0 - xs), dim=-1)
    i = torch.argmax(cuts)
    return cuts[i], xs[i]
