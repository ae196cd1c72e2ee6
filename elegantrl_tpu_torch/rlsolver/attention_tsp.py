"""Attention-model TSP constructor, Kool et al. style (counterpart of
``elegantrl_tpu/rlsolver/attention_tsp.py``).

A transformer encoder over the city coordinates and an autoregressive
attention decoder that builds tours city by city, trained with REINFORCE
against a greedy-rollout baseline.  The attention is the JAX module's own
products and softmax (it runs XLA ops there, no Pallas kernel), so here it
is plain PyTorch ops.  The decoder's logits are clipped with ``tanh`` and
the visited cities masked to ``-inf`` with ``masked_fill`` before the
log-softmax, so a masked entry carries no gradient and no NaN.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import _learn
from ._draws import as_draws, solver_device


class AMParams(NamedTuple):
    embed: tuple                 # (w, b) coords -> D
    blocks: tuple                # per block: (wq, wk, wv, wo, w1, b1, w2, b2)
    proj_kv: tuple               # decoder (wk, wv, wq_ctx)
    first_last: torch.Tensor     # learned placeholder for first/last city (2, D)


def make_attention_tsp(num_cities: int, embed_dim: int = 128, num_heads: int = 8,
                       num_blocks: int = 2, lr: float = 1e-4, clip_logits: float = 10.0,
                       device=None):
    """Returns ``(init, train_step, solve)`` on ``device`` (None: the card)."""
    D, H = embed_dim, num_heads
    Dh = D // H
    device = solver_device(device, 'make_attention_tsp')
    opt = _learn.adam(lr, clip=1.0)

    def linear(g, din, dout):
        s = 1.0 / np.sqrt(din)
        return _learn.uniform(g, (din, dout), device, -s, s)

    def init(gen) -> Tuple[AMParams, tuple]:
        g = _learn.init_generator(gen)
        z = lambda n: torch.zeros(n, device=device)  # noqa: E731
        blocks = tuple((linear(g, D, D), linear(g, D, D), linear(g, D, D), linear(g, D, D),
                        linear(g, D, 2 * D), z(2 * D), linear(g, 2 * D, D), z(D))
                       for _ in range(num_blocks))
        params = AMParams(embed=(linear(g, 2, D), z(D)), blocks=blocks,
                          proj_kv=(linear(g, D, D), linear(g, D, D), linear(g, 3 * D, D)),
                          first_last=_learn.normal(g, (2, D), device, 0.1))
        return params, _learn.adam_init(params)

    def _norm(x):
        return x / (torch.linalg.norm(x, dim=-1, keepdim=True) / np.sqrt(D) + 1e-6)

    def _mha(x, wq, wk, wv, wo):
        B, N, _ = x.shape
        q = (x @ wq).reshape(B, N, H, Dh)
        k = (x @ wk).reshape(B, N, H, Dh)
        v = (x @ wv).reshape(B, N, H, Dh)
        att = torch.softmax(torch.einsum('bnhd,bmhd->bhnm', q, k) / np.sqrt(Dh), dim=-1)
        return torch.einsum('bhnm,bmhd->bnhd', att, v).reshape(B, N, D) @ wo

    def encode(params: AMParams, coords):
        """coords ``(B, N, 2)`` -> embeddings ``(B, N, D)``."""
        w, b = params.embed
        h = coords @ w + b
        for (wq, wk, wv, wo, w1, b1, w2, b2) in params.blocks:
            h = _norm(h + _mha(h, wq, wk, wv, wo))
            h = _norm(h + torch.relu(h @ w1 + b1) @ w2 + b2)
        return h

    def decode(params: AMParams, emb, d, greedy: bool):
        """Tours built city by city from ``emb (B, N, D)``: the argmax, or a
        categorical draw (the argmax of the logits plus Gumbel noise
        ``'node'``, as ``jax.random.categorical``).  Returns ``(tours (B, N)
        int64, logprob (B,))``."""
        B, N, _ = emb.shape
        wk, _, wq_ctx = params.proj_kv
        keys_g = emb @ wk                        # (B, N, D) glimpse keys
        graph_emb = torch.mean(emb, dim=1)       # (B, D)
        rows = torch.arange(B, device=emb.device)
        visited = torch.zeros((B, N), dtype=torch.bool, device=emb.device)
        first = torch.full((B,), -1, dtype=torch.int64, device=emb.device)
        last = first.clone()
        logp = torch.zeros(B, device=emb.device)
        tours = []
        for _ in range(N):
            first_e = torch.where((first < 0)[:, None], params.first_last[0][None],
                                  emb[rows, first.clamp(min=0)])
            last_e = torch.where((last < 0)[:, None], params.first_last[1][None],
                                 emb[rows, last.clamp(min=0)])
            ctx = torch.cat([graph_emb, first_e, last_e], -1) @ wq_ctx
            logits = torch.einsum('bd,bnd->bn', ctx, keys_g) / math.sqrt(D)
            logits = (clip_logits * torch.tanh(logits)).masked_fill(visited, -float('inf'))
            if greedy:
                nxt = torch.argmax(logits, dim=-1)
            else:
                nxt = torch.argmax(d.gumbel('node', logits.shape) + logits.detach(), dim=-1)
            logp = logp + torch.log_softmax(logits, dim=-1)[rows, nxt]
            visited = visited.clone()
            visited[rows, nxt] = True
            first = torch.where(first < 0, nxt, first)
            last = nxt
            tours.append(nxt)
        return torch.stack(tours, dim=1), logp

    def _tour_len(dist, tours):
        """Closed-tour lengths, ``dist (B, N, N)`` or ``(N, N)``."""
        nxt = torch.roll(tours, -1, dims=-1)
        if dist.dim() == 2:
            return torch.sum(dist[tours, nxt], -1)
        return torch.sum(dist[torch.arange(tours.shape[0], device=tours.device)[:, None],
                              tours, nxt], -1)

    def _dist(coords):
        return torch.sqrt(torch.sum(torch.square(coords[..., :, None, :]
                                                 - coords[..., None, :, :]), -1))

    def train_step(params, opt_state, coords, gen, num_sims: int, draws=None):
        """One REINFORCE step on ``coords (num_sims, N, 2)``: sampled tours
        against the greedy tours' lengths.  Returns ``(params, opt_state,
        mean sampled length, mean greedy length)``."""
        d = as_draws(gen, device, draws)
        coords = torch.as_tensor(coords, dtype=torch.float32, device=device)
        dist = _dist(coords)
        with torch.no_grad():
            greedy_tours, _ = decode(params, encode(params, coords), d, greedy=True)
            baseline = _tour_len(dist, greedy_tours)

        def loss_fn(p):
            tours, logp = decode(p, encode(p, coords), d, greedy=False)
            cost = _tour_len(dist, tours)
            return torch.mean((cost - baseline) * logp), cost

        params, opt_state, _, cost = _learn.step(opt, params, opt_state, loss_fn,
                                                 has_aux=True)
        return params, opt_state, torch.mean(cost.detach()), torch.mean(baseline)

    def solve(params, coords, gen, num_samples: int = 64, draws=None):
        """``num_samples`` sampled tours and the greedy one of one instance;
        returns the shortest ``(length, tour)``."""
        coords = torch.as_tensor(coords, dtype=torch.float32, device=device)
        d = as_draws(gen, device, draws)
        with torch.no_grad():
            emb = encode(params, coords[None].expand(num_samples, -1, -1))
            tours, _ = decode(params, emb, d, greedy=False)
            g_tours, _ = decode(params, emb[:1], d, greedy=True)
            tours = torch.cat([tours, g_tours], 0)
            lens = _tour_len(_dist(coords), tours)
        i = torch.argmin(lens)
        return lens[i], tours[i]

    return init, train_step, solve


def train_attention_tsp(num_cities: int = 20, num_steps: int = 200, num_sims: int = 256,
                        seed: int = 0, verbose: bool = True, device=None):
    """Train on uniform random instances (``num_sims`` a step).  Returns
    ``(params, opt_state, solve)``."""
    init, train_step, solve = make_attention_tsp(num_cities, device=device)
    device = solver_device(device, 'train_attention_tsp')
    d = as_draws(seed, device)
    params, opt_state = init(d)
    for i in range(num_steps):
        coords = d.rand('coords', (num_sims, num_cities, 2))
        params, opt_state, cost, baseline = train_step(params, opt_state, coords, d, num_sims)
        if verbose and (i + 1) % max(1, num_steps // 8) == 0:
            print(f"| am_tsp step {i + 1}: sample cost {float(cost):.4f} "
                  f"greedy {float(baseline):.4f}", flush=True)
    return params, opt_state, solve
