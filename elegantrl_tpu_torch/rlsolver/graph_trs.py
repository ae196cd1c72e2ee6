"""GraphTRS: graph transformer with a self-supervised embedding pretrain
(counterpart of ``elegantrl_tpu/rlsolver/graph_trs.py``).

A transformer over the node sequence of a graph's adjacency rows,
pretrained on a graph distribution so that its per-node embeddings transfer
to unseen instances.  The pretrain targets, batched on the device:

- heat-diffusion images of the graph averaged over K steps of the ``D^-1 A``
  walk and of the ``A`` walk (scaled by the batch's largest degree);
- the all-pairs shortest-path distances, by min-plus squaring
  (``ceil(log2 N)`` doublings), divided by N;
- the node's identity, classified from the encoder memory.

Pre-LN attention blocks, an encoder-only trunk with two heads.  Its layer
norm uses the population variance with eps 1e-6 and no bias, and its GELU
the tanh approximation (``jax.nn.gelu``'s default).  The embeddings plug
into :func:`~.l2a.make_l2a` through ``node_embed``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.nets import gelu
from . import _learn
from ._draws import as_draws, solver_device
from .graphs import edges_to_adjacency, generate_graph


class GraphTRSParams(NamedTuple):
    w_in: torch.Tensor        # (N, D) adjacency-row lift
    layers: tuple             # per layer: attention, FFN and LN scales (a dict)
    w_mem: torch.Tensor       # (D, D)
    w_struct: torch.Tensor    # (D, 3N) [hot_avg, hot_sum, dist] head
    w_cls: torch.Tensor       # (D, N) node-identity head


def _attn_layer_init(g, dim: int, ff: int, device) -> dict:
    o = _learn.orthogonal
    return {'wq': o(g, (dim, dim), device), 'wk': o(g, (dim, dim), device),
            'wv': o(g, (dim, dim), device), 'wo': o(g, (dim, dim), device, 0.5),
            'ff1': o(g, (dim, ff), device), 'ff2': o(g, (ff, dim), device, 0.5),
            'ln1': torch.ones(dim, device=device), 'ln2': torch.ones(dim, device=device)}


def _ln(x, scale):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + 1e-6) * scale


def _attn_block(p: dict, h, num_heads: int):
    """Pre-LN multi-head self-attention and FFN. h: ``(B, N, D)``."""
    B, N, D = h.shape
    hd = D // num_heads
    x = _ln(h, p['ln1'])

    def split(w):
        return (x @ w).reshape(B, N, num_heads, hd)
    q, k, v = split(p['wq']), split(p['wk']), split(p['wv'])
    logits = torch.einsum('bqhd,bkhd->bhqk', q, k) / math.sqrt(hd)
    attn = torch.softmax(logits, dim=-1)
    o = torch.einsum('bhqk,bkhd->bqhd', attn, v).reshape(B, N, D)
    h = h + o @ p['wo']
    x = _ln(h, p['ln2'])
    return h + gelu(x @ p['ff1']) @ p['ff2']


def make_graph_trs(num_nodes: int, embed_dim: int = 64, num_heads: int = 4,
                   num_layers: int = 2, ff_dim: int = 128, lr: float = 1e-3,
                   hot_steps: int = 4, device=None):
    """Returns ``(init, embed, pretrain_step)`` on ``device`` (None: the
    card).  ``embed(params, adj)`` maps adjacencies ``(B, N, N)`` to
    per-node embeddings ``(B, N, D)``."""
    N, D = num_nodes, embed_dim
    assert D % num_heads == 0
    device = solver_device(device, 'make_graph_trs')
    opt = _learn.adam(lr, clip=1.0)

    def init(gen):
        g = _learn.init_generator(gen)
        o = _learn.orthogonal
        w_in = o(g, (N, D), device)
        layers = tuple(_attn_layer_init(g, D, ff_dim, device) for _ in range(num_layers))
        params = GraphTRSParams(w_in=w_in, layers=layers, w_mem=o(g, (D, D), device),
                                w_struct=o(g, (D, 3 * N), device, 0.1),
                                w_cls=o(g, (D, N), device, 0.1))
        return params, _learn.adam_init(params)

    def embed(params: GraphTRSParams, adj):
        """``(B, N, N)`` float adjacency -> ``(B, N, D)`` node embeddings."""
        h = torch.tanh(adj @ params.w_in)
        for lp in params.layers:
            h = _attn_block(lp, h, num_heads)
        return torch.tanh(h @ params.w_mem)

    def targets(adj):
        """The pretrain labels ``(B, N, 3N)``, batched on the device."""
        deg = adj.sum(-1, keepdim=True) + 1e-6
        eye = torch.eye(N, device=adj.device).expand(adj.shape)

        def diffuse(walk):
            carry, total = eye, torch.zeros_like(adj)
            for _ in range(hot_steps):
                carry = carry @ walk
                total = total + carry
            return total / hot_steps
        hot_avg = diffuse(adj / deg)
        hot_sum = diffuse(adj / torch.clamp(deg.max(), min=1.0))    # scale-bounded
        big = float(N)
        w = torch.where(adj > 0, 1.0, big) * (1.0 - eye)
        for _ in range(int(np.ceil(np.log2(max(N, 2))))):           # min-plus squaring
            w = torch.minimum(w, torch.amin(w[:, :, :, None] + w[:, None, :, :], dim=2))
        dist = torch.clamp(w, max=big) / big
        return torch.cat([hot_avg, hot_sum, dist], dim=-1)

    def pretrain_step(params, opt_state, adj):
        """One Adam step on the structure regression plus the node-identity
        cross-entropy.  Returns ``(params, opt_state, loss, accuracy)``."""
        adj = torch.as_tensor(adj, dtype=torch.float32, device=device)
        with torch.no_grad():
            lab = targets(adj)
        ids = torch.arange(N, device=device)

        def loss_fn(p):
            mem = embed(p, adj)
            struct = mem @ p.w_struct                       # (B, N, 3N)
            cls_logits = mem @ p.w_cls                      # (B, N, N)
            l_struct = torch.mean(torch.square(struct - lab))
            l_cls = F.cross_entropy(cls_logits.reshape(-1, N), ids.repeat(adj.shape[0]))
            acc = torch.mean((torch.argmax(cls_logits, -1) == ids).to(torch.float32))
            return l_struct + l_cls, acc

        params, opt_state, loss, acc = _learn.step(opt, params, opt_state, loss_fn,
                                                   has_aux=True)
        return params, opt_state, loss, acc

    return init, embed, pretrain_step


def pretrain_graph_trs(num_nodes: int, graph_type: str = 'ER', num_graphs: int = 64,
                       num_steps: int = 200, batch_size: int = 16, embed_dim: int = 64,
                       seed: int = 0, verbose: bool = False, device=None, draws=None):
    """Self-supervised pretrain over ``num_graphs`` generated graphs, each
    step a batch of them (draw ``'ids'``).  Returns ``(params, embed_fn,
    history)`` with history ``[(loss, node-identity accuracy), ...]``."""
    device = solver_device(device, 'pretrain_graph_trs')
    adjs = torch.as_tensor(np.stack([
        edges_to_adjacency(generate_graph(graph_type, num_nodes, seed=seed + i), num_nodes)
        for i in range(num_graphs)]).astype(np.float32), device=device)
    init, embed, pretrain_step = make_graph_trs(num_nodes, embed_dim=embed_dim,
                                                device=device)
    d = as_draws(seed, device, draws)
    params, opt_state = init(d)
    history = []
    for step in range(num_steps):
        ids = d.randint('ids', num_graphs, (batch_size,))
        params, opt_state, loss, acc = pretrain_step(params, opt_state, adjs[ids])
        if (step + 1) % max(1, num_steps // 10) == 0:
            history.append((float(loss), float(acc)))
            if verbose:
                print(f"| graph_trs step {step + 1}: loss {float(loss):.4f} "
                      f"node-id acc {float(acc):.3f}", flush=True)
    return params, embed, history
