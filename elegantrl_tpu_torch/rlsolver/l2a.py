"""L2A, learn-to-anneal for MaxCut (counterpart of
``elegantrl_tpu/rlsolver/l2a.py``).

A graph-conditioned policy proposes per-node flip probabilities that temper
a Metropolis sampler, and is trained by advantage-weighted likelihood on the
sampler's locally searched outcomes; with ``node_embed`` (frozen per-node
embeddings of a pretrained :mod:`.graph_trs`) the policy conditions on
learned graph structure too.  The policy is an MPNN over the dense
adjacency, on the simulator's device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import _learn
from ._draws import as_draws
from .maxcut import MaxCutSimulator


class L2AParams(NamedTuple):
    w_in: torch.Tensor    # (2[+E], D): [spin, normalized gain, pretrained] lift
    w_msg: torch.Tensor   # (D, D)
    w_self: torch.Tensor  # (D, D)
    w_out: torch.Tensor   # (D, 1)


def make_l2a(sim: MaxCutSimulator, embed_dim: int = 32, msg_rounds: int = 2,
             lr: float = 3e-3, node_embed=None):
    """Returns ``(init, epoch)``.  ``node_embed (N, E)``, optional: frozen
    per-node embeddings appended to each node's features."""
    adj, dev = sim.adj, sim.device
    deg = torch.sum(adj, dim=-1) + 1e-6
    opt = _learn.adam(lr, clip=1.0)
    if node_embed is not None:
        node_embed = torch.as_tensor(node_embed, dtype=torch.float32, device=dev).detach()
    in_dim = 2 + (0 if node_embed is None else node_embed.shape[-1])

    def init(gen) -> Tuple[L2AParams, tuple]:
        g = _learn.init_generator(gen)
        params = L2AParams(
            w_in=_learn.orthogonal(g, (in_dim, embed_dim), dev),
            w_msg=_learn.orthogonal(g, (embed_dim, embed_dim), dev, 0.5),
            w_self=_learn.orthogonal(g, (embed_dim, embed_dim), dev, 0.5),
            w_out=_learn.orthogonal(g, (embed_dim, 1), dev, 0.1))
        return params, _learn.adam_init(params)

    def flip_probs(params: L2AParams, xs):
        """``(S, N)`` per-node flip probabilities in [0.2, 0.8] conditioned
        on the graph and the solution."""
        feats = torch.stack([2.0 * xs - 1.0, sim.flip_gains(xs) / deg], -1)
        if node_embed is not None:
            feats = torch.cat([feats, node_embed.expand(*xs.shape, node_embed.shape[-1])], -1)
        h = torch.relu(feats @ params.w_in)
        for _ in range(msg_rounds):
            msg = torch.einsum('ij,sjd->sid', adj, h) / deg[None, :, None]
            h = torch.relu(h @ params.w_self + msg @ params.w_msg)
        p = torch.sigmoid((h @ params.w_out)[..., 0])
        return (p - 0.5) * 0.6 + 0.5

    def tempered_sample(params, xs, d, num_transfers: int):
        """Metropolis moves proposed from the policy: each chain's node is a
        categorical draw from ``log(probs + 1e-9)`` (the argmax of the
        logits plus Gumbel noise ``'node'``, as ``jax.random.categorical``),
        accepted when its gain is positive or the uniform ``'accept'`` is
        below ``exp(gain)``."""
        rows = torch.arange(xs.shape[0], device=dev)
        with torch.no_grad():
            for _ in range(int(num_transfers)):
                logits = torch.log(flip_probs(params, xs) + 1e-9)
                nodes = torch.argmax(d.gumbel('node', logits.shape) + logits, dim=-1)
                gains = sim.flip_gains(xs)[rows, nodes]
                accept = (gains > 0) | (d.rand('accept', gains.shape)
                                        < torch.exp(torch.clamp(gains, max=0.0)))
                xs = xs.clone()
                xs[rows, nodes] = torch.abs(xs[rows, nodes] - accept.to(xs.dtype))
        return xs

    def epoch(params, opt_state, gen, num_chains: int, num_transfers: int, num_ls: int,
              draws=None):
        """Random starts (``'rand_xs'``), the tempered sampler, the
        simulator's sweeps (``'coin'``), then one step on the
        advantage-weighted log-likelihood of the searched solutions.
        Returns ``(params, opt_state, best obj, its x)``."""
        d = as_draws(gen, dev, draws)
        xs = sim.rand_xs(d, num_chains)
        xs = tempered_sample(params, xs, d, num_transfers)
        xs_ls = sim.local_search_sweep(xs, d, num_sweeps=num_ls)
        objs = sim.obj(xs_ls)
        adv = (objs - torch.mean(objs)) / (torch.std(objs, correction=0) + 1e-6)

        def loss_fn(p):
            probs = flip_probs(p, xs_ls)
            logp = (xs_ls * torch.log(probs + 1e-9)
                    + (1 - xs_ls) * torch.log(1 - probs + 1e-9)).sum(-1)
            return -torch.mean(adv * logp)

        params, opt_state, _, _ = _learn.step(opt, params, opt_state, loss_fn)
        i = torch.argmax(objs)
        return params, opt_state, objs[i], xs_ls[i]

    return init, epoch


def l2a_solve(sim: MaxCutSimulator, gen, num_chains: int = 512, num_epochs: int = 30,
              num_transfers: int = 32, num_ls: int = 8, node_embed=None
              ) -> Tuple[float, torch.Tensor]:
    """Train the policy on the instance; the best solution any epoch's
    search reached."""
    init, epoch = make_l2a(sim, node_embed=node_embed)
    d = as_draws(gen, sim.device)
    params, opt_state = init(d)
    best_obj, best_x = -float('inf'), torch.zeros(sim.num_nodes, device=sim.device)
    for _ in range(num_epochs):
        params, opt_state, obj, x = epoch(params, opt_state, d, num_chains, num_transfers,
                                          num_ls)
        if float(obj) > best_obj:
            best_obj, best_x = float(obj), x
    return best_obj, best_x
