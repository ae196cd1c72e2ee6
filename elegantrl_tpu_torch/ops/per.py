"""Batched wide segment tree for prioritised experience replay (counterpart
of ``elegantrl_tpu/ops/per.py``).

A tree of fanout 256 with two levels, one per env sequence:

- ``sums``   ``(N, C)``: per-chunk priority totals;
- ``leaves`` ``(N, cap)``: the priorities, ``cap = C * 256`` (``max_size``
  padded to whole chunks).

Sampling is the inverse CDF twice, stratified: per sequence, ``sub`` values
``v = (j + u_j) * total / sub`` are located first among the chunk totals
(the count of ``cumsum(sums) < v``), then within the 256 leaves of that
chunk.  An update writes leaves and recomputes the sums of the chunks it
touched.

The tree is updated in place (as the replay ring is): :meth:`update` and
:meth:`update_scattered` write into the tensors of the tree they are given
and return it.  Duplicate ``(seq, id)`` pairs in one scattered update keep
the LAST write in minibatch order on every device: a stable sort of the
pairs finds, for each, the last entry of its run of equals, and every
duplicate then writes that entry's value, so the card's ``index_put_``
(whose winner among duplicates is undefined) writes the same value
whichever wins.  Nothing here waits for the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

FANOUT = 256

Tree = Tuple[torch.Tensor, torch.Tensor]


def _cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def last_writer(keys: torch.Tensor) -> torch.Tensor:
    """For each position of ``keys (B,)``, the position of the last entry
    with the same key: a stable sort keeps equal keys in their order, the
    last of each run is found by a reverse running minimum."""
    sk, order = torch.sort(keys, stable=True)
    pos = torch.arange(sk.numel(), device=keys.device)
    run_end = torch.full_like(pos, sk.numel())
    run_end[-1:] = pos[-1:]
    run_end[:-1] = torch.where(sk[1:] != sk[:-1], pos[:-1], sk.numel())
    run_end = torch.flip(torch.cummin(torch.flip(run_end, (0,)), 0).values, (0,))
    out = torch.empty_like(order)
    out[order] = order[run_end]
    return out


class SegmentTree:
    """Tree state ``(sums (N, C), leaves (N, cap))`` with ``C =
    ceil(max_size / 256)``."""

    def __init__(self, max_size: int, num_seqs: int):
        self.max_size = int(max_size)
        self.num_seqs = int(num_seqs)
        self.n_chunks = max(1, _cdiv(self.max_size, FANOUT))
        self.cap = self.n_chunks * FANOUT

    def init(self, device) -> Tree:
        return (torch.zeros((self.num_seqs, self.n_chunks), device=device),
                torch.zeros((self.num_seqs, self.cap), device=device))

    def _blocks(self, leaves: torch.Tensor) -> torch.Tensor:
        return leaves.view(self.num_seqs, self.n_chunks, FANOUT)

    def update(self, tree: Tree, data_ids: torch.Tensor, prob: torch.Tensor) -> Tree:
        """Set leaves ``data_ids (H,)`` to ``prob (H, N)`` for every sequence,
        then refresh the touched chunk sums."""
        sums, leaves = tree
        leaves[:, data_ids] = prob.T.to(leaves.dtype)
        chunks = data_ids // FANOUT          # duplicates write the same sum
        sums[:, chunks] = torch.sum(self._blocks(leaves)[:, chunks], dim=-1)
        return sums, leaves

    def update_scattered(self, tree: Tree, ids0: torch.Tensor, ids1: torch.Tensor,
                         prob: torch.Tensor) -> Tree:
        """Set the leaves ``(seq=ids1, data_id=ids0)`` to ``prob (B,)``; of
        duplicate pairs the last in order wins."""
        sums, leaves = tree
        i0, i1 = ids0.long(), ids1.long()
        leaves[i1, i0] = prob[last_writer(i1 * self.cap + i0)].to(leaves.dtype)
        chunk = i0 // FANOUT
        sums[i1, chunk] = torch.sum(self._blocks(leaves)[i1, chunk], dim=-1)
        return sums, leaves

    def draw(self, gen: torch.Generator, count: int, sub_batch: int) -> torch.Tensor:
        """The stratified uniforms of ``count`` samples, ``(count, N, sub)``."""
        return torch.rand((count, self.num_seqs, sub_batch), generator=gen, device=gen.device)

    def sample(self, tree: Tree, sub_batch: int, u: Optional[torch.Tensor] = None,
               gen: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stratified proportional sampling: per sequence ``sub_batch`` values
        ``(j + u) * total / sub_batch`` located through the two levels.
        ``u (..., N, sub)`` are the uniforms (drawn from ``gen`` when None);
        returns ``(data_ids, priorities)``, each shaped like ``u``."""
        sums, leaves = tree
        if u is None:
            u = self.draw(gen, 1, sub_batch)[0]
        total = torch.sum(sums, dim=1, keepdim=True)                       # (N, 1)
        v = (torch.arange(sub_batch, device=u.device) + u) * (total / sub_batch)
        cdf = torch.cumsum(sums, dim=1)                                    # (N, C)
        chunk = torch.sum(cdf[:, None, :] < v[..., None], dim=-1)          # (..., N, sub)
        chunk = torch.clamp(chunk, max=self.n_chunks - 1)
        cdf_b = cdf.expand(v.shape[:-2] + cdf.shape)
        below = torch.gather(cdf_b, -1, torch.clamp(chunk - 1, min=0))
        v = v - torch.where(chunk > 0, below, torch.zeros_like(below))
        blocks = self._blocks(leaves).expand(v.shape[:-2] + (self.num_seqs, self.n_chunks,
                                                             FANOUT))
        block = torch.gather(blocks, -2, chunk[..., None].expand(chunk.shape + (FANOUT,)))
        bcdf = torch.cumsum(block, dim=-1)                                 # (..., N, sub, 256)
        off = torch.clamp(torch.sum(bcdf < v[..., None], dim=-1), max=FANOUT - 1)
        ids = chunk * FANOUT + off
        leaves_b = leaves.expand(v.shape[:-2] + leaves.shape)
        return ids, torch.gather(leaves_b, -1, ids)

    def from_leaves(self, leaves: torch.Tensor) -> Tree:
        """Rebuild from a ``(N, max_size)`` leaf slice (checkpoint restore)."""
        full = torch.zeros((self.num_seqs, self.cap), device=leaves.device)
        full[:, :leaves.shape[1]] = leaves
        return torch.sum(self._blocks(full), dim=-1), full

    def leaves(self, tree: Tree) -> torch.Tensor:
        """The ``(N, max_size)`` valid-leaf slice (for checkpointing)."""
        return tree[1][:, :self.max_size]

    def totals(self, tree: Tree) -> torch.Tensor:
        """Per-sequence total priority."""
        return torch.sum(tree[0], dim=1)

    def min_leaf(self, tree: Tree, size: int) -> torch.Tensor:
        """Per-sequence minimum priority over the ``size`` valid leaves."""
        valid = tree[1][:, :self.max_size][:, :max(int(size), 0)]
        if valid.shape[1] == 0:
            return torch.full((self.num_seqs,), float('inf'), device=valid.device)
        return torch.amin(valid, dim=1)
