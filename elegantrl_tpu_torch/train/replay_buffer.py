"""Device-resident replay ring buffer (counterpart of
``elegantrl_tpu/train/replay_buffer.py``).

- layout ``(max_size, num_seqs, dim)``: one ring per env sequence, on the
  run's device (``device=None``, the default, is the card, as ``Config``;
  without a GPU the constructor raises and names ``device='cpu'``); discrete
  actions are int32 ``(max_size, num_seqs)``;
- modular insert at the ring pointer, ``size = min(size + h, max_size)``;
  the insert writes the tensors in place, so the returned ``BufferState``
  shares them with the one passed in (the JAX package donates the buffer);
- uniform sampling over flattened ``(t, seq)`` ids below ``sample_len =
  max(size - 1, 1)``, ``ids0 = ids % sample_len``, ``ids1 = ids //
  sample_len``, with ``next_state = states[ids0 + 1]``, including the
  reference's seam artifact at the ring pointer, kept for parity;
- :meth:`ReplayBuffer.sample_rows`: ``R = batch_size // num_seqs`` whole
  time rows, sample ``b = r * num_seqs + n``;
- the gathers of :meth:`ReplayBuffer.gather` (and so of :meth:`sample`,
  :meth:`sample_rows` and :meth:`sample_for_per`) run K11a
  (``ops/kernels.py:buffer_gather_fields``, one launch for all six fields)
  on a card, bitwise equal to the indexing they replace; with
  ``feature_major`` the states, next states and continuous actions come out
  ``(..., dim, B)``, the layout the update chunks read;

- prioritised replay (``if_use_per``): the batched segment tree of
  ``ops/per.py`` in ``per_tree``; fresh rows get priority 10;
  :meth:`ReplayBuffer.sample_for_per` draws per sequence, stratified, ``ids0
  = min(ids0, size - 2)``, with importance weights ``(prio / min_prio)^-beta``
  (``min_prio`` per sequence); :meth:`ReplayBuffer.td_error_update_for_per`
  writes ``clip(td, 1e-8, 10)^alpha`` (``per_alpha`` 0.6, ``per_beta`` 0.4);
- the cumulative-return column ``cum_rewards`` (``lambda_fit_cum_r != 0``),
  written for the span just inserted;
- ``storage_dtype`` bfloat16 (``args.storage_dtype``) keeps the states and
  float actions in bf16, the scalars in float32, as the JAX package;
- :meth:`ReplayBuffer.save_or_load_history`: one ``replay_buffer.npz`` with
  the JAX package's keys, so each package reads the other's file (bf16
  fields widened to float32 in the file, narrowed back on load).

``ptr`` and ``size`` are Python ints, so the update count of a round is
known on the host without a device sync.
"""

from __future__ import annotations

import os
from types import SimpleNamespace
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..agents.base import resolve_storage_dtype
from ..config import resolve_device
from ..ops import kernels
from ..ops.per import SegmentTree


class BufferState(NamedTuple):
    states: torch.Tensor    # (M, N, S) float32, or the storage dtype
    actions: torch.Tensor   # (M, N, A) float32 (or the storage dtype) | (M, N) int32 when discrete
    rewards: torch.Tensor   # (M, N)
    undones: torch.Tensor   # (M, N)
    unmasks: torch.Tensor   # (M, N)
    ptr: int
    size: int
    per_tree: Optional[tuple] = None          # (sums (N, C), leaves (N, cap)), PER only
    cum_rewards: Optional[torch.Tensor] = None  # (M, N) for lambda_fit_cum_r


class ReplayBuffer:
    """Static buffer description + ops on a :class:`BufferState`."""

    def __init__(self, max_size: int, state_dim: int, action_dim: int,
                 num_seqs: int = 1, if_use_per: bool = False,
                 if_discrete: bool = False, args=None, device=None):
        # the bulk fields' type (states and float actions; the scalars stay f32)
        self.storage_dtype = resolve_storage_dtype(args) or torch.float32
        self.max_size = int(max_size)
        self.state_dim = int(state_dim)
        self.action_dim = int(action_dim)
        self.num_seqs = int(num_seqs)
        self.if_discrete = bool(if_discrete)
        # the default is the run's card, resolved as Config.device is (so
        # without a GPU it raises here); a device asked for by name is taken
        # as given (a description of a card's buffer, whose ring is never made)
        self.device = (resolve_device(SimpleNamespace(device='cuda'), owner='ReplayBuffer')
                       if device is None else torch.device(device))
        self.if_use_per = bool(if_use_per)
        self.per_alpha = float(getattr(args, 'per_alpha', 0.6))
        self.per_beta = float(getattr(args, 'per_beta', 0.4))
        self.if_use_cum_rewards = float(getattr(args, 'lambda_fit_cum_r', 0.0)) != 0.0
        self.tree = SegmentTree(self.max_size, self.num_seqs) if if_use_per else None
        # K11a (ops/kernels.py:buffer_gather_fields) takes every gather
        self.use_gather_kernel = kernels.select(args, 'use_gather_kernel', True, self.device,
                                                'the gather of any replay field')

    def init(self, device=None) -> BufferState:
        """An empty ring on the buffer's device, or on ``device`` where given
        (a population member's)."""
        M, N, S = self.max_size, self.num_seqs, self.state_dim
        dev = self.device if device is None else torch.device(device)
        bulk = self.storage_dtype
        actions = (torch.zeros((M, N), dtype=torch.int32, device=dev) if self.if_discrete
                   else torch.zeros((M, N, self.action_dim), dtype=bulk, device=dev))
        return BufferState(states=torch.zeros((M, N, S), dtype=bulk, device=dev),
                           actions=actions,
                           rewards=torch.zeros((M, N), device=dev),
                           undones=torch.zeros((M, N), device=dev),
                           unmasks=torch.zeros((M, N), device=dev), ptr=0, size=0,
                           per_tree=self.tree.init(dev) if self.tree else None,
                           cum_rewards=(torch.zeros((M, N), device=dev)
                                        if self.if_use_cum_rewards else None))

    def update(self, buf: BufferState, items: Tuple[torch.Tensor, ...]) -> BufferState:
        """Insert a rollout ``(states, actions, rewards, undones, unmasks)`` of
        shape ``(H, N, ...)`` at the ring pointer, in place."""
        h = items[0].shape[0]
        idx = (buf.ptr + torch.arange(h, device=buf.states.device)) % self.max_size
        for dst, src in zip(buf[:5], items):
            dst.index_copy_(0, idx, src.to(dst.dtype))
        if self.tree is not None:   # fresh rows get the maximum priority
            self.tree.update(buf.per_tree, idx,
                             torch.full((h, self.num_seqs), 10.0, device=idx.device))
        return buf._replace(ptr=(buf.ptr + h) % self.max_size,
                            size=min(buf.size + h, self.max_size))

    @staticmethod
    def _needs(ok: bool, what: str) -> None:
        if not ok:
            raise ValueError(what)

    def sample_len(self, buf: BufferState) -> int:
        return max(buf.size - 1, 1)

    def draw(self, buf: BufferState, gen: torch.Generator, count: int, batch_size: int,
             rows: bool) -> torch.Tensor:
        """``count`` minibatches' draws from ``gen``: ``(count, batch_size)``
        flat ids for :meth:`sample`, ``(count, R)`` time rows for
        :meth:`sample_rows`, or under PER the stratified uniforms ``(count, N,
        batch_size // N)`` for :meth:`sample_for_per`."""
        if self.tree is not None:
            return self.tree.draw(gen, count, batch_size // self.num_seqs)
        n = self.sample_len(buf)
        if rows:
            return torch.randint(0, n, (count, batch_size // self.num_seqs), generator=gen,
                                 device=gen.device)
        return torch.randint(0, n * self.num_seqs, (count, batch_size), generator=gen,
                             device=gen.device)

    def sample(self, buf: BufferState, batch_size: int, gen: Optional[torch.Generator] = None,
               ids: Optional[torch.Tensor] = None, feature_major: bool = False
               ) -> Tuple[torch.Tensor, ...]:
        """Uniform sample of ``batch_size`` transitions, from ``ids`` (flat
        ids below ``sample_len * num_seqs``) or drawn from ``gen``; returns
        ``(state, action, reward, undone, unmask, next_state, (ids0, ids1))``,
        leading axis ``batch_size`` (any leading shape of ``ids``; see
        :meth:`gather` for ``feature_major``)."""
        if ids is None:
            ids = self.draw(buf, gen, 1, batch_size, rows=False)[0]
        n = self.sample_len(buf)
        return self.gather(buf, ids % n, ids // n, feature_major)

    def gather(self, buf: BufferState, ids0: torch.Tensor, ids1: torch.Tensor,
               feature_major: bool = False) -> Tuple[torch.Tensor, ...]:
        """The transitions at rows ``ids0`` of sequences ``ids1``: ``(state,
        action, reward, undone, unmask, next_state, (ids0, ids1))``, all six
        fields in one K11a launch on a card (``use_gather_kernel``).  With
        ``feature_major`` the state, next state and (continuous) action come
        out ``ids.shape[:-1] + (dim, B)``, contiguous."""
        fn = (kernels.buffer_gather_fields if self.use_gather_kernel
              else kernels.buffer_gather_fields_reference)
        fm = bool(feature_major)
        fields = [(buf.states, 0, fm), (buf.actions, 0, fm and buf.actions.dim() == 3),
                  (buf.rewards, 0, False), (buf.undones, 0, False), (buf.unmasks, 0, False),
                  (buf.states, 1, fm)]
        s, a, r, ud, um, ns = fn(fields, ids0, ids1)
        return s, a, r, ud, um, ns, (ids0, ids1)

    def sample_rows(self, buf: BufferState, batch_size: int,
                    gen: Optional[torch.Generator] = None,
                    rows: Optional[torch.Tensor] = None, feature_major: bool = False
                    ) -> Tuple[torch.Tensor, ...]:
        """Row-stratified sample: ``R = batch_size // num_seqs`` whole time
        rows (``rows``, or drawn from ``gen``), every env column of them;
        sample ``b = r * num_seqs + n``.  Same return contract as
        :meth:`sample`; ``rows`` may carry leading axes, ``(..., R)``."""
        if rows is None:
            rows = self.draw(buf, gen, 1, batch_size, rows=True)[0]
        N = self.num_seqs
        lead = rows.shape[:-1]
        cols = torch.arange(N, device=rows.device, dtype=rows.dtype)
        ids0 = rows[..., :, None].expand(lead + (rows.shape[-1], N)).reshape(lead + (-1,))
        ids1 = cols.expand(lead + (rows.shape[-1], N)).reshape(lead + (-1,))
        return self.gather(buf, ids0, ids1, feature_major)

    def per_ids(self, buf: BufferState, batch_size: int, u: torch.Tensor):
        """The PER draw for uniforms ``u (..., N, sub)``: ``(ids0, ids1,
        weights)``, each ``(..., batch_size)`` in sequence-major order, with
        ``ids0 = min(ids0, size - 2)`` and the importance weights ``(prio /
        min_prio)^-beta`` against each sequence's least priority."""
        self._needs(self.tree is not None, 'prioritised replay needs if_use_per=True')
        assert batch_size % self.num_seqs == 0
        ids0, prios = self.tree.sample(buf.per_tree, batch_size // self.num_seqs, u)
        ids0 = torch.clamp(ids0, max=buf.size - 2)
        ids1 = torch.arange(self.num_seqs, device=ids0.device)[:, None].expand(ids0.shape)
        min_prio = torch.clamp(self.tree.min_leaf(buf.per_tree, buf.size), min=1e-8)
        weights = torch.pow(prios / min_prio[:, None], -self.per_beta)
        lead = ids0.shape[:-2]
        return (ids0.reshape(lead + (-1,)), ids1.reshape(lead + (-1,)),
                weights.reshape(lead + (-1,)))

    def sample_for_per(self, buf: BufferState, batch_size: int,
                       gen: Optional[torch.Generator] = None,
                       u: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
        """PER sample from the tree as it stands, with the stratified
        uniforms ``u (N, sub)`` (drawn from ``gen`` when None); returns
        ``(state, action, reward, undone, unmask, next_state, is_weight,
        (ids0, ids1))``."""
        if u is None:
            u = self.tree.draw(gen, 1, batch_size // self.num_seqs)[0]
        ids0, ids1, weights = self.per_ids(buf, batch_size, u)
        return self.gather(buf, ids0, ids1)[:6] + (weights, (ids0, ids1))

    def td_error_update_for_per(self, buf: BufferState, ids: Tuple[torch.Tensor, torch.Tensor],
                                td_error: torch.Tensor) -> BufferState:
        """Priority update ``prob = clip(td, 1e-8, 10)^alpha``, in place."""
        self._needs(self.tree is not None, 'prioritised replay needs if_use_per=True')
        ids0, ids1 = ids
        prob = torch.pow(torch.clamp(td_error, 1e-8, 10.0), self.per_alpha)
        self.tree.update_scattered(buf.per_tree, ids0, ids1, prob)
        return buf

    def update_cum_rewards(self, buf: BufferState, horizon_len: int,
                           cum_rewards: torch.Tensor) -> BufferState:
        """Write the discounted returns ``(horizon_len, N)`` of the rows that
        end at the ring pointer, in place."""
        self._needs(buf.cum_rewards is not None,
                    'the cumulative-return column needs lambda_fit_cum_r != 0')
        idx = (buf.ptr - horizon_len + torch.arange(horizon_len, device=cum_rewards.device)
               ) % self.max_size
        buf.cum_rewards.index_copy_(0, idx, cum_rewards.to(buf.cum_rewards.dtype))
        return buf

    def save_or_load_history(self, buf: BufferState, cwd: str, if_save: bool) -> BufferState:
        """Save the buffer to, or load it from, ``{cwd}/replay_buffer.npz``:
        every field, the PER tree as its ``(N, max_size)`` leaves
        (``per_leaves``; the sums are rebuilt on load) and ``cum_rewards``,
        under the JAX package's keys."""
        path = os.path.join(cwd, 'replay_buffer.npz')
        if if_save:
            # bf16 fields are widened to float32 (numpy has no bf16; lossless)
            arrays = {k: (v.detach().cpu().float().numpy() if isinstance(v, torch.Tensor)
                          and v.dtype == torch.bfloat16
                          else v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                          else np.asarray(v, np.int32))
                      for k, v in buf._asdict().items() if v is not None and k != 'per_tree'}
            if buf.per_tree is not None:
                arrays['per_leaves'] = self.tree.leaves(buf.per_tree).detach().cpu().numpy()
            np.savez_compressed(path, **arrays)
            print(f"| buffer.save_or_load_history(): Save {path}", flush=True)
            return buf
        if os.path.isfile(path):
            with np.load(path) as d:
                print(f"| buffer.save_or_load_history(): Load {path}", flush=True)

                def t(key, like):
                    return torch.as_tensor(d[key], device=like.device).to(like.dtype)

                buf = buf._replace(**{k: t(k, getattr(buf, k)) for k in BufferState._fields[:5]},
                                   ptr=int(d['ptr']), size=int(d['size']))
                if 'cum_rewards' in d.files and buf.cum_rewards is not None:
                    buf = buf._replace(cum_rewards=t('cum_rewards', buf.cum_rewards))
                if 'per_leaves' in d.files and self.tree is not None:
                    buf = buf._replace(per_tree=self.tree.from_leaves(
                        torch.as_tensor(d['per_leaves'], device=self.device)))
        return buf
