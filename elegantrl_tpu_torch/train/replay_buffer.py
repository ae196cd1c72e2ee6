"""Device-resident replay ring buffer (counterpart of
``elegantrl_tpu/train/replay_buffer.py``).

- layout ``(max_size, num_seqs, dim)``: one ring per env sequence, on the
  run's device; discrete actions are int32 ``(max_size, num_seqs)``;
- modular insert at the ring pointer, ``size = min(size + h, max_size)``;
  the insert writes the tensors in place, so the returned ``BufferState``
  shares them with the one passed in (the JAX package donates the buffer);
- uniform sampling over flattened ``(t, seq)`` ids below ``sample_len =
  max(size - 1, 1)``, ``ids0 = ids % sample_len``, ``ids1 = ids //
  sample_len``, with ``next_state = states[ids0 + 1]``, including the
  reference's seam artifact at the ring pointer, kept for parity;
- :meth:`ReplayBuffer.sample_rows`: ``R = batch_size // num_seqs`` whole
  time rows, sample ``b = r * num_seqs + n``.

``ptr`` and ``size`` are Python ints, so the update count of a round is
known on the host without a device sync.  Prioritised replay, the
cumulative-return column and the buffer's save and load are not ported yet
(they come with the slice that ports ``ops/per.py``); their methods raise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class BufferState(NamedTuple):
    states: torch.Tensor    # (M, N, S) float32
    actions: torch.Tensor   # (M, N, A) float32 | (M, N) int32 when discrete
    rewards: torch.Tensor   # (M, N)
    undones: torch.Tensor   # (M, N)
    unmasks: torch.Tensor   # (M, N)
    ptr: int
    size: int


_NOT_PORTED = ('{} is not ported yet: prioritised replay, the cumulative-return column and '
               "the buffer's save and load come with the slice that ports ops/per.py")


class ReplayBuffer:
    """Static buffer description + ops on a :class:`BufferState`."""

    def __init__(self, max_size: int, state_dim: int, action_dim: int,
                 num_seqs: int = 1, if_use_per: bool = False,
                 if_discrete: bool = False, args=None, device='cpu'):
        if if_use_per:
            raise NotImplementedError(_NOT_PORTED.format('if_use_per'))
        if float(getattr(args, 'lambda_fit_cum_r', 0.0)) != 0.0:
            raise NotImplementedError(_NOT_PORTED.format('lambda_fit_cum_r'))
        if str(getattr(args, 'storage_dtype', 'float32')) != 'float32':
            raise NotImplementedError('the PyTorch port stores the replay buffer in float32 only')
        self.max_size = int(max_size)
        self.state_dim = int(state_dim)
        self.action_dim = int(action_dim)
        self.num_seqs = int(num_seqs)
        self.if_discrete = bool(if_discrete)
        self.device = torch.device(device)

    def init(self) -> BufferState:
        M, N, S = self.max_size, self.num_seqs, self.state_dim
        dev = self.device
        actions = (torch.zeros((M, N), dtype=torch.int32, device=dev) if self.if_discrete
                   else torch.zeros((M, N, self.action_dim), device=dev))
        return BufferState(states=torch.zeros((M, N, S), device=dev), actions=actions,
                           rewards=torch.zeros((M, N), device=dev),
                           undones=torch.zeros((M, N), device=dev),
                           unmasks=torch.zeros((M, N), device=dev), ptr=0, size=0)

    def update(self, buf: BufferState, items: Tuple[torch.Tensor, ...]) -> BufferState:
        """Insert a rollout ``(states, actions, rewards, undones, unmasks)`` of
        shape ``(H, N, ...)`` at the ring pointer, in place."""
        h = items[0].shape[0]
        idx = (buf.ptr + torch.arange(h, device=buf.states.device)) % self.max_size
        for dst, src in zip(buf[:5], items):
            dst.index_copy_(0, idx, src.to(dst.dtype))
        return buf._replace(ptr=(buf.ptr + h) % self.max_size,
                            size=min(buf.size + h, self.max_size))

    def sample_len(self, buf: BufferState) -> int:
        return max(buf.size - 1, 1)

    def draw(self, buf: BufferState, gen: torch.Generator, count: int, batch_size: int,
             rows: bool) -> torch.Tensor:
        """``count`` minibatches' draws from ``gen``: ``(count, batch_size)``
        flat ids for :meth:`sample`, or ``(count, R)`` time rows for
        :meth:`sample_rows`."""
        n = self.sample_len(buf)
        if rows:
            return torch.randint(0, n, (count, batch_size // self.num_seqs), generator=gen,
                                 device=gen.device)
        return torch.randint(0, n * self.num_seqs, (count, batch_size), generator=gen,
                             device=gen.device)

    def sample(self, buf: BufferState, batch_size: int, gen: Optional[torch.Generator] = None,
               ids: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
        """Uniform sample of ``batch_size`` transitions, from ``ids`` (flat
        ids below ``sample_len * num_seqs``) or drawn from ``gen``; returns
        ``(state, action, reward, undone, unmask, next_state, (ids0, ids1))``,
        leading axis ``batch_size`` (any leading shape of ``ids``)."""
        if ids is None:
            ids = self.draw(buf, gen, 1, batch_size, rows=False)[0]
        n = self.sample_len(buf)
        ids0, ids1 = ids % n, ids // n
        return (buf.states[ids0, ids1], buf.actions[ids0, ids1], buf.rewards[ids0, ids1],
                buf.undones[ids0, ids1], buf.unmasks[ids0, ids1],
                buf.states[ids0 + 1, ids1], (ids0, ids1))

    def sample_rows(self, buf: BufferState, batch_size: int,
                    gen: Optional[torch.Generator] = None,
                    rows: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
        """Row-stratified sample: ``R = batch_size // num_seqs`` whole time
        rows (``rows``, or drawn from ``gen``), every env column of them;
        sample ``b = r * num_seqs + n``.  Same return contract as
        :meth:`sample`; ``rows`` may carry leading axes, ``(..., R)``."""
        if rows is None:
            rows = self.draw(buf, gen, 1, batch_size, rows=True)[0]
        N = self.num_seqs
        lead = rows.shape[:-1]

        def take(arr, r):
            return arr[r].reshape(lead + (r.shape[-1] * N,) + arr.shape[2:])

        cols = torch.arange(N, device=rows.device, dtype=rows.dtype)
        ids0 = rows[..., :, None].expand(lead + (rows.shape[-1], N)).reshape(lead + (-1,))
        ids1 = cols.expand(lead + (rows.shape[-1], N)).reshape(lead + (-1,))
        return (take(buf.states, rows), take(buf.actions, rows), take(buf.rewards, rows),
                take(buf.undones, rows), take(buf.unmasks, rows),
                take(buf.states, rows + 1), (ids0, ids1))

    def sample_for_per(self, *_args, **_kw):
        raise NotImplementedError(_NOT_PORTED.format('sample_for_per'))

    def td_error_update_for_per(self, *_args, **_kw):
        raise NotImplementedError(_NOT_PORTED.format('td_error_update_for_per'))

    def update_cum_rewards(self, *_args, **_kw):
        raise NotImplementedError(_NOT_PORTED.format('update_cum_rewards'))

    def save_or_load_history(self, *_args, **_kw):
        raise NotImplementedError(_NOT_PORTED.format('save_or_load_history'))
