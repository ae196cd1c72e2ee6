"""Carry PPO weights and optimizer state between the JAX package's layout
and the port's, through numpy.

The JAX ``PPOState`` after ``jax.tree.map(np.asarray, state)`` is

- ``act = {'mlp': [(w, b), (w, b), (w, b)], 'std_log': (1, A)}``, ``w`` as
  ``(in, out)``, without ``std_log`` for a discrete agent;
  ``cri = [(w, b), (w, b), (w, b)]``;
- ``act_opt``/``cri_opt``: optax chain states whose ``[1][0]`` is
  ``ScaleByAdamState(count, mu, nu)`` with ``mu``/``nu`` shaped like the
  params;
- ``norm_avg``, ``norm_std``.

It is read by field name where there is one and by position otherwise,
so nothing of JAX or optax is imported.  :func:`ppo_state_to_numpy`
returns the same nesting with local NamedTuples, leaf for leaf in JAX's
flatten order (dict keys sorted), so tests compare the two trees leaf by
leaf.  :func:`env_state_from_numpy` carries an env state (any NamedTuple
of arrays with the port's field names) across the same way.

The off-policy states are carried the same way: the JAX ``DQNState(q,
q_target, opt)`` with its Q dict (``{'mlp': ...}`` or ``enc``/``val1``/
``adv1``/``val2``/``adv2``), ``DDPGState(act, act_target, cri, cri_target,
act_opt, cri_opt)`` and the replay ``BufferState`` with its PER tree
``(sums, leaves)`` and cumulative-return column (each None when unused, and
then no leaf); the port's flat buffers follow
``ops/nets.py:dqn_param_shapes``/``ddpg_param_shapes``.  The H-term states
(``PPOHtermState``, ``DDPGHtermState``, ``SACHtermState``) add the ring
``h_buf = HtermBuffer(states, actions, masks, returns, ptr, count)`` as their
last field; ``EmbedDQNState(q, q_target, opt)`` has the Q dict ``{'emb',
'mlp'}`` (``AgentEmbedDQN``) or ``{'emb', 'enc', 'heads'}`` with stacked
heads (``AgentEnsembleDQN``).
``SACState(act, act_target, cri, cri_target, act_opt, cri_opt, alpha_log,
alpha_opt, update_a)`` has the actor dict ``enc``/``head`` (ModSAC ``enc``/
``avg``/``std``), the critic ``{'enc', 'heads'}`` whose heads are stacked
along a leading ensemble axis (the port keeps them head by head,
``sac_cri_shapes``), ``act_target`` None for SAC, and int32 ``update_a``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..agents.base import AdamState
from ..agents.ppo import PPOState, modules_from_flat


class NumpyPPOState(NamedTuple):
    act: dict
    cri: list
    act_opt: tuple
    cri_opt: tuple
    norm_avg: np.ndarray
    norm_std: np.ndarray


class NumpyHtermBuffer(NamedTuple):
    states: np.ndarray
    actions: np.ndarray
    masks: np.ndarray
    returns: np.ndarray
    ptr: np.ndarray
    count: np.ndarray


def hterm_to_numpy(h_buf) -> NumpyHtermBuffer:
    return NumpyHtermBuffer(*[x.detach().cpu().numpy().copy() for x in h_buf[:4]],
                            ptr=np.asarray(h_buf.ptr, np.int32),
                            count=np.asarray(h_buf.count, np.int32))


def hterm_from_numpy(tree, device):
    from ..agents.hterm import HtermBuffer
    t = lambda name: torch.tensor(np.asarray(getattr(tree, name)), dtype=torch.float32,  # noqa: E731
                                  device=device)
    return HtermBuffer(*[t(name) for name in HtermBuffer._fields[:4]],
                       ptr=int(np.asarray(tree.ptr)), count=int(np.asarray(tree.count)))


def _with_h_buf(numpy_state, state, tree_class):
    """The numpy state of an H-term agent: the base fields and ``h_buf``."""
    if not hasattr(state, 'h_buf'):
        return numpy_state
    return tree_class(*numpy_state, hterm_to_numpy(state.h_buf))


def _h_buf_of(tree, device) -> dict:
    h = getattr(tree, 'h_buf', None)
    return {} if h is None else {'h_buf': hterm_from_numpy(h, device)}


class NumpyAdamState(NamedTuple):
    count: np.ndarray
    mu: Any
    nu: Any


def _field(tree, name: str, index: int):
    return getattr(tree, name) if hasattr(tree, name) else tree[index]


def _flat_pairs(pairs) -> np.ndarray:
    """One flat float32 vector of ``[(w (in, out), b), ...]`` as ``W (out, in), b``."""
    parts = [p for w, b in pairs for p in (np.asarray(w).T, np.asarray(b))]
    return np.concatenate([p.reshape(-1) for p in parts]).astype(np.float32)


def _flat_act(act) -> np.ndarray:
    flat = _flat_pairs(act['mlp'])
    if 'std_log' in act:
        flat = np.concatenate([flat, np.asarray(act['std_log'], np.float32).reshape(-1)])
    return flat


def ppo_state_from_numpy(tree, device):
    """The port's agent state from a numpy JAX ``PPOState`` (or
    ``PPOHtermState``)."""
    act, cri = _field(tree, 'act', 0), _field(tree, 'cri', 1)
    mlp = act['mlp']
    state_dim = np.asarray(mlp[0][0]).shape[0]
    net_dims = tuple(np.asarray(w).shape[1] for w, _ in mlp[:-1])
    action_dim = np.asarray(mlp[-1][0]).shape[1]
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device)  # noqa: E731
    act_flat, cri_flat = t(_flat_act(act)), t(_flat_pairs(cri))
    a_mod, c_mod = modules_from_flat(act_flat, cri_flat, state_dim, net_dims, action_dim,
                                     discrete='std_log' not in act)

    base = (a_mod, c_mod, act_flat, cri_flat,
            _adam_from(_field(tree, 'act_opt', 2), _flat_act, t),
            _adam_from(_field(tree, 'cri_opt', 3), _flat_pairs, t),
            t(_field(tree, 'norm_avg', 4)), t(_field(tree, 'norm_std', 5)))
    h = _h_buf_of(tree, device)
    if h:
        from ..agents.ppo import PPOHtermState
        return PPOHtermState(*base, **h)
    return PPOState(*base)


def _unflat_act(flat: torch.Tensor, act_module) -> dict:
    layers = act_module.mlp.layers
    leaves, off = [], 0
    flat = flat.detach().cpu().numpy().copy()   # a snapshot, not a view
    for layer in layers:
        o, i = layer.weight.shape
        w = flat[off:off + o * i].reshape(o, i).T
        off += o * i
        b = flat[off:off + o]
        off += o
        leaves.append((w.copy(), b))
    if act_module.std_log is None:
        return {'mlp': leaves}
    a = layers[-1].weight.shape[0]
    return {'mlp': leaves, 'std_log': flat[off:off + a].reshape(1, a)}


def _unflat_cri(flat: torch.Tensor, cri_module) -> list:
    leaves, off = [], 0
    flat = flat.detach().cpu().numpy().copy()   # a snapshot, not a view
    for layer in cri_module.layers:
        o, i = layer.weight.shape
        w = flat[off:off + o * i].reshape(o, i).T
        off += o * i
        leaves.append((w.copy(), flat[off:off + o]))
        off += o
    return leaves


class NumpyPPOHtermState(NamedTuple):
    act: dict
    cri: list
    act_opt: tuple
    cri_opt: tuple
    norm_avg: np.ndarray
    norm_std: np.ndarray
    h_buf: NumpyHtermBuffer


def ppo_state_to_numpy(state: PPOState):
    """The JAX package's nesting of the port's agent state, as numpy."""
    def opt(o, unflat, module):
        adam = NumpyAdamState(np.asarray(o.count, np.int32), unflat(o.mu, module),
                              unflat(o.nu, module))
        return ((), (adam, ()))

    return _with_h_buf(NumpyPPOState(
        act=_unflat_act(state.act_flat, state.act),
        cri=_unflat_cri(state.cri_flat, state.cri),
        act_opt=opt(state.act_opt, _unflat_act, state.act),
        cri_opt=opt(state.cri_opt, _unflat_cri, state.cri),
        norm_avg=state.norm_avg.detach().cpu().numpy().copy(),
        norm_std=state.norm_std.detach().cpu().numpy().copy()), state, NumpyPPOHtermState)


def env_state_from_numpy(state_class, tree, device):
    """The port's env state ``state_class`` from a JAX env state whose fields
    carry the same names, as tensors on ``device`` (dtypes kept)."""
    return state_class(*[torch.tensor(np.asarray(getattr(tree, name)), device=device)
                         for name in state_class._fields])


# ------------------------------------------------------------ off-policy

class NumpyDQNState(NamedTuple):
    q: dict
    q_target: dict
    opt: tuple


class NumpyDDPGState(NamedTuple):
    act: list
    act_target: list
    cri: list
    cri_target: list
    act_opt: tuple
    cri_opt: tuple


class NumpyDDPGHtermState(NamedTuple):
    act: list
    act_target: list
    cri: list
    cri_target: list
    act_opt: tuple
    cri_opt: tuple
    h_buf: NumpyHtermBuffer


class NumpyBufferState(NamedTuple):
    states: np.ndarray
    actions: np.ndarray
    rewards: np.ndarray
    undones: np.ndarray
    unmasks: np.ndarray
    ptr: np.ndarray
    size: np.ndarray
    per_tree: Any = None
    cum_rewards: Any = None


def _pairs(flat: torch.Tensor, shapes) -> list:
    """``[(w (in, out), b), ...]`` numpy snapshots of a flat buffer whose leaf
    shapes are ``W (out, in), b (out,)`` pairs."""
    from ..ops.nets import split_flat
    leaves = [x.detach().cpu().numpy().copy() for x in split_flat(flat, shapes)]
    return [(leaves[i].T.copy(), leaves[i + 1]) for i in range(0, len(leaves), 2)]


def _dqn_groups(twin: bool, duel: bool) -> list:
    """The JAX Q dict's keys in the kernel leaf order (``dqn_flatten``)."""
    if not (twin or duel):
        return ['mlp']
    keys = ['enc', 'val1'] + (['adv1'] if duel else [])
    if twin:
        keys += ['val2'] + (['adv2'] if duel else [])
    return keys


def _dqn_q_flat(q: dict, twin: bool, duel: bool) -> np.ndarray:
    return _flat_pairs([pair for key in _dqn_groups(twin, duel) for pair in q[key]])


def _dqn_q_tree(flat: torch.Tensor, twin: bool, duel: bool, shapes) -> dict:
    pairs = _pairs(flat, shapes)
    if not (twin or duel):
        return {'mlp': pairs}
    out, i = {}, 0
    for key in _dqn_groups(twin, duel):
        n = 2 if key == 'enc' else 1
        out[key] = pairs[i:i + n]
        i += n
    return out


def _adam_tree(opt, unflat) -> tuple:
    return ((), (NumpyAdamState(np.asarray(opt.count, np.int32), unflat(opt.mu),
                                unflat(opt.nu)), ()))


def _adam_from(opt, flatten, t) -> AdamState:
    st = opt[1][0]
    return AdamState(int(np.asarray(_field(st, 'count', 0))),
                     t(flatten(_field(st, 'mu', 1))), t(flatten(_field(st, 'nu', 2))))


def dqn_state_from_numpy(tree, device, twin: bool, duel: bool):
    """The port's ``DQNState`` from a numpy JAX ``DQNState``."""
    from ..agents.dqn import DQNState
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    flat = lambda q: _dqn_q_flat(q, twin, duel)  # noqa: E731
    return DQNState(t(flat(_field(tree, 'q', 0))), t(flat(_field(tree, 'q_target', 1))),
                    _adam_from(_field(tree, 'opt', 2), flat, t))


def dqn_state_to_numpy(state, shapes, twin: bool, duel: bool) -> NumpyDQNState:
    """The JAX package's nesting of a port ``DQNState`` whose flat buffers have
    the leaf ``shapes`` (``ops/nets.py:dqn_param_shapes``), as numpy."""
    unflat = lambda flat: _dqn_q_tree(flat, twin, duel, shapes)  # noqa: E731
    return NumpyDQNState(unflat(state.q), unflat(state.q_target), _adam_tree(state.opt, unflat))


def ddpg_state_from_numpy(tree, device):
    """The port's ``DDPGState`` (or ``DDPGHtermState``) from a numpy JAX one."""
    from ..agents.ddpg_td3 import DDPGHtermState, DDPGState
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    f = lambda name, i: t(_flat_pairs(_field(tree, name, i)))  # noqa: E731
    base = (f('act', 0), f('act_target', 1), f('cri', 2), f('cri_target', 3),
            _adam_from(_field(tree, 'act_opt', 4), _flat_pairs, t),
            _adam_from(_field(tree, 'cri_opt', 5), _flat_pairs, t))
    h = _h_buf_of(tree, device)
    return DDPGHtermState(*base, **h) if h else DDPGState(*base)


def ddpg_state_to_numpy(state, act_shapes, cri_shapes):
    """The JAX package's nesting of a port ``DDPGState``, as numpy."""
    ua = lambda flat: _pairs(flat, act_shapes)  # noqa: E731
    uc = lambda flat: _pairs(flat, cri_shapes)  # noqa: E731
    return _with_h_buf(NumpyDDPGState(ua(state.act), ua(state.act_target), uc(state.cri),
                                      uc(state.cri_target), _adam_tree(state.act_opt, ua),
                                      _adam_tree(state.cri_opt, uc)), state, NumpyDDPGHtermState)


def buffer_state_from_numpy(tree, device):
    """The port's ``BufferState`` from a numpy JAX ``BufferState``."""
    from ..train.replay_buffer import BufferState
    t = lambda a: torch.tensor(np.asarray(a), device=device)  # noqa: E731
    per_tree = getattr(tree, 'per_tree', None)
    cum = getattr(tree, 'cum_rewards', None)
    return BufferState(*[t(getattr(tree, name)) for name in BufferState._fields[:5]],
                       ptr=int(np.asarray(tree.ptr)), size=int(np.asarray(tree.size)),
                       per_tree=None if per_tree is None else tuple(t(x) for x in per_tree),
                       cum_rewards=None if cum is None else t(cum))


def buffer_state_to_numpy(buf) -> NumpyBufferState:
    """The JAX package's leaves of a port ``BufferState``, as numpy (bf16
    storage widened to float32, as the JAX package saves it)."""
    a = lambda x: None if x is None else (  # noqa: E731
        x.detach().cpu().float() if x.dtype == torch.bfloat16 else x.detach().cpu()
    ).numpy().copy()
    return NumpyBufferState(*[a(x) for x in buf[:5]],
                            ptr=np.asarray(buf.ptr, np.int32), size=np.asarray(buf.size, np.int32),
                            per_tree=None if buf.per_tree is None else tuple(
                                a(x) for x in buf.per_tree),
                            cum_rewards=a(buf.cum_rewards))


class NumpySACState(NamedTuple):
    act: dict
    act_target: Any          # None for SAC
    cri: dict
    cri_target: dict
    act_opt: tuple
    cri_opt: tuple
    alpha_log: np.ndarray
    alpha_opt: tuple
    update_a: np.ndarray


class NumpySACHtermState(NamedTuple):
    act: dict
    act_target: Any
    cri: dict
    cri_target: dict
    act_opt: tuple
    cri_opt: tuple
    alpha_log: np.ndarray
    alpha_opt: tuple
    update_a: np.ndarray
    h_buf: NumpyHtermBuffer


def _sac_act_flat(act: dict, modsac: bool) -> np.ndarray:
    """The JAX actor dict in the kernel leaf order: enc, then head or avg, std."""
    keys = ('enc', 'avg', 'std') if modsac else ('enc', 'head')
    return _flat_pairs([pair for key in keys for pair in act[key]])


def _sac_act_tree(flat: torch.Tensor, shapes, modsac: bool) -> dict:
    pairs = _pairs(flat, shapes)
    if modsac:
        return {'enc': pairs[:-2], 'avg': pairs[-2:-1], 'std': pairs[-1:]}
    return {'enc': pairs[:-1], 'head': pairs[-1:]}


def _sac_cri_flat(cri: dict) -> np.ndarray:
    """The encoder, then head by head: the stacked ``ensemble_init`` layers
    ``[(w (E, in, out), b (E, out)), ...]`` unstacked."""
    heads = [(np.asarray(w), np.asarray(b)) for w, b in cri['heads']]
    E = heads[0][0].shape[0]
    return np.concatenate([_flat_pairs(cri['enc'])]
                          + [_flat_pairs([(w[e], b[e]) for w, b in heads]) for e in range(E)])


def _sac_cri_tree(flat: torch.Tensor, shapes, num_ensembles: int) -> dict:
    pairs = _pairs(flat, shapes)
    nl = (len(pairs) - 1) // num_ensembles
    heads = [pairs[1 + e * nl:1 + (e + 1) * nl] for e in range(num_ensembles)]
    return {'enc': pairs[:1],
            'heads': [(np.stack([h[i][0] for h in heads]), np.stack([h[i][1] for h in heads]))
                      for i in range(nl)]}


def sac_state_from_numpy(tree, device, modsac: bool):
    """The port's ``SACState`` (or ``SACHtermState``) from a numpy JAX one."""
    from ..agents.sac import SACHtermState, SACState
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device)  # noqa: E731
    fa = lambda act: _sac_act_flat(act, modsac)  # noqa: E731
    act_target = _field(tree, 'act_target', 1)
    h = _h_buf_of(tree, device)
    return (SACHtermState if h else SACState)(
                    t(fa(_field(tree, 'act', 0))),
                    None if act_target is None else t(fa(act_target)),
                    t(_sac_cri_flat(_field(tree, 'cri', 2))),
                    t(_sac_cri_flat(_field(tree, 'cri_target', 3))),
                    _adam_from(_field(tree, 'act_opt', 4), fa, t),
                    _adam_from(_field(tree, 'cri_opt', 5), _sac_cri_flat, t),
                    t(_field(tree, 'alpha_log', 6)),
                    _adam_from(_field(tree, 'alpha_opt', 7), np.asarray, t),
                    int(np.asarray(_field(tree, 'update_a', 8))), **h)


def sac_state_to_numpy(state, act_shapes, cri_shapes, modsac: bool,
                       num_ensembles: int) -> NumpySACState:
    """The JAX package's nesting of a port ``SACState`` (dict keys sorted as
    JAX flattens them), as numpy."""
    ua = lambda flat: _sac_act_tree(flat, act_shapes, modsac)  # noqa: E731
    uc = lambda flat: _sac_cri_tree(flat, cri_shapes, num_ensembles)  # noqa: E731
    scalar = lambda x: x.detach().cpu().numpy().copy()  # noqa: E731
    return _with_h_buf(NumpySACState(
        ua(state.act), None if state.act_target is None else ua(state.act_target),
        uc(state.cri), uc(state.cri_target), _adam_tree(state.act_opt, ua),
        _adam_tree(state.cri_opt, uc), scalar(state.alpha_log),
        _adam_tree(state.alpha_opt, scalar), np.asarray(state.update_a, np.int32)),
        state, NumpySACHtermState)


# ------------------------------------------------------- Embed-DQN family

def _embed_q_flat(q: dict, ensemble: bool) -> np.ndarray:
    """The JAX Q dict in the port's flat order: the embedding, then the MLP
    or the encoder and the unstacked heads."""
    emb = np.asarray(q['emb'], np.float32).reshape(-1)
    net = _sac_cri_flat(q) if ensemble else _flat_pairs(q['mlp'])
    return np.concatenate([emb, net]).astype(np.float32)


def _embed_q_tree(flat: torch.Tensor, shapes, ensemble: bool, num_ensembles: int) -> dict:
    A, e = shapes[0]
    emb = flat[:A * e].detach().cpu().numpy().copy().reshape(A, e)
    if ensemble:
        return {'emb': emb, **_sac_cri_tree(flat[A * e:], shapes[1:], num_ensembles)}
    return {'emb': emb, 'mlp': _pairs(flat[A * e:], shapes[1:])}


def embed_dqn_state_from_numpy(tree, device, ensemble: bool):
    """The port's ``EmbedDQNState`` from a numpy JAX ``EmbedDQNState``."""
    from ..agents.embed_dqn import EmbedDQNState
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    flat = lambda q: _embed_q_flat(q, ensemble)  # noqa: E731
    return EmbedDQNState(t(flat(_field(tree, 'q', 0))), t(flat(_field(tree, 'q_target', 1))),
                         _adam_from(_field(tree, 'opt', 2), flat, t))


def embed_dqn_state_to_numpy(state, shapes, ensemble: bool, num_ensembles: int):
    """The JAX package's nesting of a port ``EmbedDQNState``, as numpy."""
    unflat = lambda flat: _embed_q_tree(flat, shapes, ensemble, num_ensembles)  # noqa: E731
    return NumpyDQNState(unflat(state.q), unflat(state.q_target), _adam_tree(state.opt, unflat))


# ------------------------------------------------------------ pixel PPO
# The JAX ``PixelPPOState(act, cri, act_opt, cri_opt)``: ``act = {'conv':
# [(w HWIO, b), ..., (w (in, out), b)], 'mlp': [(w, b), ...], 'std_log': (1,
# A)}``, ``cri = {'conv', 'mlp'}``; the optimizer states' Adam moments shaped
# like the params.  The port's flat buffers hold the conv leaves (OIHW, the
# linear layer (out, in)), the MLP's, then ``std_log``
# (``agents/pixel.py:pixel_ppo_shapes``).

class NumpyPixelPPOState(NamedTuple):
    act: dict
    cri: dict
    act_opt: tuple
    cri_opt: tuple


def _flat_pixel(net) -> np.ndarray:
    conv = net['conv']
    parts = [p for w, b in conv[:-1] for p in (np.transpose(np.asarray(w), (3, 2, 0, 1)),
                                                np.asarray(b))]
    parts += [np.asarray(conv[-1][0]).T, np.asarray(conv[-1][1])]
    flat = np.concatenate([np.concatenate([p.reshape(-1) for p in parts]),
                           _flat_pairs(net['mlp'])])
    if 'std_log' in net:
        flat = np.concatenate([flat, np.asarray(net['std_log']).reshape(-1)])
    return flat.astype(np.float32)


def _pixel_tree(flat: torch.Tensor, shapes, n_conv: int) -> dict:
    from ..ops.nets import split_flat
    leaves = [x.detach().cpu().numpy().copy() for x in split_flat(flat, shapes)]
    conv = [(np.ascontiguousarray(np.transpose(leaves[i], (2, 3, 1, 0))), leaves[i + 1])
            for i in range(0, n_conv - 2, 2)]
    conv.append((leaves[n_conv - 2].T.copy(), leaves[n_conv - 1]))
    n_mlp = len(leaves) - n_conv - (len(leaves) - n_conv) % 2
    mlp = [(leaves[i].T.copy(), leaves[i + 1]) for i in range(n_conv, n_conv + n_mlp, 2)]
    tree = {'conv': conv, 'mlp': mlp}
    if len(leaves) > n_conv + n_mlp:
        tree['std_log'] = leaves[-1]
    return tree


def pixel_ppo_state_from_numpy(tree, device):
    """The port's ``PixelPPOState`` from a numpy JAX one, Adam moments
    included."""
    from ..agents.pixel import PixelPPOState
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return PixelPPOState(t(_flat_pixel(_field(tree, 'act', 0))),
                         t(_flat_pixel(_field(tree, 'cri', 1))),
                         _adam_from(_field(tree, 'act_opt', 2), _flat_pixel, t),
                         _adam_from(_field(tree, 'cri_opt', 3), _flat_pixel, t))


def pixel_ppo_state_to_numpy(state, act_shapes, cri_shapes, n_conv: int) -> NumpyPixelPPOState:
    """The JAX package's nesting of a port ``PixelPPOState``, as numpy."""
    ua = lambda flat: _pixel_tree(flat, act_shapes, n_conv)  # noqa: E731
    uc = lambda flat: _pixel_tree(flat, cri_shapes, n_conv)  # noqa: E731
    return NumpyPixelPPOState(ua(state.act), uc(state.cri), _adam_tree(state.act_opt, ua),
                              _adam_tree(state.cri_opt, uc))


# ------------------------------------------------------------------ marl/
# The multi-agent states keep the JAX package's nesting (dicts, lists of
# ``(w, b)`` with ``w`` as ``(in, out)``, NamedTuples) as views of one flat
# buffer per optimised group, in the JAX flatten order; their Adam moments
# are flat buffers over the same order.

def _torch_tree(tree, device):
    """A numpy tree as float32 tensors on ``device``, the nesting kept."""
    from ..utils.checkpoint import tree_leaves, tree_unflatten
    return tree_unflatten(tree, iter([torch.tensor(np.asarray(x), dtype=torch.float32,
                                                   device=device)
                                      for x in tree_leaves(tree)]))


def _flat_group(tree, device):
    """``(flat, views)`` of a numpy parameter tree (``marl/env.py:flat_tree``)."""
    from ..marl.env import flat_tree
    return flat_tree(_torch_tree(tree, device), device)


def _marl_adam(opt, device) -> AdamState:
    """The port's ``AdamState`` from an optax clip-then-Adam chain state."""
    from ..utils.checkpoint import tree_leaves
    st = opt[1][0]
    flat = lambda tree: torch.tensor(np.concatenate(  # noqa: E731
        [np.asarray(x, np.float32).reshape(-1) for x in tree_leaves(tree)]), device=device)
    return AdamState(int(np.asarray(_field(st, 'count', 0))), flat(_field(st, 'mu', 1)),
                     flat(_field(st, 'nu', 2)))


def _marl_adam_tree(opt: AdamState, template) -> tuple:
    """The optax chain state's nesting of ``opt`` over ``template``'s leaves."""
    from ..marl.env import tree_numpy, tree_views
    return ((), (NumpyAdamState(np.asarray(opt.count, np.int32),
                                tree_numpy(tree_views(opt.mu, template)),
                                tree_numpy(tree_views(opt.nu, template))), ()))


class NumpyMAPPOState(NamedTuple):
    actor: dict
    critic: list
    act_opt: tuple
    cri_opt: tuple


def mappo_state_from_numpy(tree, device):
    """The port's ``MAPPOState`` from a numpy JAX ``MAPPOState``."""
    from ..marl.mappo import MAPPOState
    act_flat, actor = _flat_group(_field(tree, 'actor', 0), device)
    cri_flat, critic = _flat_group(_field(tree, 'critic', 1), device)
    return MAPPOState(actor, critic, _marl_adam(_field(tree, 'act_opt', 2), device),
                      _marl_adam(_field(tree, 'cri_opt', 3), device), act_flat, cri_flat)


def mappo_state_to_numpy(state) -> NumpyMAPPOState:
    from ..marl.env import tree_numpy
    return NumpyMAPPOState(tree_numpy(state.actor), tree_numpy(state.critic),
                           _marl_adam_tree(state.act_opt, state.actor),
                           _marl_adam_tree(state.cri_opt, state.critic))


def _keep_dtype(tree, device):
    """A numpy tree as tensors on ``device``, dtypes kept (float64 as float32)."""
    from ..utils.checkpoint import tree_leaves, tree_unflatten

    def t(x):
        x = np.asarray(x)
        return torch.tensor(x.astype(np.float32) if x.dtype == np.float64 else x, device=device)
    return tree_unflatten(tree, iter([t(x) for x in tree_leaves(tree)]))


class NumpyMADDPGState(NamedTuple):
    actor: list
    actor_target: list
    critic: list
    critic_target: list
    a_opt: tuple
    c_opt: tuple
    buf: tuple
    env_states: Any


def maddpg_state_from_numpy(tree, device):
    """The port's ``MADDPGState`` from a numpy JAX ``MADDPGState``."""
    from ..marl.chasing import TeamChaseState
    from ..marl.maddpg import MADDPGState
    act_flat, actor = _flat_group(_field(tree, 'actor', 0), device)
    act_t, actor_t = _flat_group(_field(tree, 'actor_target', 1), device)
    cri_flat, critic = _flat_group(_field(tree, 'critic', 2), device)
    cri_t, critic_t = _flat_group(_field(tree, 'critic_target', 3), device)
    env_states = _field(tree, 'env_states', 7)
    return MADDPGState(actor, actor_t, critic, critic_t,
                       _marl_adam(_field(tree, 'a_opt', 4), device),
                       _marl_adam(_field(tree, 'c_opt', 5), device),
                       tuple(_keep_dtype(tuple(_field(tree, 'buf', 6)), device)),
                       env_state_from_numpy(TeamChaseState, env_states, device),
                       act_flat, act_t, cri_flat, cri_t)


def maddpg_state_to_numpy(state) -> NumpyMADDPGState:
    from ..marl.env import tree_numpy
    return NumpyMADDPGState(tree_numpy(state.actor), tree_numpy(state.actor_target),
                            tree_numpy(state.critic), tree_numpy(state.critic_target),
                            _marl_adam_tree(state.a_opt, state.actor),
                            _marl_adam_tree(state.c_opt, state.critic),
                            tree_numpy(tuple(state.buf)), tree_numpy(state.env_states))


class NumpyQMixState(NamedTuple):
    params: Any
    target: Any
    opt: tuple


def qmix_state_from_numpy(tree, device, rnn: bool = False):
    """The port's ``QMixState`` (``rnn``: ``QMixRnnState``) from a numpy JAX
    one; the parameter NamedTuples keep their JAX fields."""
    if rnn:
        from ..marl.qmix_rnn import QMixRnnParams as P, QMixRnnState as S
    else:
        from ..marl.qmix import QMixParams as P, QMixState as S
    params, target = _field(tree, 'params', 0), _field(tree, 'target', 1)
    flat, p = _flat_group(P(*params), device)
    target_flat, tp = _flat_group(P(*target), device)
    return S(p, tp, _marl_adam(_field(tree, 'opt', 2), device), flat, target_flat)


def qmix_state_to_numpy(state) -> NumpyQMixState:
    from ..marl.env import tree_numpy
    return NumpyQMixState(tree_numpy(state.params), tree_numpy(state.target),
                          _marl_adam_tree(state.opt, state.params))


def qmix_rnn_state_from_numpy(tree, device):
    return qmix_state_from_numpy(tree, device, rnn=True)


qmix_rnn_state_to_numpy = qmix_state_to_numpy


class NumpyMAPPORnnState(NamedTuple):
    actor: dict
    critic: dict
    act_opt: tuple
    cri_opt: tuple


def mappo_rnn_state_from_numpy(tree, device):
    """The port's ``MAPPORnnState`` from a numpy JAX one (the critic's
    ``PopArt`` statistics and head among its leaves)."""
    from ..marl.mappo_rnn import MAPPORnnState, PopArt
    critic = dict(_field(tree, 'critic', 1))
    critic['popart'] = PopArt(*critic['popart'])
    act_flat, actor = _flat_group(_field(tree, 'actor', 0), device)
    cri_flat, critic = _flat_group(critic, device)
    return MAPPORnnState(actor, critic, _marl_adam(_field(tree, 'act_opt', 2), device),
                         _marl_adam(_field(tree, 'cri_opt', 3), device), act_flat, cri_flat)


def mappo_rnn_state_to_numpy(state) -> NumpyMAPPORnnState:
    from ..marl.env import tree_numpy
    return NumpyMAPPORnnState(tree_numpy(state.actor), tree_numpy(state.critic),
                              _marl_adam_tree(state.act_opt, state.actor),
                              _marl_adam_tree(state.cri_opt, state.critic))


# ---- the learned solvers of rlsolver/.  Their parameters keep the JAX
# layout (weights ``(in, out)``, the same NamedTuple fields, tuples and
# dicts), so each converter takes the numpy tree (``jax.tree.map(np.asarray,
# params)``) leaf for leaf, by position, into the port's NamedTuple.

def s2v_params_from_numpy(tree, device):
    from ..rlsolver.s2v_dqn import S2VParams
    return S2VParams(*_torch_tree(tree, device))


def mpnn_params_from_numpy(tree, device):
    """ECO-DQN's ``MPNNParams`` (``w_msg``/``w_upd`` tuples of layers)."""
    from ..rlsolver.eco_dqn import MPNNParams
    return MPNNParams(*_torch_tree(tree, device))


def runcsp_params_from_numpy(tree, device):
    from ..rlsolver.runcsp import RunCSPParams
    return RunCSPParams(*_torch_tree(tree, device))


def l2a_params_from_numpy(tree, device):
    from ..rlsolver.l2a import L2AParams
    return L2AParams(*_torch_tree(tree, device))


def am_params_from_numpy(tree, device):
    """The attention-model TSP's ``AMParams`` (tuples of weights)."""
    from ..rlsolver.attention_tsp import AMParams
    return AMParams(*_torch_tree(tree, device))


def graph_trs_params_from_numpy(tree, device):
    """``GraphTRSParams`` (``layers`` a tuple of dicts)."""
    from ..rlsolver.graph_trs import GraphTRSParams
    return GraphTRSParams(*_torch_tree(tree, device))


def pignn_params_from_numpy(tree, device) -> dict:
    """PI-GNN's parameter dict (``embed``, ``w0``, ``b0``, ``w1``, ``b1``,
    each with its leading replica axis)."""
    return _torch_tree(tree, device)
