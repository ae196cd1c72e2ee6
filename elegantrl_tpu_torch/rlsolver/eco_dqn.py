"""ECO-DQN: exploratory combinatorial optimization with reversible
spin-flip episodes (counterpart of ``elegantrl_tpu/rlsolver/eco_dqn.py``).

The agent flips any spin at any time, observes the ECO-DQN per-node
features, is rewarded for new best cuts (divided by n) plus a basin reward
for reaching unvisited local optima, and at test time runs greedy Q
rollouts from random inits, keeping the best cut seen.

As in the JAX package:

- B episodes over a pool of G graphs run as one batch on the device; each
  train step is one batched env step, a replay push and one double-DQN
  minibatch update (``gamma`` 0.95, the target synced every
  ``target_freq`` steps);
- the MPNN's per-edge embedding is two adjacency products for weights in
  {0, +-1} (:func:`_edge_embed`), a chunked sum otherwise;
- the replay ring stores the compact env state (int8 spins) and recomputes
  the observations at sample time;
- visited states are a Zobrist hash ring over the episode's history.  The
  keys are the JAX package's ``uint32`` keys held in ``int64`` (PyTorch's
  ``uint32`` has few operations) and XOR-reduced pairwise, so each hash
  equals the JAX one bitwise;
- Adam (eps 1e-8) follows the ramp-then-decay learning rate, evaluated at
  the step count before it increments; before the ring holds two
  minibatches the gradients are zeroed and Adam still steps;
- with ``mesh=``, the env batch, the replay ring and the draws are sharded
  over the mesh's shards (this process's), each shard sampling
  ``minibatch / n`` rows from its own ring; the gradients and the loss are
  averaged over the shards, ``best`` is their maximum, and one update is
  copied to every shard, so the parameters stay identical.

Each env's random state is the solver's generator (the JAX package keeps a
key per env): ``'spins'`` and ``'gidx'`` at reset, ``'reset_spins'`` (every
env, every step, used where an episode ends), ``'rand_action'``,
``'use_rand'`` and ``'rows'`` each train step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import _same_device
from . import _learn
from ._draws import as_draws, solver_device


# ---------------------------------------------------------------------------
# Spin-system environment (batched)
# ---------------------------------------------------------------------------

class EcoEnvState(NamedTuple):
    spins: torch.Tensor        # (B, n) f32 in {-1, +1}
    score: torch.Tensor        # (B,) current cut value
    best_score: torch.Tensor   # (B,) best cut this episode
    best_spins: torch.Tensor   # (B, n) spins at best
    tsf: torch.Tensor          # (B, n) time-since-flip, already /max_steps
    step: torch.Tensor         # (B,) int64
    gidx: torch.Tensor         # (B,) int64 graph index into the pool
    zhash: torch.Tensor        # (B,) int64 Zobrist hash of the spins (32 bits)
    ring: torch.Tensor         # (B, K) int64 visited-state hashes


class EcoPool(NamedTuple):
    """Static graph pool: G graphs, padded to a common n."""
    adj: torch.Tensor          # (G, n, n) f32 symmetric
    max_local: torch.Tensor    # (G,) max nonzero flip gain at all-ones spins
    zkeys: torch.Tensor        # (n,) int64 Zobrist keys (uint32 values)
    pm_one: bool               # all weights in {0, +-1}: the two-product MPNN path


def build_pool(adjs: np.ndarray, device=None) -> EcoPool:
    """adjs: ``(G, n, n)`` symmetric, on ``device`` (None: the card)."""
    device = solver_device(device, 'build_pool')
    adjs = np.asarray(adjs, np.float32)
    g, n, _ = adjs.shape
    gains = np.einsum('gij,j->gi', adjs, np.ones(n, np.float32))
    ml = np.empty(g, np.float32)
    for i in range(g):
        nz = gains[i][gains[i] != 0]
        ml[i] = np.abs(nz).max() if nz.size else 1.0
    zkeys = np.random.default_rng(12345).integers(0, 2 ** 32, size=n, dtype=np.uint32)
    pm_one = bool(np.all(np.isin(np.unique(adjs), [-1.0, 0.0, 1.0])))
    return EcoPool(adj=torch.as_tensor(adjs, device=device),
                   max_local=torch.as_tensor(ml, device=device),
                   zkeys=torch.as_tensor(zkeys.astype(np.int64), device=device),
                   pm_one=pm_one)


def _cut_value(adj, spins):
    """cut = sum_{i<j} w_ij (1 - s_i s_j) / 2, batched."""
    sas = torch.einsum('bi,bij,bj->b', spins, adj, spins)
    return (torch.sum(adj, dim=(-2, -1)) - sas) / 4.0


def _zobrist(zkeys, spins):
    """The XOR of ``zkeys`` where the spin is up, by pairwise halving."""
    x = torch.where(spins > 0, zkeys[None, :], torch.zeros_like(zkeys)[None, :])
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        x = torch.bitwise_xor(x[..., 0::2], x[..., 1::2])
    return x[..., 0]


def eco_reset(pool: EcoPool, gen, batch: int, ring_len: int,
              gidx: Optional[torch.Tensor] = None, draws=None) -> EcoEnvState:
    """``batch`` episodes from random spins (``'spins'``) on random pool
    graphs (``'gidx'``, unless ``gidx`` is given)."""
    n, dev = pool.adj.shape[-1], pool.adj.device
    d = as_draws(gen, dev, draws)
    if gidx is None:
        gidx = d.randint('gidx', pool.adj.shape[0], (batch,))
    spins = torch.where(d.bernoulli('spins', 0.5, (batch, n)) > 0, 1.0, -1.0)
    score = _cut_value(pool.adj[gidx], spins)
    h = _zobrist(pool.zkeys, spins)
    ring = torch.zeros((batch, ring_len), dtype=torch.int64, device=dev)
    ring[:, 0] = h
    return EcoEnvState(spins=spins, score=score, best_score=score, best_spins=spins,
                       tsf=torch.zeros((batch, n), device=dev),
                       step=torch.zeros(batch, dtype=torch.int64, device=dev),
                       gidx=gidx.to(torch.int64), zhash=h, ring=ring)


def eco_observe(pool: EcoPool, s: EcoEnvState) -> torch.Tensor:
    """``(B, n, 7)`` ECO-DQN observation; the episode-time features are
    capped at the trained range (inference runs past ``max_steps``)."""
    adj = pool.adj[s.gidx]                                # (B, n, n)
    n = adj.shape[-1]
    max_steps = 2 * n
    gains = s.spins * torch.einsum('bij,bj->bi', adj, s.spins)
    ml = pool.max_local[s.gidx][:, None]                  # (B, 1)
    binary = (1.0 - s.spins) / 2.0
    dist_score = torch.abs(s.score - s.best_score)[:, None] / ml
    dist_state = torch.mean((s.spins != s.best_spins).to(torch.float32), -1, keepdim=True)
    greedy_avail = 1.0 - torch.mean((gains <= 0).to(torch.float32), -1, keepdim=True)
    imm = (torch.clamp(s.step[:, None], max=max_steps - 1) / max_steps).to(torch.float32)
    cols = [binary, gains / ml, torch.clamp(s.tsf, max=1.0), dist_score.expand(binary.shape),
            dist_state.expand(binary.shape), greedy_avail.expand(binary.shape),
            imm.expand(binary.shape)]
    return torch.stack(cols, dim=-1)


def eco_step(pool: EcoPool, s: EcoEnvState, action: torch.Tensor, basin_reward: float
             ) -> Tuple[EcoEnvState, torch.Tensor, torch.Tensor]:
    """Flip ``action`` in every env.  Returns ``(state', reward, done)``:
    the score's rise over the episode best, divided by n, plus the basin
    reward at an unvisited local optimum."""
    adj = pool.adj[s.gidx]
    n = adj.shape[-1]
    max_steps = 2 * n
    rows = torch.arange(s.spins.shape[0], device=adj.device)
    action = action.to(torch.int64)
    gains = s.spins * torch.einsum('bij,bj->bi', adj, s.spins)
    score2 = s.score + gains[rows, action]
    spins2 = s.spins.clone()
    spins2[rows, action] = -spins2[rows, action]
    rew = torch.clamp(score2 - s.best_score, min=0.0) / n
    h2 = torch.bitwise_xor(s.zhash, pool.zkeys[action])
    new_state = ~torch.any(s.ring == h2[:, None], dim=-1)
    gains2 = spins2 * torch.einsum('bij,bj->bi', adj, spins2)
    local_opt = torch.all(gains2 <= 0, dim=-1)
    rew = rew + torch.where(local_opt & new_state, basin_reward, 0.0)
    ring2 = s.ring.clone()
    ring2[rows, (s.step + 1) % s.ring.shape[-1]] = h2
    better = score2 > s.best_score
    tsf2 = s.tsf + 1.0 / max_steps
    tsf2[rows, action] = 0.0
    step2 = s.step + 1
    s2 = EcoEnvState(spins=spins2, score=score2,
                     best_score=torch.where(better, score2, s.best_score),
                     best_spins=torch.where(better[:, None], spins2, s.best_spins),
                     tsf=tsf2, step=step2, gidx=s.gidx, zhash=h2, ring=ring2)
    return s2, rew, step2 >= max_steps


def _masked_reset(pool: EcoPool, s: EcoEnvState, done: torch.Tensor, d) -> EcoEnvState:
    """Finished envs restart from fresh spins (``'reset_spins'``) on the
    pool graph ``batch`` further on."""
    n = pool.adj.shape[-1]
    b = s.spins.shape[0]
    new_spins = torch.where(d.bernoulli('reset_spins', 0.5, (b, n)) > 0, 1.0, -1.0)
    gidx = torch.where(done, (s.gidx + b) % pool.adj.shape[0], s.gidx)
    score0 = _cut_value(pool.adj[gidx], new_spins)
    h0 = _zobrist(pool.zkeys, new_spins)
    ring0 = torch.zeros_like(s.ring)
    ring0[:, 0] = h0
    dn = done[:, None]
    return EcoEnvState(
        spins=torch.where(dn, new_spins, s.spins),
        score=torch.where(done, score0, s.score),
        best_score=torch.where(done, score0, s.best_score),
        best_spins=torch.where(dn, new_spins, s.best_spins),
        tsf=torch.where(dn, 0.0, s.tsf),
        step=torch.where(done, 0, s.step),
        gidx=gidx, zhash=torch.where(done, h0, s.zhash),
        ring=torch.where(dn, ring0, s.ring))


# ---------------------------------------------------------------------------
# MPNN (the reference's mpnn.py, bias placement included)
# ---------------------------------------------------------------------------

N_OBS = 7


class MPNNParams(NamedTuple):
    w_init: torch.Tensor       # (7, F) node init embed (no bias)
    w_edge: torch.Tensor       # (8, F-1) per-edge embed (no bias)
    w_edge_feat: torch.Tensor  # (F, F) post-aggregation (no bias)
    w_msg: tuple               # L x (2F, F) message layers (no bias)
    w_upd: tuple               # L x (2F, F) update layers (no bias)
    w_pool: torch.Tensor       # (F, F) readout pooling (no bias)
    w_out: torch.Tensor        # (2F, 1) readout head
    b_out: torch.Tensor        # (1,)


def init_mpnn(gen, features: int = 64, layers: int = 3, device=None) -> MPNNParams:
    """Glorot-uniform weights and a small normal head (std 0.01), from a
    CPU generator seeded by ``gen``, on ``device`` (None: the card)."""
    device = solver_device(device, 'init_mpnn')
    g, f = _learn.init_generator(gen), features
    gl = _learn.glorot
    return MPNNParams(
        w_init=gl(g, (N_OBS, f), device), w_edge=gl(g, (N_OBS + 1, f - 1), device),
        w_edge_feat=gl(g, (f, f), device),
        w_msg=tuple(gl(g, (2 * f, f), device) for _ in range(layers)),
        w_upd=tuple(gl(g, (2 * f, f), device) for _ in range(layers)),
        w_pool=gl(g, (f, f), device), w_out=_learn.normal(g, (2 * f, 1), device, 0.01),
        b_out=torch.zeros(1, device=device))


def _edge_embed(p: MPNNParams, nf, adj, norm, pm_one: bool):
    """``embedded_edges[i] = (1/norm_i) sum_j 1[w_ij != 0] relu(w_ij w0 +
    nf_j Wr)``.  For ``w_ij`` in {0, +-1} the relu takes two values per j,
    so the sum is ``A+ @ relu(a + w0) + A- @ relu(a - w0)`` with ``a = nf @
    Wr``; other weights sum over chunks of 128 source nodes."""
    w0 = p.w_edge[0]                                   # (F-1,)
    a = nf @ p.w_edge[1:]                              # (B, n, F-1)
    if pm_one:
        ap = (adj > 0).to(nf.dtype)
        am = (adj < 0).to(nf.dtype)
        summed = ap @ torch.relu(a + w0) + am @ torch.relu(a - w0)
    else:
        summed = torch.zeros(a.shape[:-2] + (adj.shape[-2], a.shape[-1]), dtype=a.dtype,
                             device=a.device)
        for i in range(0, adj.shape[-1], 128):
            w_cols = adj[..., i:i + 128][..., None]                    # (B, n, c, 1)
            e = torch.relu(w_cols * w0 + a[..., None, i:i + 128, :])
            summed = summed + torch.sum(e * (w_cols != 0), dim=-2)
    emb = summed / norm
    nmax = torch.max(norm, dim=-2, keepdim=True).values
    return torch.relu(torch.cat([emb, norm / nmax], dim=-1) @ p.w_edge_feat)


def mpnn_q(p: MPNNParams, obs, adj, pm_one: bool):
    """Per-node Q values: obs ``(B, n, 7)``, adj ``(B, n, n)`` -> ``(B, n)``."""
    norm = torch.clamp(torch.sum(adj != 0, dim=-1, keepdim=True), min=1).to(obs.dtype)
    emb = torch.relu(obs @ p.w_init)                    # (B, n, F)
    edge = _edge_embed(p, obs, adj, norm, pm_one)       # (B, n, F)
    for wm, wu in zip(p.w_msg, p.w_upd):
        agg = (adj @ emb) / norm
        msg = torch.relu(torch.cat([agg, edge], -1) @ wm)
        emb = torch.relu(torch.cat([emb, msg], -1) @ wu)
    pooled = torch.mean(emb, dim=-2, keepdim=True) @ p.w_pool
    feats = torch.relu(torch.cat([pooled.expand(emb.shape), emb], -1))
    return (feats @ p.w_out + p.b_out)[..., 0]


# ---------------------------------------------------------------------------
# Replay ring of compact states (observations recomputed at sample time)
# ---------------------------------------------------------------------------

class EcoReplay(NamedTuple):
    """One row per transition, ``[:, 0]`` the state and ``[:, 1]`` the next;
    ``ptr`` and ``size`` are host integers (the batch is fixed)."""
    spins: torch.Tensor        # (cap, 2, n) int8
    best_spins: torch.Tensor   # (cap, 2, n) int8
    tsf: torch.Tensor          # (cap, 2, n) f32
    score: torch.Tensor        # (cap, 2)
    best_score: torch.Tensor   # (cap, 2)
    step: torch.Tensor         # (cap, 2) int64
    gidx: torch.Tensor         # (cap,) int64
    action: torch.Tensor       # (cap,) int64
    reward: torch.Tensor       # (cap,)
    done: torch.Tensor         # (cap,)
    ptr: int
    size: int


def _replay_init(cap: int, n: int, device) -> EcoReplay:
    def z(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)
    return EcoReplay(spins=z((cap, 2, n), torch.int8), best_spins=z((cap, 2, n), torch.int8),
                     tsf=z((cap, 2, n)), score=z((cap, 2)), best_score=z((cap, 2)),
                     step=z((cap, 2), torch.int64), gidx=z(cap, torch.int64),
                     action=z(cap, torch.int64), reward=z(cap), done=z(cap), ptr=0, size=0)


def _replay_push(rb: EcoReplay, s: EcoEnvState, action, reward, done, s2: EcoEnvState
                 ) -> EcoReplay:
    b = action.shape[0]
    cap = rb.spins.shape[0]
    idx = (rb.ptr + torch.arange(b, device=action.device)) % cap
    i8 = torch.int8
    pair = lambda a, c: torch.stack([a, c], dim=1)  # noqa: E731
    rb.spins[idx] = pair(s.spins.to(i8), s2.spins.to(i8))
    rb.best_spins[idx] = pair(s.best_spins.to(i8), s2.best_spins.to(i8))
    rb.tsf[idx] = pair(s.tsf, s2.tsf)
    rb.score[idx] = pair(s.score, s2.score)
    rb.best_score[idx] = pair(s.best_score, s2.best_score)
    rb.step[idx] = pair(s.step, s2.step)
    rb.gidx[idx] = s.gidx
    rb.action[idx] = action.to(torch.int64)
    rb.reward[idx] = reward
    rb.done[idx] = done.to(torch.float32)
    return rb._replace(ptr=(rb.ptr + b) % cap, size=min(rb.size + b, cap))


def _rows_to_obs(pool: EcoPool, rb: EcoReplay, rows, side: int):
    s = EcoEnvState(spins=rb.spins[rows, side].to(torch.float32),
                    score=rb.score[rows, side], best_score=rb.best_score[rows, side],
                    best_spins=rb.best_spins[rows, side].to(torch.float32),
                    tsf=rb.tsf[rows, side], step=rb.step[rows, side], gidx=rb.gidx[rows],
                    zhash=None, ring=None)
    return eco_observe(pool, s)


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

class EcoTrainState(NamedTuple):
    """Under a mesh, ``env``, ``rb``, ``gen`` and ``shard_params`` hold one
    entry per shard (in shard order); without one, ``shard_params`` is
    ``(params,)``."""
    params: MPNNParams
    target: MPNNParams
    opt: tuple
    env: object
    rb: object
    tick: int                  # global update counter
    gen: object                # the draws' generator(s)
    shard_params: tuple = ()


def eco_lr_schedule(lr_final: float, lr_peak: float, lr_ramp: int, lr_decay: int):
    """optax's ``join_schedules([linear_schedule(lr_final, lr_peak,
    lr_ramp), linear_schedule(lr_peak, lr_final, lr_decay)], [lr_ramp])``
    as a function of Adam's count, in float32 as optax computes it."""
    f32 = np.float32

    def linear(init, end, steps, count):
        frac = f32(1) - f32(min(max(count, 0), steps)) / f32(steps)
        return f32(init - end) * frac + f32(end)

    def sched(count: int) -> float:
        if count < lr_ramp:
            return float(linear(lr_final, lr_peak, lr_ramp, count))
        return float(linear(lr_peak, lr_final, lr_decay, count - lr_ramp))
    return sched


def make_eco_dqn(pool: EcoPool, batch: int = 32, features: int = 64, layers: int = 3,
                 gamma: float = 0.95, replay_cap: int = 16384, minibatch: int = 64,
                 eps_final: float = 0.05, eps_decay_steps: int = 2000, target_freq: int = 50,
                 lr_peak: float = 1e-3, lr_final: float = 1e-4, lr_ramp: int = 300,
                 lr_decay: int = 6000, basin_reward: Optional[float] = None, mesh=None,
                 dp_axis: str = 'dp'):
    """Returns ``(init_fn, round_fn)`` on the pool's device (a mesh's shards
    on their own devices); test-time inference is :func:`eco_greedy_solve`.

    ``init_fn(gen, draws=None)``; ``round_fn(ts, steps, draws=None) -> (ts,
    last step's {'loss', 'best', 'eps'})`` runs ``steps`` train steps.
    Under a mesh ``draws`` is one mapping per shard."""
    n = pool.adj.shape[-1]
    if basin_reward is None:
        basin_reward = 1.0 / n
    if mesh is not None and mesh.distributed:
        raise NotImplementedError('make_eco_dqn: a mesh over several processes; shard over '
                                  "this process's devices (make_mesh(devices=...))")
    n_dp = 1 if mesh is None else int(mesh.shape[mesh.axis_names.index(dp_axis)])
    if batch % n_dp or minibatch % n_dp or replay_cap % n_dp:
        raise ValueError(
            f'batch={batch}, minibatch={minibatch}, replay_cap={replay_cap} '
            f'must all be divisible by mesh[{dp_axis!r}]={n_dp}')
    mb_local, b_local, cap_local = minibatch // n_dp, batch // n_dp, replay_cap // n_dp
    devices = [pool.adj.device] if mesh is None else list(mesh.devices)
    pools = [pool if _same_device(dev, pool.adj.device) else _pool_to(pool, dev)
             for dev in devices]
    lead = devices[0]
    sched = eco_lr_schedule(lr_final, lr_peak, lr_ramp, lr_decay)

    def init_fn(gen, draws=None) -> EcoTrainState:
        d = as_draws(gen, lead, draws)
        params = init_mpnn(d, features, layers, lead)
        env = eco_reset(pools[0], d, batch, ring_len=2 * n)
        if mesh is None:
            return EcoTrainState(params, params, _learn.adam_init(params), env,
                                 _replay_init(replay_cap, n, lead), 0, d, (params,))
        envs = tuple(EcoEnvState(*[x[r * b_local:(r + 1) * b_local].to(dev) for x in env])
                     for r, dev in enumerate(devices))
        gens = tuple(torch.Generator(device=dev).manual_seed(
            int(torch.randint(0, 2 ** 62, (1,), generator=d.gen, device=d.device)))
            if d.gen is not None else None for dev in devices)
        return EcoTrainState(params, params, _learn.adam_init(params), envs,
                             tuple(_replay_init(cap_local, n, dev) for dev in devices),
                             0, gens, tuple(_learn.to_device(params, dev) for dev in devices))

    def loss_fn(pool_r, params, target, rb, rows):
        adj = pool_r.adj[rb.gidx[rows]]
        obs = _rows_to_obs(pool_r, rb, rows, 0)
        obs2 = _rows_to_obs(pool_r, rb, rows, 1)
        r = torch.arange(rows.shape[0], device=rows.device)
        q_sel = mpnn_q(params, obs, adj, pool_r.pm_one)[r, rb.action[rows]]
        with torch.no_grad():     # double DQN: the online argmax, the target's value
            a2 = torch.argmax(mpnn_q(params, obs2, adj, pool_r.pm_one), dim=-1)
            q2 = mpnn_q(target, obs2, adj, pool_r.pm_one)[r, a2]
            y = rb.reward[rows] + gamma * (1.0 - rb.done[rows]) * q2
        return torch.mean(torch.square(q_sel - y))

    def shard_step(pool_r, params, target, env, rb, d, eps: float):
        """One shard's env step, push and minibatch gradient."""
        bsz = env.gidx.shape[0]
        with torch.no_grad():
            q = mpnn_q(params, eco_observe(pool_r, env), pool_r.adj[env.gidx], pool_r.pm_one)
            rand_a = d.randint('rand_action', n, (bsz,))
            use_rand = d.bernoulli('use_rand', eps, (bsz,)) > 0
            action = torch.where(use_rand, rand_a, torch.argmax(q, dim=-1))
            env2, rew, done = eco_step(pool_r, env, action, basin_reward)
            rb = _replay_push(rb, env, action, rew, done, env2)
            env3 = _masked_reset(pool_r, env2, done, d)
        rows = d.randint('rows', max(rb.size, 1), (mb_local,))
        loss, _, grads = _learn.value_and_grad(
            lambda p: loss_fn(pool_r, p, target, rb, rows), params)
        return env3, rb, loss, grads, torch.max(env2.best_score)

    def round_fn(ts: EcoTrainState, steps: int, draws=None):
        shards = len(devices)
        if mesh is None:
            ds = [as_draws(ts.gen if draws is None else None, lead, draws)]
            envs, rbs = [ts.env], [ts.rb]
        else:
            ds = [as_draws(ts.gen[r] if draws is None else None, dev,
                           None if draws is None else draws[r])
                  for r, dev in enumerate(devices)]
            envs, rbs = list(ts.env), list(ts.rb)
        params, target, opt_state, tick = ts.params, ts.target, ts.opt, ts.tick
        shard_params = list(ts.shard_params)
        shard_targets = [_learn.to_device(target, dev) for dev in devices]
        metrics = {}
        for _ in range(int(steps)):
            e = np.float32(1.0 - eps_final) * np.float32(tick) / np.float32(eps_decay_steps)
            eps = float(max(np.float32(eps_final), np.float32(1.0) - e))
            losses, grads, bests = [], [], []
            for r in range(shards):
                envs[r], rbs[r], loss, g, best = shard_step(
                    pools[r], shard_params[r], shard_targets[r], envs[r], rbs[r], ds[r], eps)
                losses.append(loss.to(lead)), grads.append(g.to(lead)), bests.append(best.to(lead))
            g = grads[0] if shards == 1 else torch.mean(torch.stack(grads), dim=0)
            loss = losses[0] if shards == 1 else torch.mean(torch.stack(losses))
            best = torch.max(torch.stack(bests))
            if rbs[0].size < 2 * mb_local:     # not warm: Adam steps on zeros
                g = torch.zeros_like(g)
            opt = _learn.adam(sched(opt_state.count), eps=1e-8)
            params, opt_state = _learn.apply(opt, params, opt_state, g)
            tick += 1
            if tick % target_freq == 0:
                target = params
                shard_targets = [_learn.to_device(target, dev) for dev in devices]
            shard_params = [_learn.to_device(params, dev) for dev in devices]
            metrics = {'loss': loss, 'best': best, 'eps': torch.tensor(eps)}
        if mesh is None:
            env, rb, gen = envs[0], rbs[0], ts.gen
        else:
            env, rb, gen = tuple(envs), tuple(rbs), ts.gen
        return EcoTrainState(params, target, opt_state, env, rb, tick, gen,
                             tuple(shard_params)), metrics

    return init_fn, round_fn


def _pool_to(pool: EcoPool, device) -> EcoPool:
    return EcoPool(pool.adj.to(device), pool.max_local.to(device), pool.zkeys.to(device),
                   pool.pm_one)


def eco_greedy_solve(params: MPNNParams, adj: np.ndarray, num_restarts: int = 32,
                     steps: Optional[int] = None, gen=None, pm_one: bool = True,
                     eps: float = 0.0, draws=None) -> Tuple[float, np.ndarray]:
    """Test-time inference on the params' device: from ``num_restarts``
    random spin inits (``'spins'``), follow the argmax of Q for ``steps``
    (default 2n) flips without resetting, and return the best cut seen and
    its spins.  ``eps > 0`` is the exploratory mode: each restart takes the
    random flip ``'rand_action'`` where the uniform ``'explore'`` is below
    ``eps``.  ``gen=None`` seeds a generator with 0.  Whether the
    two-product MPNN path runs follows the graph's weights (``pm_one`` is
    kept for the JAX package's signature, which ignores it too)."""
    device = params.w_init.device
    d = as_draws(0 if gen is None else gen, device, draws)
    adjs = np.asarray(adj, np.float32)[None]
    pool = build_pool(adjs, device=device)
    n = adjs.shape[-1]
    if steps is None:
        steps = 2 * n
    env = eco_reset(pool, d, num_restarts, ring_len=2 * n,
                    gidx=torch.zeros(num_restarts, dtype=torch.int64, device=device))
    with torch.no_grad():
        for _ in range(int(steps)):
            q = mpnn_q(params, eco_observe(pool, env), pool.adj[env.gidx], pool.pm_one)
            action = torch.argmax(q, dim=-1)
            if eps > 0.0:
                rand_a = d.randint('rand_action', n, action.shape)
                explore = d.rand('explore', action.shape) < eps
                action = torch.where(explore, rand_a, action)
            # no reset at inference: the step keeps counting past max_steps
            # (the observation caps its features at the trained range)
            env, _, _ = eco_step(pool, env, action, 0.0)
    best = env.best_score.cpu().numpy()
    i = int(best.argmax())
    return float(best[i]), env.best_spins[i].cpu().numpy()
