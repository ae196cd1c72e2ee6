"""The plain versions of K10, K11a (one field, and every replay field of a
chunk in one call) and K11b (``elegantrl_tpu_torch/ops/kernels.py``)
against the JAX package's Pallas kernels (``elegantrl_tpu/ops/pallas_kernels.py``,
in interpret mode under ``jax.jit``, as ``tests/test_pallas_kernels.py`` runs
them) and against the port's ``*_reference`` twins; then the three switches
of ``config.py:select_kernel``, on the CPU and under ``device='cuda'``
(decided before anything launches, so a CPU box can read them).

Tolerances: K10 1e-5 relative against the JAX kernel at N=128 and against
JAX ``gae.gae_vtrace`` at N=64 (at H >= 16 the JAX form reassociates its
sums in an associative scan); the port's kernel path and its loop are
bitwise equal.  K11a exact.  K11b 1e-5 relative (atol 1e-5 x max|out|): the
two libraries sum 8 to 256 products in other orders.
"""
import io
from contextlib import redirect_stdout
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu.ops import gae as jgae
from elegantrl_tpu.ops import pallas_kernels as jpk
from elegantrl_tpu_torch import Config, build_training
from elegantrl_tpu_torch.agents import AgentD3QN, AgentDQN, AgentPPO, AgentSAC
from elegantrl_tpu_torch.envs import LunarLanderContinuousEnv, LunarLanderEnv
from elegantrl_tpu_torch.ops import gae, kernels
from elegantrl_tpu_torch.ops.nets import mlp3_forward, mlp_apply_leaves
from elegantrl_tpu_torch.train.replay_buffer import ReplayBuffer

torch.set_num_threads(1)


def _gae_inputs(H, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((H, N)).astype(np.float32),
            (rng.random((H, N)) > 0.1).astype(np.float32),
            rng.standard_normal((H, N)).astype(np.float32),
            rng.standard_normal(N).astype(np.float32))


@pytest.mark.parametrize('H,N', [(32, 128), (5, 256)])
def test_k10_plain_matches_pallas_kernel(H, N):
    r, u, v, nv = _gae_inputs(H, N, H)
    fn = jax.jit(partial(jpk.gae_vtrace_pallas, gamma=0.99, lam=0.95, interpret=True))
    want = np.asarray(fn(*map(jnp.asarray, (r, u, v, nv))))
    got = kernels.gae_vtrace_reference(*map(torch.from_numpy, (r, u, v, nv)), 0.99, 0.95)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('H', [8, 32])
def test_k10_plain_matches_jax_gae_at_64_envs(H):
    r, u, v, nv = _gae_inputs(H, 64, 100 + H)
    want = np.asarray(jax.jit(partial(jgae.gae_vtrace, gamma=0.97, lam=0.9))(
        *map(jnp.asarray, (r, u, v, nv))))
    t = [torch.from_numpy(x) for x in (r, u, v, nv)]
    got = gae.gae_vtrace(*t, 0.97, 0.9)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the kernel's path (no step truncated: unmasks all 1) and the loop are
    # one function, bit for bit
    adv, sums = kernels.gae_vtrace_kernel(t[0], t[1], torch.ones_like(t[0]), *t[2:], 0.97, 0.9)
    assert torch.equal(adv, got) and torch.equal(sums, got + t[2])


@pytest.mark.parametrize('dtype', [np.float32, np.int32])
@pytest.mark.parametrize('dim', [1, 8])
def test_k11a_plain_matches_pallas_kernel(dtype, dim):
    rng = np.random.default_rng(dim)
    T, N, B = 40, 8, 37
    buf = (rng.standard_normal((T, N, dim)) * 100).astype(dtype)
    ids0 = rng.integers(0, T - 1, B).astype(np.int32)
    ids1 = rng.integers(0, N, B).astype(np.int32)
    want = np.asarray(jax.jit(partial(jpk.buffer_gather, interpret=True))(
        jnp.asarray(buf), jnp.asarray(ids0), jnp.asarray(ids1)))
    tbuf = torch.from_numpy(buf if dim > 1 else buf[..., 0].copy())   # (T, N) columns
    i0, i1 = torch.from_numpy(ids0), torch.from_numpy(ids1)
    got = kernels.buffer_gather(tbuf, i0, i1)
    np.testing.assert_array_equal(got.numpy(), want if dim > 1 else want[:, 0])
    assert torch.equal(got, kernels.buffer_gather_reference(tbuf, i0.long(), i1.long()))
    nxt = kernels.buffer_gather(tbuf, i0.long(), i1.long(), 1)
    assert torch.equal(nxt, tbuf[i0.long() + 1, i1.long()])


@pytest.mark.parametrize('idx_dtype', [np.int32, np.int64])
def test_k11a_fields_plain_matches_pallas_kernel(idx_dtype):
    """Every replay field of a (C, B) chunk in one call: f32 states in the
    (C, S, B) layout (and the offset-1 next states), f32 actions (C, A, B),
    int32 actions and dim-1 columns (C, B), against the JAX kernel field by
    field (its ids flat, int32, the offset added)."""
    rng = np.random.default_rng(11)
    T, N, S, A, C, B = 30, 4, 6, 3, 2, 12
    states = rng.standard_normal((T, N, S)).astype(np.float32)
    act_f = rng.standard_normal((T, N, A)).astype(np.float32)
    act_i = rng.integers(0, A, (T, N)).astype(np.int32)
    rew = rng.standard_normal((T, N)).astype(np.float32)
    ids0 = rng.integers(0, T - 1, (C, B)).astype(idx_dtype)
    ids1 = rng.integers(0, N, (C, B)).astype(idx_dtype)
    jg = jax.jit(partial(jpk.buffer_gather, interpret=True))
    fields = [(states, 0, True), (states, 1, True), (act_f, 0, True), (act_i, 0, False),
              (rew, 0, False), (states, 0, False)]
    got = kernels.buffer_gather_fields(
        [(torch.from_numpy(b), off, fm) for b, off, fm in fields],
        torch.from_numpy(ids0), torch.from_numpy(ids1))
    for (buf, off, fm), g in zip(fields, got):
        b3 = buf if buf.ndim == 3 else buf[..., None]
        want = np.asarray(jg(jnp.asarray(b3), jnp.asarray((ids0 + off).reshape(-1), jnp.int32),
                             jnp.asarray(ids1.reshape(-1), jnp.int32))).reshape(C, B, -1)
        want = want.transpose(0, 2, 1) if fm else (want[..., 0] if buf.ndim == 2 else want)
        assert g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), want)


@pytest.mark.parametrize('discrete', [False, True])
def test_replay_gathers_unchanged_on_cpu(discrete):
    """ReplayBuffer.sample / sample_rows give, on the CPU, the tensors of the
    per-field gathers they replace; feature_major gives their (..., dim, B)
    transposes, contiguous."""
    M, N, S, A = 24, 4, 5, 3
    rb = ReplayBuffer(M, S, A, num_seqs=N, if_discrete=discrete, device='cpu')
    g = torch.Generator().manual_seed(3)
    acts = (torch.randint(0, A, (M, N), generator=g, dtype=torch.int32) if discrete
            else torch.randn((M, N, A), generator=g))
    buf = rb.update(rb.init(), (torch.randn((M, N, S), generator=g), acts,
                                torch.randn((M, N), generator=g), torch.rand((M, N), generator=g),
                                torch.rand((M, N), generator=g)))
    n = rb.sample_len(buf)
    ids = torch.randint(0, n * N, (3, 8), generator=g)
    rows = torch.randint(0, n, (3, 2), generator=g)
    r_ids0 = rows[..., :, None].expand(3, 2, N).reshape(3, -1)
    r_ids1 = torch.arange(N).expand(3, 2, N).reshape(3, -1)
    for got_rows, got_cols, (i0, i1) in (
            (rb.sample(buf, 8, ids=ids), rb.sample(buf, 8, ids=ids, feature_major=True),
             (ids % n, ids // n)),
            (rb.sample_rows(buf, 8, rows=rows), rb.sample_rows(buf, 8, rows=rows,
                                                               feature_major=True),
             (r_ids0, r_ids1))):
        ref = kernels.buffer_gather_reference
        old = [ref(buf.states, i0, i1), ref(buf.actions, i0, i1), ref(buf.rewards, i0, i1),
               ref(buf.undones, i0, i1), ref(buf.unmasks, i0, i1), ref(buf.states, i0, i1, 1)]
        for k, (a, b) in enumerate(zip(got_rows[:6], old)):
            assert torch.equal(a, b), k
        for k, (a, b) in enumerate(zip(got_cols[:6], old)):
            want = b.transpose(1, 2) if (k in (0, 5) or (k == 1 and not discrete)) else b
            assert torch.equal(a, want) and a.is_contiguous(), k
        assert torch.equal(got_cols[6][0], i0) and torch.equal(got_cols[6][1], i1)


def _mlp(dims, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    leaves = []
    for i, o in zip(dims[:-1], dims[1:]):
        leaves += [(rng.standard_normal((o, i)) * scale / np.sqrt(i) * 3).astype(np.float32),
                   (rng.standard_normal(o) * 0.1).astype(np.float32)]
    return leaves


@pytest.mark.parametrize('dims,B', [((8, 16, 16, 2), 48), ((8, 32, 32, 4), 600),
                                    ((8, 256, 256, 4), 64)])
def test_k11b_plain_matches_pallas_kernel(dims, B):
    leaves = _mlp(dims, B)
    x = np.random.default_rng(B + 1).standard_normal((B, dims[0])).astype(np.float32)
    jleaves = [jnp.asarray(w.T if w.ndim == 2 else w) for w in leaves]    # (in, out)
    want = np.asarray(jax.jit(partial(jpk.fused_mlp3, interpret=True))(
        jnp.asarray(x), *jleaves))
    tl = [torch.from_numpy(w) for w in leaves]
    got = kernels.fused_mlp3(torch.from_numpy(x), *tl).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert np.array_equal(got, kernels.fused_mlp3_reference(torch.from_numpy(x), *tl).numpy())
    # the nets' no-grad forward, with and without the kernel, keeps leading axes
    x3 = torch.from_numpy(x).reshape(B // 8, 8, dims[0])
    assert torch.equal(mlp3_forward(tl, x3, True), mlp_apply_leaves(tl, x3))


def test_wrappers_raise_off_cpu_and_cuda():
    meta = torch.empty((4, 3), device='meta')
    ids = torch.zeros(2, dtype=torch.int64, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        kernels.gae_vtrace_kernel(meta, meta, meta, meta, meta[0], 0.99, 0.95)
    with pytest.raises(ValueError, match='unsupported device'):
        kernels.buffer_gather(meta[None], ids, ids)
    with pytest.raises(ValueError, match='unsupported device'):
        kernels.buffer_gather_fields([(meta[None], 0, True), (meta[None], 1, False)], ids, ids)
    with pytest.raises(ValueError, match='unsupported device'):
        kernels.fused_mlp3(meta, meta, meta[0], meta, meta[0], meta, meta[0])


@pytest.mark.parametrize('dims,B', [((8, 128, 128, 2), 65), ((8, 128, 128, 1), 1),
                                    ((151, 128, 128, 15), 40)])
def test_k11b_ragged_plain_matches_pallas_kernel(dims, B):
    """Ragged B at the main paths' widths (the LunarLander actor and critic,
    the stock actor), which the kernel takes as a part-filled row group."""
    leaves = _mlp(dims, 7 * B + dims[-1])
    x = np.random.default_rng(B + 5).standard_normal((B, dims[0])).astype(np.float32)
    jleaves = [jnp.asarray(w.T if w.ndim == 2 else w) for w in leaves]    # (in, out)
    want = np.asarray(jax.jit(partial(jpk.fused_mlp3, interpret=True))(
        jnp.asarray(x), *jleaves))
    tl = [torch.from_numpy(w) for w in leaves]
    got = kernels.fused_mlp3(torch.from_numpy(x), *tl).numpy()
    assert got.shape == (B, dims[-1])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_k11b_fit():
    assert kernels.mlp3_fits((8, 256, 256, 4)) and kernels.mlp3_fits((151, 128, 128, 15))
    # 16 rows a cluster of 8: slices of 32 hidden units, their rows of 8,
    # 256 and 32 inputs at 12, 260 and 36 floats (16-byte rows, an odd
    # count of 16-byte chunks); x (8 x 16) under the second layer's (32 x
    # 16); the first hidden layer (256 x 16); the output part (4 x 16); the
    # split-K scratch
    assert kernels.mlp3_smem_bytes(8, 256, 256, 4, 16, 8) == 4 * (
        32 * 12 + 32 + 32 * 260 + 32 + 4 * 36 + 4 + 32 * 16 + 256 * 16 + 4 * 16 + 256 * 16)
    assert [kernels.ldk(k) for k in (8, 15, 16, 128, 151)] == [12, 20, 20, 132, 156]
    assert not kernels.mlp3_fits((8, 2048, 2048, 4))       # 527 KB of shared memory
    assert not kernels.mlp3_fits((8, 64, 64, 64, 4))       # 4 linear layers


def _said(fn):
    out = io.StringIO()
    with redirect_stdout(out):
        value = fn()
    return value, out.getvalue()


def _args(agent_class, device, **kw):
    discrete = agent_class is not AgentPPO and agent_class is not AgentSAC
    env_class = LunarLanderEnv if discrete else LunarLanderContinuousEnv
    a = Config(agent_class, env_class,
               {'env_name': 'LunarLander-v2' if discrete else 'LunarLanderContinuous-v2',
                'num_envs': 4, 'max_step': 1000, 'state_dim': 8,
                'action_dim': 4 if discrete else 2, 'if_discrete': discrete})
    a.net_dims, a.horizon_len, a.batch_size, a.device = (16, 16), 8, 128, device
    a.buffer_size = 16
    for k, v in kw.items():
        setattr(a, k, v)
    return a


def _choices(args, monkeypatch):
    chosen = {}
    real = kernels.select_kernel

    def spy(a, flag, *rest, **kw):
        out = real(a, flag, *rest, **kw)
        chosen.setdefault(flag, []).append(out)
        return out

    monkeypatch.setattr(kernels, 'select_kernel', spy)
    make = args.agent_class.make
    buf = None
    if args.if_off_policy:
        buf = ReplayBuffer(16, 8, args.action_dim, num_seqs=4, if_discrete=args.if_discrete,
                           args=args, device=args.device)
    _, said = _said(lambda: make(args.net_dims, 8, args.action_dim, args, buffer=buf))
    return chosen, said


@pytest.mark.parametrize('device', ['cpu', 'cuda'])
def test_three_switches_auto(device, monkeypatch):
    """'auto' takes every kernel that fits, on the CPU (its plain version)
    and on a card; a net that is not a 3-linear MLP, or plain GAE, runs
    PyTorch ops and says so."""
    chosen, said = _choices(_args(AgentPPO, device), monkeypatch)
    assert chosen == {'use_gae_kernel': [True], 'use_mlp3_kernel': [True]}
    assert (f'use_mlp3_kernel: {"kernel" if device == "cuda" else "plain version"} '
            f'on {device}') in said
    chosen, said = _choices(_args(AgentDQN, device), monkeypatch)
    assert chosen == {'use_gather_kernel': [True], 'use_mlp3_kernel': [True]}
    chosen, said = _choices(_args(AgentD3QN, device), monkeypatch)
    assert chosen == {'use_gather_kernel': [True], 'use_mlp3_kernel': [False]}
    assert 'use_mlp3_kernel: PyTorch path' in said and 'twin=True, duel=True' in said
    chosen, said = _choices(_args(AgentSAC, device, batch_size=64), monkeypatch)
    assert chosen['use_mlp3_kernel'] == [False] and 'SAC actor' in said
    chosen, said = _choices(_args(AgentPPO, device, net_dims=(16, 16, 16),
                                  if_use_vtrace=False), monkeypatch)
    assert chosen == {'use_gae_kernel': [False], 'use_mlp3_kernel': [False]}


@pytest.mark.parametrize('flag', ['use_gae_kernel', 'use_gather_kernel', 'use_mlp3_kernel'])
def test_false_is_refused_on_a_card_and_true_needs_a_fit(flag, monkeypatch):
    agent_class = AgentDQN if flag == 'use_gather_kernel' else AgentPPO
    chosen, _ = _choices(_args(agent_class, 'cpu', **{flag: False}), monkeypatch)
    assert chosen[flag] == [False]                  # the CPU may ask for the plain path
    with pytest.raises(ValueError, match=f'{flag}=False asks for the plain PyTorch path'):
        _choices(_args(agent_class, 'cuda', **{flag: False}), monkeypatch)
    if flag != 'use_gather_kernel':                 # every replay field fits K11a
        misfit = ({'if_use_vtrace': False} if flag == 'use_gae_kernel'
                  else {'net_dims': (16, 16, 16)})
        for device in ('cpu', 'cuda'):
            with pytest.raises(ValueError, match=f'{flag}=True requires'):
                _choices(_args(agent_class, device, **{flag: True}, **misfit), monkeypatch)


def test_choices_reach_the_round_on_cpu():
    """A LunarLander PPO round with every switch False on the CPU equals
    the round with every switch 'auto' (the plain versions), bit for bit."""
    outs = []
    for mode in ('auto', False):
        a = _args(AgentPPO, 'cpu', use_gae_kernel=mode, use_mlp3_kernel=mode, random_seed=0)
        ctx = build_training(a)
        c, m = ctx.round_fn(ctx.carry)
        outs.append((c.agent_state.act_flat.clone(), float(m['obj_critic'])))
    assert torch.equal(outs[0][0], outs[1][0]) and outs[0][1] == outs[1][1]


@pytest.mark.parametrize('H,N', [(64, 96), (37, 1000), (256, 64), (33, 5)])
def test_k10_folded_plain_is_the_composition_bitwise(H, N):
    """K10's plain version with the truncation bootstrap and the reward sums
    folded in (what the redesigned kernel computes in one pass) is, bit for
    bit, the bootstrap, the plain recursion and the sum, one after another;
    at shapes whose time rows span several 32-row stages and whose columns
    a block's 32 do not divide."""
    rng = np.random.default_rng(H + N)
    r, u, v, nv = (torch.from_numpy(x) for x in _gae_inputs(H, N, H + N))
    um = torch.from_numpy((rng.random((H, N)) > 0.05).astype(np.float32))
    adv, sums = kernels.gae_vtrace_kernel(r, u, um, v, nv, 0.98, 0.9)
    rb, ub = gae.apply_truncation_bootstrap(r, u, um, v)
    want = kernels.gae_vtrace_reference(rb, ub, v, nv, 0.98, 0.9)
    assert torch.equal(adv, want) and torch.equal(sums, want + v)
