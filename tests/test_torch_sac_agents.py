"""The port's SAC and ModSAC (``elegantrl_tpu_torch/agents/sac.py``) against
the JAX package's on the same states, buffers and draws.

- Each agent's update, the scan path and the chunked path (the CPU runs the
  chunk's plain version), against the JAX agent's scan update: 20 updates
  (40 rows x 8 envs, batch 128, repeat 64), so the chunked path crosses a
  chunk boundary; the minibatch rows and both noise blocks are the JAX
  agent's own, drawn from ``fold_in(key, i)`` split in three (sample,
  next-action noise, policy-gradient noise) and passed in.  This holds the
  temperature's step, ModSAC's gate, ``update_a`` and the three Adam counts.
- One whole round on the CPU for SAC on HopperSlip (iid sampling) against
  the JAX round (rollout kernel in interpret mode, scan update), from the
  same carry and the same draws.
- ``train_agent`` for two periods, the kernel-selection rule, and the
  checkpoint round trip of ``SACState`` in the JAX leaf order.

Tolerances, as the JAX package's own update tests: parameter and target
updates (new - old), Adam moments and ``alpha_log`` to rtol 5e-3 (atol
4e-7), metrics to rtol 1e-4 (atol 1e-6); rollouts and buffers 1e-5.
"""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu.agents.sac import make_sac as jmake_sac
from elegantrl_tpu.config import Config as JConfig
from elegantrl_tpu.envs import HopperEnv as JHopperEnv
from elegantrl_tpu.ops.pallas_update import _adam_parts
from elegantrl_tpu.train.replay_buffer import ReplayBuffer as JReplayBuffer
from elegantrl_tpu.train.runner import build_training as jbuild_training
from elegantrl_tpu_torch import Config, build_training, train_agent
from elegantrl_tpu_torch.agents import AgentModSAC, AgentSAC
from elegantrl_tpu_torch.agents.sac import make_sac
from elegantrl_tpu_torch.envs import HopperEnv, HopperState, PendulumEnv
from elegantrl_tpu_torch.train.replay_buffer import ReplayBuffer
from elegantrl_tpu_torch.utils.checkpoint import load_tree, save_tree, tree_leaves
from elegantrl_tpu_torch.utils.jax_params import (buffer_state_from_numpy,
                                                  buffer_state_to_numpy, env_state_from_numpy)

torch.set_num_threads(1)
NET_DIMS = (16, 16)
NS, HB, BATCH, REPEAT = 8, 40, 128, 64.0     # 40 * 64 / 128 = 20 updates
S, A = 3, 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _args(cls, **kw):
    args = cls()
    args.batch_size, args.repeat_times, args.learning_rate = BATCH, REPEAT, 1e-3
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _draws(key, count, batch, rows_high, num_seqs, rows):
    """The JAX agent's draws of ``count`` updates: ``fold_in(key, i)`` split
    into (sample, next-action noise, policy-gradient noise)."""
    ids, noise = [], []
    for i in range(count):
        k_sample, k_next, k_pg = jax.random.split(jax.random.fold_in(key, i), 3)
        ids.append(jax.random.randint(k_sample, (batch // num_seqs,), 0, rows_high) if rows
                   else jax.random.randint(k_sample, (batch,), 0, rows_high * num_seqs))
        noise.append(jnp.stack([jax.random.normal(k, (batch, A)) for k in (k_next, k_pg)]))
    return (torch.tensor(np.asarray(jnp.stack(ids))).long(),
            torch.tensor(np.asarray(jnp.stack(noise))))


@pytest.fixture(scope='module', params=['sac', 'modsac'])
def updates(request):
    modsac = request.param == 'modsac'
    jargs = _args(JConfig, use_pallas_update=False)
    jrb = JReplayBuffer(256, S, A, num_seqs=NS, args=jargs)
    jagent = jmake_sac(NET_DIMS, S, A, jargs, jrb, modsac=modsac)
    js = jagent.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    items = (rng.standard_normal((HB, NS, S)).astype(np.float32),
             rng.uniform(-1, 1, (HB, NS, A)).astype(np.float32),
             rng.standard_normal((HB, NS)).astype(np.float32),
             (rng.random((HB, NS)) > 0.1).astype(np.float32), np.ones((HB, NS), np.float32))
    jbuf = jrb.update(jrb.init(), tuple(jnp.asarray(x) for x in items))
    k_upd = jax.random.PRNGKey(11)
    js2, _, jm = jax.jit(jagent.update)(js, jbuf, k_upd)
    rows, noise = _draws(k_upd, 20, BATCH, HB - 1, NS, rows=True)
    out = {}
    for path in ('scan', 'chunk'):
        args = _args(Config, device='cpu', use_fused_update=path == 'chunk')
        rb = ReplayBuffer(256, S, A, num_seqs=NS, device='cpu')
        agent = make_sac(NET_DIMS, S, A, args, rb, modsac=modsac)
        s = agent.state_from_numpy(_np(js), 'cpu')
        buf = buffer_state_from_numpy(_np(jbuf), 'cpu')
        s2, _, m = agent.update(s, buf, None, ids=rows, noise=noise)
        out[path] = (agent.state_to_numpy(s2), {k: float(v) for k, v in m.items()})
    return modsac, _np(js), _np(js2), {k: float(v) for k, v in jm.items()}, out


def _params(tree):
    return tuple(p for p in (tree.act, tree.act_target, tree.cri, tree.cri_target)
                 if p is not None)


@pytest.mark.parametrize('path', ['scan', 'chunk'])
def test_update_params_like_jax(updates, path):
    _, js, js2, _, out = updates
    got = out[path][0]
    old, want = jax.tree.leaves(_params(js)), jax.tree.leaves(_params(js2))
    leaves = tree_leaves(_params(got))
    assert len(leaves) == len(old)
    for o, a, b in zip(old, want, leaves):
        np.testing.assert_allclose(b - o, a - o, rtol=5e-3, atol=4e-7)


@pytest.mark.parametrize('path', ['scan', 'chunk'])
def test_update_optimizers_like_jax(updates, path):
    modsac, _, js2, _, out = updates
    got = out[path][0]
    for jopt, opt in ((js2.act_opt, got.act_opt), (js2.cri_opt, got.cri_opt),
                      (js2.alpha_opt, got.alpha_opt)):
        count, mu, nu = _adam_parts(jopt)
        adam = opt[1][0]
        assert int(adam.count) == int(count)
        for a, b in zip(jax.tree.leaves((mu, nu)), tree_leaves((adam.mu, adam.nu))):
            np.testing.assert_allclose(b, a, rtol=5e-3, atol=4e-7)
    # 20 updates: SAC's actor takes all of them, ModSAC's gate about 61%
    counts = [int(_adam_parts(o)[0]) for o in (js2.act_opt, js2.cri_opt, js2.alpha_opt)]
    assert counts[1:] == [20, 20] and (counts[0] < 20 if modsac else counts[0] == 20)


@pytest.mark.parametrize('path', ['scan', 'chunk'])
def test_update_temperature_and_gate_like_jax(updates, path):
    _, _, js2, _, out = updates
    got = out[path][0]
    np.testing.assert_allclose(got.alpha_log, js2.alpha_log, rtol=5e-3, atol=4e-7)
    assert got.update_a.dtype == np.int32 and int(got.update_a) == int(js2.update_a)


@pytest.mark.parametrize('path', ['scan', 'chunk'])
def test_update_metrics_like_jax(updates, path):
    _, _, _, jm, out = updates
    for k in ('obj_critic', 'obj_actor'):
        np.testing.assert_allclose(out[path][1][k], jm[k], rtol=1e-4, atol=1e-6)


# ------------------------------------------------------------ whole round

H, N = 8, 16
HOPPER = {'env_name': 'HopperSlip-v0', 'num_envs': N, 'max_step': 1000, 'state_dim': 6,
          'action_dim': 2, 'if_discrete': False}


def _round_args(cls, agent_class, env_class, env_args=HOPPER):
    args = cls(agent_class, env_class, dict(env_args))
    args.net_dims, args.horizon_len, args.batch_size = NET_DIMS, H, BATCH
    args.repeat_times, args.buffer_size, args.random_seed = 48.0, 64, 0   # 3 updates
    args.reward_scale, args.replay_row_sample = 0.5, False
    return args


@pytest.fixture(scope='module')
def sac_round():
    import elegantrl_tpu.agents as jagents
    jargs = _round_args(JConfig, jagents.AgentSAC, JHopperEnv)
    jargs.use_pallas_rollout, jargs.use_pallas_update = 'interpret', False
    jctx = jbuild_training(jargs)
    jc = jctx.carry
    _, k_roll, k_upd = jax.random.split(jc.key, 3)
    from elegantrl_tpu.ops.pallas_rollout import HOPPER_BODY
    kz, ku = jax.random.split(k_roll)
    noise = jnp.concatenate([jax.random.normal(kz, (H, 2, N), jnp.float32),
                             jax.random.uniform(ku, (H, HOPPER_BODY.n_step + HOPPER_BODY.n_reset,
                                                     N), jnp.float32)], axis=1)
    jc2, jm = jax.jit(jctx.round_fn)(jc, None)
    ids, unoise = _draws(k_upd, 3, BATCH, H - 1, N, rows=False)
    args = _round_args(Config, AgentSAC, HopperEnv)
    args.device = 'cpu'
    ctx = build_training(args)
    assert ctx.fused_rollout
    carry = ctx.carry._replace(
        agent_state=ctx.agent.state_from_numpy(_np(jc.agent_state), 'cpu'),
        env_state=env_state_from_numpy(HopperState, _np(jc.env_state), 'cpu'))
    carry2, m = ctx.round_fn(carry, noise=torch.tensor(np.asarray(noise)), ids=ids,
                             update_noise=unoise)
    jm = {k: float(v) for k, v in jm.items() if k != 'action_hist'}
    return (_np(jc.agent_state), _np(jc2._replace(key=None)), jm,
            ctx.agent.state_to_numpy(carry2.agent_state), carry2, m)


def test_round_buffer_like_jax(sac_round):
    _, jc2, _, _, carry2, _ = sac_round
    got = buffer_state_to_numpy(carry2.buf_state)
    for name in ('states', 'actions', 'rewards', 'undones', 'unmasks'):
        np.testing.assert_allclose(getattr(got, name), getattr(jc2.buf_state, name), rtol=0,
                                   atol=1e-5, err_msg=name)
    assert int(got.size) == int(jc2.buf_state.size) == H


def test_round_update_like_jax(sac_round):
    js, jc2, jm, got, _, m = sac_round
    want = jc2.agent_state
    for old, a, b in zip(jax.tree.leaves(_params(js)), jax.tree.leaves(_params(want)),
                         tree_leaves(_params(got))):
        np.testing.assert_allclose(b - old, a - old, rtol=5e-3, atol=1e-6)
    np.testing.assert_allclose(got.alpha_log, want.alpha_log, rtol=5e-3, atol=4e-7)
    for k in ('obj_critic', 'obj_actor', 'exp_r'):
        np.testing.assert_allclose(float(m[k]), jm[k], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize('agent_class', [AgentSAC, AgentModSAC])
def test_train_agent_two_periods(agent_class):
    """SAC on HopperSlip (the chunk's plain version), ModSAC on Pendulum at
    batch 64 (the scan path); the second resumes agent, buffer and env."""
    modsac = agent_class is AgentModSAC
    env_class, env_args = (HopperEnv, HOPPER) if not modsac else (PendulumEnv, dict(
        env_name='Pendulum-v1', num_envs=N, max_step=200, state_dim=3, action_dim=1,
        if_discrete=False))
    with tempfile.TemporaryDirectory() as cwd:
        args = _round_args(Config, agent_class, env_class, env_args)
        args.device, args.cwd, args.eval_times = 'cpu', cwd, 2
        args.batch_size = 64 if modsac else BATCH
        args.if_save_buffer = True     # an off-policy run writes its carry when resumable
        args.eval_per_step = args.break_step = H * N
        res = train_agent(args)
        assert res['recorder'].shape[0] == 2 and np.isfinite(res['recorder'][:, 1:]).all()
        assert os.path.isfile(os.path.join(cwd, 'agent.npz'))
        args.continue_train = True
        ctx = build_training(args)
        assert ctx.carry.buf_state.size == 2 * H
        assert ctx.carry.agent_state.act_opt.count == res['agent_state'].act_opt.count > 0


# --------------------------------------------------------- kernel selection

@pytest.mark.parametrize('modsac', [False, True], ids=['sac', 'modsac'])
def test_selection_rule(modsac, capsys):
    """Batch 64, or (256, 256) at batch 1024, is outside the JAX package's
    chunk: the PyTorch update on either device, said so.  Batch 1024 at
    (128, 128) on a card takes the kernel, or raises with the kernel
    refused; a kernel asked for outside the JAX scope raises too."""
    rb = ReplayBuffer(64, 6, 2, num_seqs=N, device='cpu')
    make = lambda **kw: make_sac(kw.pop('net_dims', (128, 128)), 6, 2,  # noqa: E731
                                 _args(Config, **{'batch_size': 1024, **kw}), rb, modsac=modsac)
    for device in ('cpu', 'cuda'):
        make(device=device, batch_size=64)
        assert 'use_fused_update: PyTorch path' in capsys.readouterr().out
        make(device=device, net_dims=(256, 256))
        assert 'use_fused_update: PyTorch path' in capsys.readouterr().out
    make(device='cuda')                                                  # takes the kernel
    out = capsys.readouterr().out
    # the update takes its kernel; the actor's no-grad forward (an encoder
    # and heads) is no 3-linear MLP for K11b, which is said
    assert 'use_fused_update: PyTorch path' not in out
    assert 'use_mlp3_kernel: PyTorch path' in out
    with pytest.raises(ValueError, match='use_fused_update=False .* CPU only'):
        make(device='cuda', use_fused_update=False)
    with pytest.raises(ValueError, match='use_fused_update=True requires'):
        make(device='cpu', batch_size=64, use_fused_update=True)


def test_unported_variants_raise():
    """PER, ``lambda_fit_cum_r`` and the H-term, once unported, keep SAC off
    its chunk as in the JAX package: they build on the scan path, and asking
    for the kernel raises."""
    rb = ReplayBuffer(256, S, A, num_seqs=NS, device='cpu')
    for kw, hterm in ((dict(if_use_per=True), False), (dict(lambda_fit_cum_r=0.5), False),
                      ({}, True)):
        agent = make_sac(NET_DIMS, S, A, _args(Config, device='cpu', **kw), rb, hterm=hterm)
        assert agent.update.__name__ == 'scan_update'
        with pytest.raises(ValueError, match='use_fused_update=True requires'):
            make_sac(NET_DIMS, S, A, _args(Config, device='cpu', use_fused_update=True, **kw),
                     rb, hterm=hterm)


# ------------------------------------------------------------- checkpoints

@pytest.mark.parametrize('modsac', [False, True], ids=['sac', 'modsac'])
def test_checkpoint_round_trip(modsac):
    """JAX state -> numpy -> port -> numpy keeps JAX's leaves in JAX's order
    (the stacked ensemble heads, the temperature's optimizer, the int32
    gate counter), and an npz written by ``save_tree`` loads back."""
    js = _np(jmake_sac(NET_DIMS, S, A, JConfig(), None, modsac=modsac).init(
        jax.random.PRNGKey(3)))
    agent = make_sac(NET_DIMS, S, A, _args(Config, device='cpu'), None, modsac=modsac)
    tree = agent.state_to_numpy(agent.state_from_numpy(js, 'cpu'))
    for a, b in zip(jax.tree.leaves(js), tree_leaves(tree), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b, a)
    assert (tree.act_target is None) == (not modsac)
    with tempfile.TemporaryDirectory() as d:
        save_tree(os.path.join(d, 'agent.npz'), tree)
        back = agent.state_from_numpy(load_tree(os.path.join(d, 'agent.npz'), tree), 'cpu')
    for a, b in zip(jax.tree.leaves(js), tree_leaves(agent.state_to_numpy(back))):
        np.testing.assert_array_equal(b, a)


def test_port_init_has_the_jax_shapes():
    for modsac in (False, True):
        js = _np(jmake_sac(NET_DIMS, S, A, JConfig(), None, modsac=modsac).init(
            jax.random.PRNGKey(0)))
        agent = make_sac(NET_DIMS, S, A, _args(Config, device='cpu'), None, modsac=modsac)
        tree = agent.state_to_numpy(agent.init(0, 'cpu'))
        assert [x.shape for x in jax.tree.leaves(js)] == [x.shape for x in tree_leaves(tree)]
        assert float(tree.alpha_log) == -1.0 and int(tree.update_a) == 0
