"""One whole training round of the port (``elegantrl_tpu_torch``, on the
CPU, so through both kernels' plain versions) against the JAX package's
round with both Pallas paths in interpret mode, on the same weights, env
state, exploration noise and minibatch ids; then ``train_agent`` end to
end on the CPU.

The JAX round splits its carry key as ``key, k_roll, k_upd = split(key,
3)`` (``train/runner.py:round_fn``); the rollout kernel's wrapper draws
``normal(kz, (H, 1, N))`` and ``uniform(ku, (H, 2, N))`` from
``kz, ku = split(k_roll)``, and the update draws one ``randint`` id vector
per ``split(k_upd, U)`` key (``agents/ppo.py:update``).  The test replays
exactly those draws into the port's ``round_fn``.

Tolerances: rollouts and advantages 1e-4 (f32 rounding carried through
H steps of dynamics); parameter updates rtol 5e-3 and metrics rtol 1e-4,
as the JAX package's own update tests.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu.agents import AgentPPO as JAgentPPO
from elegantrl_tpu.config import Config as JConfig
from elegantrl_tpu.envs import PendulumEnv as JPendulumEnv
from elegantrl_tpu.ops import gae as jgae
from elegantrl_tpu.ops.pallas_rollout import PENDULUM_BODY as JBODY, make_fused_rollout as jmfr
from elegantrl_tpu.train.runner import build_training as jbuild_training
from elegantrl_tpu.utils.checkpoint import load_pytree as jload_pytree
from elegantrl_tpu_torch import Config, build_training, train_agent
from elegantrl_tpu_torch.agents import AgentPPO
from elegantrl_tpu_torch.envs import PendulumEnv, PendulumState
from elegantrl_tpu_torch.ops import gae
from elegantrl_tpu_torch.ops.fused_rollout import PENDULUM_BODY, make_fused_rollout
from elegantrl_tpu_torch.utils.checkpoint import tree_leaves
from elegantrl_tpu_torch.utils.jax_params import ppo_state_from_numpy, ppo_state_to_numpy

torch.set_num_threads(1)
H, N, B = 32, 16, 128
U = int(H * 8 / B)
ENV_ARGS = {'env_name': 'Pendulum-v1', 'num_envs': N, 'max_step': 200, 'state_dim': 3,
            'action_dim': 1, 'if_discrete': False}


def _configure(args):
    args.horizon_len, args.net_dims, args.batch_size = H, (16, 16), B
    args.repeat_times, args.random_seed, args.reward_scale = 8.0, 0, 0.5
    return args


@pytest.fixture(scope='module')
def rounds():
    jargs = _configure(JConfig(JAgentPPO, JPendulumEnv, dict(ENV_ARGS)))
    jargs.use_pallas_rollout = jargs.use_pallas_update = 'interpret'
    jctx = jbuild_training(jargs)
    jc = jctx.carry
    _, k_roll, k_upd = jax.random.split(jc.key, 3)
    kz, ku = jax.random.split(k_roll)
    noise = np.asarray(jnp.concatenate([jax.random.normal(kz, (H, 1, N), jnp.float32),
                                        jax.random.uniform(ku, (H, 2, N), jnp.float32)], 1))
    ids = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (B,), 0, H * N))(
        jax.random.split(k_upd, U)))
    jc2, jm = jax.jit(jctx.round_fn)(jc, None)

    args = _configure(Config(AgentPPO, PendulumEnv, dict(ENV_ARGS)))
    args.device = 'cpu'
    ctx = build_training(args)
    assert ctx.fused_rollout
    state = ppo_state_from_numpy(jax.tree.map(np.asarray, jc.agent_state), 'cpu')
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    env_state = PendulumState(t(jc.env_state.theta), t(jc.env_state.theta_dot),
                              t(jc.env_state.t))
    carry = ctx.carry._replace(agent_state=state, env_state=env_state, obs=t(jc.obs))
    old = ppo_state_to_numpy(state)
    c2, m = ctx.round_fn(carry, noise=t(noise), ids=t(ids).long())
    return dict(jc=jc, jc2=jc2, jm=jm, old=old, c2=c2, m=m, noise=noise,
                k_roll=k_roll, env_state=env_state)


def test_round_metrics_match(rounds):
    for k in ('obj_critic', 'obj_actor', 'obj_entropy', 'exp_r'):
        np.testing.assert_allclose(float(rounds['m'][k]), float(rounds['jm'][k]),
                                   rtol=1e-4, atol=1e-6)


def test_round_parameter_updates_match(rounds):
    jold = jax.tree.map(np.asarray, rounds['jc'].agent_state)
    jnew = jax.tree.map(np.asarray, rounds['jc2'].agent_state)
    new = ppo_state_to_numpy(rounds['c2'].agent_state)
    old = rounds['old']
    for part in ('act', 'cri'):
        for a, b, ja, jb in zip(tree_leaves(getattr(new, part)), tree_leaves(getattr(old, part)),
                                tree_leaves(getattr(jnew, part)), tree_leaves(getattr(jold, part))):
            np.testing.assert_allclose(a - b, ja - jb, rtol=5e-3, atol=1e-8)
    assert rounds['c2'].agent_state.act_opt.count == U


def test_round_env_state_and_obs_match(rounds):
    c2, jc2 = rounds['c2'], rounds['jc2']
    np.testing.assert_allclose(c2.env_state.theta.numpy(), np.asarray(jc2.env_state.theta),
                               atol=1e-4)
    np.testing.assert_array_equal(c2.env_state.t.numpy(), np.asarray(jc2.env_state.t))
    np.testing.assert_allclose(c2.obs.numpy(), np.asarray(jc2.obs), atol=1e-4)


def test_round_rollout_and_advantages_match(rounds):
    """The round's rollout and its advantages, through both packages'
    pieces on the same inputs."""
    jc = rounds['jc']
    jro, _, jlast = jmfr(JBODY, (16, 16), H, N, 0.5, discrete=False, block=8,
                         interpret=True)(jc.agent_state, jc.env_state, jc.obs, rounds['k_roll'])
    # a fresh copy of the weights: the round above updated its state in place
    state = ppo_state_from_numpy(jax.tree.map(np.asarray, jc.agent_state), 'cpu')
    ro, _, last = make_fused_rollout(PENDULUM_BODY, (16, 16), H, N, 0.5)(
        state, rounds['env_state'], None, noise=torch.from_numpy(rounds['noise'].copy()))
    for f in ('states', 'actions', 'logprobs', 'rewards', 'undones', 'unmasks'):
        np.testing.assert_allclose(getattr(ro, f).numpy(), np.asarray(getattr(jro, f)),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=1e-4)
    jv = jro.extras['values']
    jr, jd = jgae.apply_truncation_bootstrap(jro.rewards, jro.undones, jro.unmasks, jv)
    jnv = jnp.asarray(np.asarray(ro.extras['values'][-1]))   # any (N,) bootstrap value
    jadv = jgae.normalize_advantages(jgae.gae_vtrace(jr, jd, jv, jnv, 0.99, 0.95))
    r, d = gae.apply_truncation_bootstrap(ro.rewards, ro.undones, ro.unmasks,
                                          ro.extras['values'])
    adv = gae.normalize_advantages(gae.gae_vtrace(r, d, ro.extras['values'],
                                                  torch.from_numpy(np.array(jnv)), 0.99, 0.95))
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), rtol=1e-4, atol=1e-4)


def test_train_agent_on_cpu(tmp_path):
    args = _configure(Config(AgentPPO, PendulumEnv, dict(ENV_ARGS)))
    args.device, args.cwd = 'cpu', str(tmp_path / 'run')
    args.eval_per_step, args.break_step, args.eval_times = H * N, 1000, 2
    out = train_agent(args)
    assert out['total_step'] == 2 * H * N
    assert out['recorder'].shape[0] == 2 and np.isfinite(out['recorder']).all()
    for name in ('agent.npz', 'train_carry.npz', 'recorder.npy'):
        assert os.path.isfile(os.path.join(args.cwd, name))
    # the checkpoint has the JAX package's leaf order: its loader reads it
    jargs = _configure(JConfig(JAgentPPO, JPendulumEnv, dict(ENV_ARGS)))
    jtemplate = JAgentPPO.make((16, 16), 3, 1, jargs).init(jax.random.PRNGKey(0))
    loaded = jload_pytree(os.path.join(args.cwd, 'agent.npz'), jtemplate)
    want = ppo_state_to_numpy(out['agent_state'])
    for a, b in zip(jax.tree.leaves(loaded), tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_continue_train_resumes_the_carry(tmp_path):
    args = _configure(Config(AgentPPO, PendulumEnv, dict(ENV_ARGS)))
    args.device, args.cwd = 'cpu', str(tmp_path / 'run')
    args.eval_per_step, args.break_step, args.eval_times = H * N, 100, 2
    first = train_agent(args)
    args.continue_train = True
    ctx = build_training(args)
    for a, b in zip(tree_leaves(ppo_state_to_numpy(ctx.carry.agent_state)),
                    tree_leaves(ppo_state_to_numpy(first['agent_state']))):
        np.testing.assert_array_equal(a, b)


def test_device_cuda_runs_on_the_card_or_raises():
    args = _configure(Config(AgentPPO, PendulumEnv, dict(ENV_ARGS)))
    assert args.device == 'cuda'
    if torch.cuda.is_available():
        assert build_training(args).device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='cuda'):
            build_training(args)


def _as_if_on_a_card(monkeypatch):
    """``build_training`` sees a CUDA device; the kernel selection raises
    before any tensor is made there."""
    from elegantrl_tpu_torch.train import runner
    monkeypatch.setattr(runner, 'resolve_device', lambda args: torch.device('cuda'))


@pytest.mark.parametrize('flag', ['use_fused_rollout', 'use_fused_update'])
def test_explicit_kernel_request_raises_on_ineligible(flag, monkeypatch, capsys):
    args = _configure(Config(AgentPPO, PendulumEnv, dict(ENV_ARGS)))
    args.device, args.net_dims = 'cpu', (16, 16, 16)      # 3 hidden layers
    setattr(args, flag, True)
    with pytest.raises(ValueError, match=flag):
        build_training(args)
    setattr(args, flag, 'auto')           # on the CPU 'auto' takes the plain path
    ctx = build_training(args)
    _, m = ctx.round_fn(ctx.carry)
    assert np.isfinite(float(m['obj_critic']))
    args.device = 'cuda'
    _as_if_on_a_card(monkeypatch)
    if flag == 'use_fused_rollout':
        # on a card 'auto' raises for a workload the JAX package sends to its
        # kernel but this kernel does not fit: K1's weight slices at (384, 384)
        # exceed a cluster of 8 blocks
        args.net_dims = (384, 384)
        with pytest.raises(ValueError, match=f'{flag}: on cuda'):
            build_training(args)
    else:
        # a 3-layer update is XLA ops in the JAX package: autograd on a card too
        capsys.readouterr()
        AgentPPO.make((16, 16, 16), 3, 1, args)
        assert 'use_fused_update: PyTorch path' in capsys.readouterr().out


@pytest.mark.parametrize('flag', ['use_fused_rollout', 'use_fused_update'])
def test_plain_path_is_refused_on_a_card(flag, monkeypatch):
    args = _configure(Config(AgentPPO, PendulumEnv, dict(ENV_ARGS)))
    args.device = 'cpu'                   # on the CPU False is allowed
    setattr(args, flag, False)
    assert build_training(args).fused_rollout == (flag != 'use_fused_rollout')
    args.device = 'cuda'
    _as_if_on_a_card(monkeypatch)
    with pytest.raises(ValueError, match=f'{flag}=False .* CPU only'):
        build_training(args)


@pytest.mark.parametrize('variant', ['hterm'])
def test_unported_variants_raise(variant):
    """The H-term, once unported, is continuous PPO only and has no kernel
    (the JAX package runs its update as XLA ops): asking for one raises."""
    from elegantrl_tpu_torch.agents.ppo import make_ppo
    args = _configure(Config())
    assert make_ppo((16, 16), 3, 1, args, **{variant: True}).name == 'AgentPPOHterm'
    with pytest.raises(ValueError, match='continuous PPO only'):
        make_ppo((16, 16), 3, 2, args, discrete=True, **{variant: True})
    args.use_fused_update = True
    with pytest.raises(ValueError, match='use_fused_update=True requires'):
        make_ppo((16, 16), 3, 1, args, **{variant: True})
