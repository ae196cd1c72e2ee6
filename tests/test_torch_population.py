"""Population training of the port (``elegantrl_tpu_torch/parallel/
population.py``) on the CPU: the per-member loop through ``round_fn``, the
evaluation, truncation selection with copies that share nothing, and one
generation against the JAX package's ``train_agent_population`` (G = 1, R
= 1, interpret kernels, as ``tests/test_population.py:27`` runs it) with
JAX's member weights, env states and obs carried across and its per-member
draws replayed.

JAX's members (``population.py:59-67``): ``fold_in(key(seed), m)`` split
into the agent's, the env's and the training key; a round splits the
training key as ``key, k_roll, k_upd = split(key, 3)``, the rollout draws
``normal(kz, (H, 1, N))`` and ``uniform(ku, (H, 2, N))`` from ``kz, ku =
split(k_roll)`` and the update one ``randint`` id vector per ``split(k_upd,
U)`` key.  Tolerances as ``test_torch_train_round.py``: env states and obs
1e-4, parameter updates rtol 5e-3.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu.agents import AgentPPO as JAgentPPO
from elegantrl_tpu.config import Config as JConfig
from elegantrl_tpu.envs import PendulumEnv as JPendulumEnv
from elegantrl_tpu.envs.base import vec_reset as jvec_reset
from elegantrl_tpu.parallel.population import train_agent_population as jtrain_population
from elegantrl_tpu.train.runner import build_training as jbuild_training
from elegantrl_tpu_torch import Config, build_training
from elegantrl_tpu_torch.agents import AgentPPO, AgentTD3
from elegantrl_tpu_torch.envs import EnvSpec, PendulumEnv, PendulumState, make_host_env
from elegantrl_tpu_torch.ops import fused_rollout as fr
from elegantrl_tpu_torch.parallel import population as pop
from elegantrl_tpu_torch.train import runner
from elegantrl_tpu_torch.train.runner import TrainCarry
from elegantrl_tpu_torch.utils.checkpoint import tree_leaves
from elegantrl_tpu_torch.utils.jax_params import (env_state_from_numpy, ppo_state_from_numpy,
                                                  ppo_state_to_numpy)

torch.set_num_threads(1)
PEND = {'env_name': 'Pendulum-v1', 'max_step': 200, 'state_dim': 3, 'action_dim': 1,
        'if_discrete': False}


def _args(num_envs=8, horizon=16, repeat=2, batch=128, agent=AgentPPO):
    args = Config(agent, PendulumEnv, dict(PEND, num_envs=num_envs))
    args.device, args.net_dims, args.horizon_len = 'cpu', (16, 16), horizon
    args.repeat_times, args.batch_size, args.random_seed = repeat, batch, 0
    if args.if_off_policy:
        args.buffer_size = 256
    return args


def test_history_has_shape_generations_by_members():
    out = pop.train_agent_population(_args(num_envs=4, horizon=64, repeat=4, batch=32),
                                     population_size=4, generations=2,
                                     rounds_per_generation=2, eval_episodes=4, verbose=False)
    assert out['history'].shape == (2, 4) and np.isfinite(out['history']).all()
    assert np.isfinite(out['best_score']) and len(out['carry']) == 4
    assert out['best_score'] == out['history'][-1].max()


def test_members_take_the_fused_rollout(monkeypatch, capsys):
    """Every member round runs the fused rollout (its plain version here)."""
    calls = []
    real = fr.rollout_reference
    monkeypatch.setattr(fr, 'rollout_reference', lambda *a, **k: calls.append(1) or real(*a, **k))
    out = pop.train_agent_population(_args(), population_size=2, generations=2,
                                     rounds_per_generation=3, eval_episodes=2)
    text = capsys.readouterr().out
    assert 'fused-rollout path enabled' in text and text.count('| popgen') == 2
    assert len(calls) == 2 * 2 * 3 and np.isfinite(out['best_score'])


@pytest.mark.parametrize('agent', [AgentPPO, AgentTD3], ids=['ppo', 'td3'])
def test_selection_copies_share_no_storage(agent):
    """Training a copy leaves its source as it was: the agent state (flat
    parameters and Adam moments, updated in place), the ring, the env state
    and the obs are the copy's own."""
    args = _args(agent=agent)
    ctx = build_training(args)
    src = pop.member_carry(ctx, args, 0, 'cpu')
    for _ in range(2):
        src, _ = ctx.round_fn(src)
    before = [np.array(x) for x in tree_leaves(ctx.agent.state_to_numpy(src.agent_state))]
    copy = pop.clone_member(ctx, src, 7919, 'cpu')
    ptrs = {t.untyped_storage().data_ptr() for t in tree_leaves(src) if isinstance(
        t, torch.Tensor)}
    ptrs |= {t.untyped_storage().data_ptr() for t in tree_leaves(src.agent_state)
             if isinstance(t, torch.Tensor)}
    mine = [t for t in tree_leaves(copy) + tree_leaves(copy.agent_state)
            if isinstance(t, torch.Tensor) and t.numel()]
    assert mine and not ptrs & {t.untyped_storage().data_ptr() for t in mine}
    copy, _ = ctx.round_fn(copy)
    after = [np.array(x) for x in tree_leaves(ctx.agent.state_to_numpy(src.agent_state))]
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, np.asarray(b)) for a, b in zip(
        before, tree_leaves(ctx.agent.state_to_numpy(copy.agent_state))))


def _jax_src(scores):
    """``elegantrl_tpu/parallel/population.py:106, 121-122``, verbatim."""
    population_size = len(scores)
    order = np.argsort(-scores)
    half = population_size // 2
    return np.concatenate([order[:population_size - half], order[:half]])


@pytest.mark.parametrize('scores', [
    [3.0, 1.0, 4.0, 1.5],
    [2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0],
    [-1.0, 5.0, 5.0, -1.0, 0.5],
    [0.1, 0.3, 0.3, 0.2, 0.3, -4.0],
], ids=['distinct', 'all_tied', 'odd_ties', 'three_way_tie'])
def test_selection_src_as_jax(scores):
    scores = np.asarray(scores, np.float32)
    np.testing.assert_array_equal(pop.selection_src(scores), _jax_src(scores))


def test_pop_mesh_puts_members_in_blocks():
    args = _args()
    ctx = build_training(args)
    assert pop._member_devices(ctx, 4, {'pop': 2}) == [torch.device('cpu')] * 4
    with pytest.raises(ValueError, match='population_size=3 is not a multiple'):
        pop._member_devices(ctx, 3, {'pop': 2})
    out = pop.train_agent_population(args, population_size=2, generations=1,
                                     rounds_per_generation=1, eval_episodes=2,
                                     mesh_axes={'pop': 2}, verbose=False)
    assert out['history'].shape == (1, 2)


def test_members_train_and_evaluate_under_their_own_device(monkeypatch):
    """Each member's round and evaluation run with its device current
    (``torch.cuda.device``, stubbed here, entered for the CPU too), so a
    member on another card launches its kernels there."""
    entered, current, evals = [], [None], []

    @contextlib.contextmanager
    def cuda_device(dev):
        entered.append(str(torch.device(dev)))
        before, current[0] = current[0], len(entered) - 1
        try:
            yield
        finally:
            current[0] = before

    make = pop.make_eval_fn

    def make_eval_fn(*a, **k):
        fn = make(*a, **k)

        def run(*b):
            evals.append(current[0])
            return fn(*b)
        return run

    monkeypatch.setattr(runner, 'device_scope', cuda_device)
    monkeypatch.setattr(pop, 'device_scope', cuda_device)
    monkeypatch.setattr(pop, 'make_eval_fn', make_eval_fn)
    pop.train_agent_population(_args(), population_size=2, generations=1,
                               rounds_per_generation=1, eval_episodes=2,
                               mesh_axes={'pop': 2}, verbose=False)
    assert entered == ['cpu'] * 4      # member 0's round, member 1's, then their evaluations
    assert evals == [2, 3]


class _HostEnv:
    """A numpy env of the gym protocol (no gymnasium needed)."""

    def reset(self, seed=None, options=None):
        return np.zeros(3, np.float32), {}

    def step(self, action):
        return np.zeros(3, np.float32), 0.0, False, False, {}


def test_host_env_members_raise():
    env = make_host_env(_HostEnv, EnvSpec('HostToy-v0', 2, 200, 3, 1, False))
    args = Config(AgentPPO, env, dict(PEND, env_name='HostToy-v0', num_envs=2))
    args.device, args.net_dims, args.horizon_len, args.batch_size = 'cpu', (16, 16), 8, 16
    with pytest.raises(NotImplementedError, match='HostToy-v0'):
        pop.train_agent_population(args, population_size=2, generations=1,
                                   rounds_per_generation=1, verbose=False)


@pytest.fixture(scope='module')
def one_generation():
    """JAX's population at P = 2, G = 1, R = 1 with interpret kernels; the
    port's generation on JAX's member states and draws."""
    P, N, H, B = 2, 8, 16, 128
    jargs = JConfig(JAgentPPO, JPendulumEnv, dict(PEND, num_envs=N))
    jargs.net_dims, jargs.horizon_len, jargs.repeat_times, jargs.batch_size = (16, 16), H, 2, B
    jargs.use_pallas_rollout = jargs.use_pallas_update = 'interpret'
    jargs.random_seed = 0
    jout = jtrain_population(jargs, population_size=P, generations=1, rounds_per_generation=1,
                             eval_episodes=2, verbose=False)
    jctx = jbuild_training(jargs)

    def member(seed):   # population.py:59-67
        k_agent, k_env, k_train = jax.random.split(
            jax.random.fold_in(jax.random.key(jargs.random_seed), seed), 3)
        env_state, obs = jvec_reset(jctx.env, k_env, N)
        return jctx.agent.init(k_agent), env_state, obs, k_train

    members = jax.vmap(member)(jnp.arange(P))
    U = max(1, int(H * 2 / B))
    args = _args(num_envs=N, horizon=H, repeat=2, batch=B)
    ctx = build_training(args)
    assert ctx.fused_rollout
    carries, draws = [], []
    for m in range(P):
        agent_state, env_state, obs, k_train = jax.tree.map(lambda x: x[m], members)
        _, k_roll, k_upd = jax.random.split(k_train, 3)
        kz, ku = jax.random.split(k_roll)
        noise = jnp.concatenate([jax.random.normal(kz, (H, 1, N), jnp.float32),
                                 jax.random.uniform(ku, (H, 2, N), jnp.float32)], 1)
        ids = jax.vmap(lambda k: jax.random.randint(k, (B,), 0, H * N))(
            jax.random.split(k_upd, U))
        carries.append(TrainCarry(
            ppo_state_from_numpy(jax.tree.map(np.asarray, agent_state), 'cpu'), None,
            env_state_from_numpy(PendulumState, jax.tree.map(np.asarray, env_state), 'cpu'),
            torch.from_numpy(np.array(obs)), torch.Generator().manual_seed(m)))
        draws.append([{'noise': torch.from_numpy(np.array(noise)),
                       'ids': torch.from_numpy(np.array(ids)).long()}])
    old = [ppo_state_to_numpy(c.agent_state) for c in carries]
    got = pop.train_members(ctx, carries, 1, draws)
    return dict(jout=jout, members=members, got=got, old=old, P=P)


def test_one_generation_parameters_match_jax(one_generation):
    g = one_generation
    jcarry = g['jout']['carry']
    for m in range(g['P']):
        jnew = jax.tree.map(lambda x: np.asarray(x[m]), jcarry.agent_state)
        jold = jax.tree.map(lambda x: np.asarray(x[m]), g['members'][0])
        new = ppo_state_to_numpy(g['got'][m].agent_state)
        for part in ('act', 'cri'):
            for a, b, ja, jb in zip(tree_leaves(getattr(new, part)),
                                    tree_leaves(getattr(g['old'][m], part)),
                                    tree_leaves(getattr(jnew, part)),
                                    tree_leaves(getattr(jold, part))):
                np.testing.assert_allclose(a - b, ja - jb, rtol=5e-3, atol=1e-8)


def test_one_generation_env_states_and_obs_match_jax(one_generation):
    g = one_generation
    jcarry = g['jout']['carry']
    assert g['jout']['history'].shape == (1, g['P'])
    for m in range(g['P']):
        c = g['got'][m]
        np.testing.assert_allclose(c.env_state.theta.numpy(),
                                   np.asarray(jcarry.env_state.theta[m]), atol=1e-4)
        np.testing.assert_array_equal(c.env_state.t.numpy(), np.asarray(jcarry.env_state.t[m]))
        np.testing.assert_allclose(c.obs.numpy(), np.asarray(jcarry.obs[m]), atol=1e-4)
