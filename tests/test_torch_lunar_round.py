"""The LunarLander slice as a whole: one ``AgentPPO`` round on
LunarLanderContinuous-v2 and one ``AgentDQN`` round on LunarLander-v2 of the
port (on the CPU, so through the plain versions of K10, K11a, K11b and of the
update kernels K2 and K9) against the JAX package's round (its generic
rollout scan, its update's scan path), from the same weights (carried in
through ``utils/jax_params.py``), env state, actions and minibatch draws.
Then the update kernels' eligibility at the slice's full widths, the three
aliases of ``train_agent`` and a ``valid_agent`` round trip.

The JAX round is ``round_fn``'s generic branch, written out so that its
rollout can be read: ``key, k_roll, k_upd = split(key, 3)``, ``collect_rollout``
on ``k_roll``, the update on ``k_upd`` (PPO: one flat-id ``randint`` per
``split(k_upd, U)`` key; DQN: ``B / N`` rows from ``fold_in(k_upd, i)``).  The
port's round replays the JAX rollout's actions in place of its own samples
(``dists.normal_sample`` and ``epsilon_greedy`` stand in), so everything
else, the forwards, the log-probabilities, the env steps, the values, the
advantages and the update, is the port's own.  No lander ends inside these
short rollouts, so no reset draw enters.

Tolerances, as ``tests/test_torch_onpolicy_agents.py`` and
``tests/test_torch_offpolicy_agents.py``: env state 1e-5, parameter
updates (new - old) rtol 5e-3, metrics rtol 1e-4, replay buffer 1e-5
(rewards: 1e-5 of the shapings they are differences of, as
``tests/test_torch_lunar_lander.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import elegantrl_tpu.ops.pallas_update as jpu
from elegantrl_tpu.agents import AgentDQN as JAgentDQN, AgentPPO as JAgentPPO
from elegantrl_tpu.agents.base import Rollout as JRollout, collect_rollout as jcollect
from elegantrl_tpu.config import Config as JConfig
from elegantrl_tpu.envs import (LunarLanderContinuousEnv as JLanderCont,
                                LunarLanderEnv as JLander)
from elegantrl_tpu.train.replay_buffer import ReplayBuffer as JReplayBuffer
from elegantrl_tpu.train.runner import build_training as jbuild_training
import elegantrl_tpu_torch
from elegantrl_tpu_torch import Config, build_training, train_agent, valid_agent
from elegantrl_tpu_torch.agents import AgentD3QN, AgentDQN, AgentPPO
from elegantrl_tpu_torch.agents import dqn as pdqn
from elegantrl_tpu_torch.agents import ppo as pppo
from elegantrl_tpu_torch.envs import LanderState, LunarLanderContinuousEnv, LunarLanderEnv
from elegantrl_tpu_torch.ops import dists, kernels
from elegantrl_tpu_torch.train.replay_buffer import ReplayBuffer
from elegantrl_tpu_torch.utils.checkpoint import tree_leaves
from elegantrl_tpu_torch.utils.jax_params import buffer_state_to_numpy, env_state_from_numpy

torch.set_num_threads(1)
CONT = {'env_name': 'LunarLanderContinuous-v2', 'max_step': 1000, 'state_dim': 8,
        'action_dim': 2, 'if_discrete': False}
DISC = {'env_name': 'LunarLander-v2', 'max_step': 1000, 'state_dim': 8, 'action_dim': 4,
        'if_discrete': True}
# name -> (JAX agent, JAX env, agent, env, env args, envs, horizon, batch, repeat)
ROUNDS = {
    'ppo_lunar_cont': (JAgentPPO, JLanderCont, AgentPPO, LunarLanderContinuousEnv, CONT,
                       8, 16, 128, 16.0),
    'dqn_lunar': (JAgentDQN, JLander, AgentDQN, LunarLanderEnv, DISC, 16, 8, 128, 48.0),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _args(config_class, agent_class, env_class, env_args, n, h, batch, repeat):
    args = config_class(agent_class, env_class, dict(env_args, num_envs=n))
    args.net_dims, args.horizon_len, args.batch_size = (16, 16), h, batch
    args.repeat_times, args.random_seed, args.reward_scale = repeat, 0, 0.5
    args.buffer_size, args.buffer_init_size = 64, 16
    return args


@pytest.fixture(scope='module', params=list(ROUNDS))
def rounds(request):
    jagent_cls, jenv_cls, agent_cls, env_cls, env_args, n, h, batch, repeat = \
        ROUNDS[request.param]
    off = request.param == 'dqn_lunar'
    jargs = _args(JConfig, jagent_cls, jenv_cls, env_args, n, h, batch, repeat)
    jargs.use_pallas_update = False
    jctx = jbuild_training(jargs)
    jagent, jc = jctx.agent, jctx.carry

    @jax.jit
    def jround(carry):
        _, k_roll, k_upd = jax.random.split(carry.key, 3)
        rollout, env_state, obs = jcollect(
            jctx.env, carry.agent_state, jagent.explore_action, jagent.env_action,
            carry.env_state, carry.obs, k_roll, h, 0.5, extras_fn=jagent.rollout_extras)
        if off:
            buf = jctx.rb.update(carry.buf_state, (rollout.states, rollout.actions,
                                                   rollout.rewards, rollout.undones,
                                                   rollout.unmasks))
            state, buf, metrics = jagent.update(carry.agent_state, buf, k_upd)
        else:
            buf = None
            state, metrics = jagent.update(carry.agent_state, rollout, obs, k_upd)
        return (rollout, env_state, obs, state, buf,
                dict(metrics, exp_r=jnp.mean(rollout.rewards)), k_upd)

    jroll, jenv_state, jobs, jstate, jbuf, jm, k_upd = jround(jc)
    assert np.all(np.asarray(jroll.undones) == 1) and np.all(np.asarray(jroll.unmasks) == 1)
    if off:
        ids = np.stack([np.asarray(jax.random.randint(jax.random.fold_in(k_upd, i),
                                                      (batch // n,), 0, h - 1))
                        for i in range(int(h * repeat / batch))])
    else:
        ids = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (batch,), 0, h * n))(
            jax.random.split(k_upd, int(h * repeat / batch))))

    actions = torch.from_numpy(np.array(jroll.actions))
    step = [0]

    def replayed(*_a, **_k):
        step[0] += 1
        return actions[step[0] - 1].clone()

    args = _args(Config, agent_cls, env_cls, env_args, n, h, batch, repeat)
    args.device = 'cpu'
    mp = pytest.MonkeyPatch()
    if off:
        mp.setattr(pdqn, 'epsilon_greedy', replayed)
    else:
        mp.setattr(dists, 'normal_sample', replayed)
    try:
        ctx = build_training(args)
        carry = ctx.carry._replace(
            agent_state=ctx.agent.state_from_numpy(_np(jc.agent_state), 'cpu'),
            env_state=env_state_from_numpy(LanderState, _np(jc.env_state), 'cpu'),
            obs=torch.from_numpy(np.array(jc.obs)))
        old = ctx.agent.state_to_numpy(carry.agent_state)
        before = {f.__name__: f.launches for f in (kernels.fused_mlp3, kernels.buffer_gather)}
        c2, m = ctx.round_fn(carry, ids=torch.from_numpy(ids.copy()).long())
    finally:
        mp.undo()
    assert step[0] == h
    return dict(old=old, jold=_np(jc.agent_state), jstate=_np(jstate), jbuf=jbuf,
                jm={k: float(v) for k, v in jm.items() if k != 'action_hist'},
                jenv_state=_np(jenv_state), jobs=np.asarray(jobs), jroll=jroll, c2=c2, m=m,
                ctx=ctx, launches=before)


def test_round_env_state_and_obs_match(rounds):
    c2 = rounds['c2']
    for k in LanderState._fields:
        np.testing.assert_allclose(getattr(c2.env_state, k).numpy(),
                                   getattr(rounds['jenv_state'], k), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(c2.obs.numpy(), rounds['jobs'], rtol=1e-5, atol=1e-5)
    if rounds['jbuf'] is not None:           # the DQN round's replay ring
        got = buffer_state_to_numpy(c2.buf_state)
        # a reward is a difference of two shapings (|shaping| ~ 200): 1e-5 of them
        scale = 2 * 0.5 * np.abs(rounds['jenv_state'].prev_shaping).max()
        for name in ('states', 'actions', 'rewards', 'undones', 'unmasks'):
            np.testing.assert_allclose(getattr(got, name),
                                       np.asarray(getattr(rounds['jbuf'], name)), rtol=0,
                                       atol=1e-5 * (scale if name == 'rewards' else 1),
                                       err_msg=name)


def test_round_parameter_updates_match(rounds):
    got = tree_leaves(rounds['ctx'].agent.state_to_numpy(rounds['c2'].agent_state))
    want, jold = jax.tree.leaves(rounds['jstate']), jax.tree.leaves(rounds['jold'])
    assert len(got) == len(want)
    for a, b, o in zip(got, want, jold):
        a, b, o = (np.asarray(x, np.float64) for x in (a, b, o))
        if a.size > 1:
            np.testing.assert_allclose(a - o, b - o, rtol=5e-3, atol=4e-7)


def test_round_metrics_match(rounds):
    m, jm = rounds['m'], rounds['jm']
    for k in ('obj_critic', 'obj_actor', 'exp_r'):
        np.testing.assert_allclose(float(m[k]), jm[k], rtol=1e-4, atol=1e-6, err_msg=k)


class _Taken(Exception):
    pass


@pytest.mark.parametrize('agent', ['dqn_lunarlander', 'd3qn_lunarlander'])
def test_k9_taken_at_full_width_as_jax(agent, monkeypatch):
    """(256, 256), batch 256, 64 envs: the JAX package builds its DQN chunk
    (interpret mode on the CPU), and the port on a card takes K9."""
    from elegantrl_tpu.agents.dqn import make_dqn as jmake_dqn
    twin = duel = agent == 'd3qn_lunarlander'
    calls = []

    def record(*a, **k):
        calls.append(a)
        raise _Taken

    monkeypatch.setattr(jpu, 'make_dqn_fused_chunk', record)
    jargs = JConfig()
    jargs.batch_size, jargs.use_pallas_update = 256, 'interpret'
    jrb = JReplayBuffer(max_size=30000, state_dim=8, action_dim=4, num_seqs=64,
                        if_discrete=True, args=jargs)
    with pytest.raises(_Taken):
        jmake_dqn((256, 256), 8, 4, jargs, twin=twin, duel=duel, buffer=jrb)
    assert calls
    chosen = []
    real = pdqn.select_kernel
    monkeypatch.setattr(pdqn, 'select_kernel',
                        lambda a, flag, *r, **k: chosen.append(real(a, flag, *r, **k))
                        or chosen[-1])
    args = Config()
    args.batch_size, args.device = 256, 'cuda'
    rb = ReplayBuffer(30000, 8, 4, num_seqs=64, if_discrete=True, args=args, device='cuda')
    pdqn.make_dqn((256, 256), 8, 4, args, twin=twin, duel=duel, buffer=rb)
    assert chosen == [True]


def test_train_agent_aliases_are_exported():
    from elegantrl_tpu_torch.train import runner
    for name in ('train_agent', 'train_agent_single_process', 'train_agent_multiprocessing',
                 'train_agent_multiprocessing_multi_gpu', 'valid_agent', 'render_agent'):
        assert getattr(elegantrl_tpu_torch, name) is getattr(runner, name), name
    assert elegantrl_tpu_torch.render_agent is valid_agent


@pytest.mark.parametrize('case', ['ppo', 'd3qn'])
def test_valid_agent_round_trip(case, tmp_path, monkeypatch):
    """Train two evaluation periods on the CPU through an alias of
    ``train_agent`` (``if_single_process`` too), then ``valid_agent`` loads the
    saved ``agent.npz`` and plays the same greedy episodes as the trained
    state does."""
    from elegantrl_tpu_torch import train_agent_multiprocessing
    from elegantrl_tpu_torch.train.evaluator import make_eval_fn
    agent_class, env_class, env_args = ((AgentPPO, LunarLanderContinuousEnv, CONT) if case == 'ppo'
                                        else (AgentD3QN, LunarLanderEnv, DISC))
    # max_step 100 bounds the evaluator's episodes (valid_agent plays the env's 1000)
    args = Config(agent_class, env_class, dict(env_args, num_envs=4, max_step=100))
    args.net_dims, args.horizon_len, args.batch_size, args.device = (16, 16), 16, 64, 'cpu'
    args.buffer_size, args.random_seed, args.cwd = 64, 0, str(tmp_path)
    args.eval_per_step, args.break_step, args.eval_times = 64, 64, 2
    res = (train_agent_multiprocessing(args) if case == 'ppo'
           else train_agent(args, if_single_process=False))
    assert res['recorder'].shape[0] == 2
    pairs = valid_agent(env_class, dict(env_args, num_envs=4), (16, 16), agent_class,
                        str(tmp_path / 'agent.npz'), render_times=3, device='cpu')
    assert len(pairs) == 3 and all(np.isfinite(r) and 1 <= s <= 1000 for r, s in pairs)
    ctx = build_training(args)
    fn = make_eval_fn(ctx.env, ctx.agent.greedy_action, 3, 1000, "cpu")
    gen = torch.Generator().manual_seed(1)
    returns, steps = fn(res['agent_state'], gen)
    assert [(float(r), int(s)) for r, s in zip(returns, steps)] == pairs
