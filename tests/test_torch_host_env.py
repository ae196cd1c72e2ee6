"""Host environments in the port (``elegantrl_tpu_torch/envs/host_env.py``,
``gym_parity.py``, the runner's host-rollout mode and the evaluator's host
path) against the JAX package's, on gymnasium's Pendulum-v1 and CartPole-v1.

- The pool: obs, rewards and flags bitwise equal to the JAX ``_HostPool``'s
  for sequential, threaded and forked stepping (the same construction and
  seeding order); every forked pool is closed in a ``finally``.
- The host rollout against ``host_collect_rollout`` for PPO and SAC, with
  the JAX explore draws (``normal(split(key, H)[t], (N, A))``) fed in as
  the port's injected normals, on two pools built alike: within 1e-5.
- One host round, PPO and SAC, against the JAX ``update_from_rollout`` on
  the same rollout with the JAX update's minibatch ids and noise
  (``split(carry.key)``'s second key, as ``test_torch_train_round.py`` and
  ``test_torch_sac_agents.py`` replay them): parameters within 1e-5.
  ``round_fn`` in host-rollout mode is the host rollout followed by
  ``update_from_rollout``, bitwise.
- The evaluator's host path: the same returns and episode lengths.
- ``args.host_rollout = False`` turns host evaluation off too; a resumed
  host run points its obs at the pool's fresh episodes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

gym = pytest.importorskip('gymnasium')

from elegantrl_tpu.agents import AgentPPO as JAgentPPO, AgentSAC as JAgentSAC  # noqa: E402
from elegantrl_tpu.agents.base import Rollout as JRollout  # noqa: E402
from elegantrl_tpu.config import Config as JConfig  # noqa: E402
from elegantrl_tpu.envs.base import EnvSpec as JEnvSpec  # noqa: E402
from elegantrl_tpu.envs.host_env import (_HostPool as JHostPool,  # noqa: E402
                                         host_collect_rollout as jhost_collect_rollout,
                                         make_explore_env_fn,
                                         make_host_env as jmake_host_env)
from elegantrl_tpu.train.evaluator import make_eval_fn as jmake_eval_fn  # noqa: E402
from elegantrl_tpu.train.runner import build_training as jbuild_training  # noqa: E402
from elegantrl_tpu_torch import Config, build_training, train_agent  # noqa: E402
from elegantrl_tpu_torch.agents import AgentPPO, AgentSAC  # noqa: E402
from elegantrl_tpu_torch.agents.base import Rollout  # noqa: E402
from elegantrl_tpu_torch.envs import get_env_args, gym_env_def, make_host_env  # noqa: E402
from elegantrl_tpu_torch.envs.base import EnvSpec, vec_reset, vec_step  # noqa: E402
from elegantrl_tpu_torch.envs.gym_parity import _resolve_env_id  # noqa: E402
from elegantrl_tpu_torch.envs.host_env import _HostPool, host_collect_rollout  # noqa: E402
from elegantrl_tpu_torch.train.evaluator import make_eval_fn  # noqa: E402

torch.set_num_threads(1)
N, H = 4, 8
ENV_ARGS = {'env_name': 'Pendulum-v1', 'num_envs': N, 'max_step': 200, 'state_dim': 3,
            'action_dim': 1, 'if_discrete': False}


def _pendulum():
    return gym.make('Pendulum-v1')


def _cartpole():
    return gym.make('CartPole-v1')


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize('mode', ['sequential', 'threads', 'processes'])
@pytest.mark.parametrize('env_id', ['Pendulum-v1', 'CartPole-v1'])
def test_host_pool_matches_jax(env_id, mode):
    make = _pendulum if env_id == 'Pendulum-v1' else _cartpole
    kw = {'sequential': {}, 'threads': dict(num_threads=3), 'processes': dict(num_procs=3)}[mode]
    jpool, pool = JHostPool(make, seed=3), _HostPool(make, seed=3, **kw)
    rng = np.random.default_rng(0)
    try:
        np.testing.assert_array_equal(pool.reset_all(6), jpool.reset_all(np.int32(6)))
        for _ in range(40):
            a = (rng.uniform(-2, 2, (6, 1)).astype(np.float32) if env_id == 'Pendulum-v1'
                 else rng.integers(0, 2, 6).astype(np.int32))
            for got, want in zip(pool.step(a), jpool.step(a)):
                np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(pool.reset_all(6), jpool.reset_all(np.int32(6)))
    finally:
        pool.close()


def test_host_env_batched_contract():
    """vec_reset/vec_step route a batched env to its own init/step, on the
    caller's device; ``fresh()`` is an independent instance."""
    spec = EnvSpec('Pendulum-v1', N, 200, 3, 1, False)
    env = make_host_env(_pendulum, spec)
    assert env.batched and env.host_pool is not None and env.fresh().host_pool is not env.host_pool
    state, obs = vec_reset(env, None, N, torch.device('cpu'))
    assert obs.shape == (N, 3) and obs.dtype == torch.float32
    state, obs, r, term, trunc = vec_step(env, state, torch.zeros((N, 1)), None)
    assert obs.shape == (N, 3) and r.shape == (N,) and term.dtype == torch.bool
    assert bool(torch.isfinite(obs).all())


def test_gym_parity_factories():
    e = gym_env_def('Pendulum-v0')                  # a stale version resolves to the newest
    assert e.spec.env_name == _resolve_env_id(gym, 'Pendulum-v0') == 'Pendulum-v1'
    assert get_env_args(e, num_envs=3) == dict(ENV_ARGS, num_envs=3)
    assert gym_env_def('CartPole-v1').spec.if_discrete


AGENTS = {'ppo': (JAgentPPO, AgentPPO), 'sac': (JAgentSAC, AgentSAC)}


def _args(cls, agent, env, **kw):
    a = cls(agent, env, dict(ENV_ARGS))
    a.net_dims, a.horizon_len, a.batch_size, a.repeat_times = (16, 16), H, 16, 1.0
    a.random_seed, a.buffer_size, a.replay_row_sample = 0, 64, False
    for k, v in kw.items():
        setattr(a, k, v)
    return a


@pytest.fixture(scope='module', params=list(AGENTS))
def host_round(request):
    """The JAX package's host rollout and host round, and the port's on
    their own pool from the same weights and draws."""
    jagent_class, agent_class = AGENTS[request.param]
    spec = JEnvSpec('Pendulum-v1', N, 200, 3, 1, False)
    jenv = jmake_host_env(_pendulum, spec, seed=5)
    jctx = jbuild_training(_args(JConfig, jagent_class, jenv))
    cpu = jax.devices('cpu')[0]
    key = jax.random.PRNGKey(7)
    jro, jlast = jhost_collect_rollout(jenv.host_pool, make_explore_env_fn(jctx.agent),
                                       jctx.carry.agent_state, np.asarray(jctx.carry.obs), key,
                                       H, 0.5, cpu)
    z = torch.tensor(np.asarray(jnp.stack([jax.random.normal(k, (N, 1), jnp.float32)
                                           for k in jax.random.split(key, H)])))
    jro_j = JRollout(*[None if x is None else jnp.asarray(x) for x in jro[:6]])
    jc2, jm = jax.jit(jctx.update_from_rollout)(jctx.carry, jro_j, jnp.asarray(jlast))

    env = make_host_env(_pendulum, EnvSpec('Pendulum-v1', N, 200, 3, 1, False), seed=5)
    a = _args(Config, agent_class, env, device='cpu')
    ctx = build_training(a)
    assert ctx.use_host_rollout and not ctx.fused_rollout
    np.testing.assert_array_equal(ctx.carry.obs.numpy(), np.asarray(jctx.carry.obs))
    state = ctx.agent.state_from_numpy(_np(jctx.carry.agent_state), 'cpu')
    ro, last = host_collect_rollout(env.host_pool, ctx.agent, state, ctx.carry.obs.numpy(),
                                    None, H, 0.5, torch.device('cpu'), noise=z)
    # the update half on the JAX rollout, with the JAX update's draws
    _, k_upd = jax.random.split(jctx.carry.key)
    if request.param == 'ppo':
        U = max(1, int(H * a.repeat_times / a.batch_size))
        ids = torch.tensor(np.asarray(jax.vmap(lambda k: jax.random.randint(
            k, (a.batch_size,), 0, H * N))(jax.random.split(k_upd, U)))).long()
        extra = dict(ids=ids)
    else:
        U = int(np.float32(H * N) * np.float32(a.repeat_times) / a.batch_size)
        ids, noise = [], []
        for i in range(U):
            k_s, k_n, k_p = jax.random.split(jax.random.fold_in(k_upd, i), 3)
            ids.append(jax.random.randint(k_s, (a.batch_size,), 0, (H - 1) * N))
            noise.append(jnp.stack([jax.random.normal(k, (a.batch_size, 1))
                                    for k in (k_n, k_p)]))
        extra = dict(ids=torch.tensor(np.asarray(jnp.stack(ids))).long(),
                     update_noise=torch.tensor(np.asarray(jnp.stack(noise))))
    t = lambda x: None if x is None else torch.tensor(np.asarray(x))  # noqa: E731
    carry = ctx.carry._replace(agent_state=state)
    c2, m = ctx.update_from_rollout(carry, Rollout(*[t(x) for x in jro[:6]]),
                                    torch.tensor(np.asarray(jlast)), **extra)
    env.host_pool.close()
    # round_fn in host-rollout mode, and the host rollout plus
    # update_from_rollout called by hand, from the same weights, draws and
    # generator state
    by_round, by_hand = [build_training(_args(Config, agent_class, make_host_env(
        _pendulum, EnvSpec('Pendulum-v1', N, 200, 3, 1, False), seed=5), device='cpu',
        reward_scale=0.5)) for _ in range(2)]
    rc, rm = by_round.round_fn(by_round.carry, noise=z)
    hro, hlast = host_collect_rollout(by_hand.env.host_pool, by_hand.agent,
                                      by_hand.carry.agent_state, by_hand.carry.obs.numpy(), None,
                                      H, 0.5, torch.device('cpu'), noise=z)
    hc, hm = by_hand.update_from_rollout(by_hand.carry, hro, torch.from_numpy(hlast))
    return dict(jro=jro, jlast=jlast, ro=ro, last=last, jc2=jc2, jm=jm, c2=c2, m=m, ctx=ctx,
                kind=request.param, round_fn=(rc, rm, hc, hm, hlast))


def test_host_rollout_matches_jax(host_round):
    jro, ro = host_round['jro'], host_round['ro']
    for f in ('states', 'actions', 'logprobs', 'rewards', 'undones', 'unmasks'):
        want = getattr(jro, f)
        if want is None:
            assert getattr(ro, f) is None
            continue
        np.testing.assert_allclose(getattr(ro, f).numpy(), want, rtol=0, atol=1e-5, err_msg=f)
    np.testing.assert_allclose(host_round['last'], host_round['jlast'], rtol=0, atol=1e-5)


def test_host_round_matches_jax(host_round):
    ctx, c2, jc2 = host_round['ctx'], host_round['c2'], host_round['jc2']
    got = jax.tree.leaves(ctx.agent.state_to_numpy(c2.agent_state))
    want = jax.tree.leaves(_np(jc2.agent_state))
    assert len(got) == len(want)
    for x, y in zip(got, want):
        np.testing.assert_allclose(np.asarray(x, np.float64), np.asarray(y, np.float64),
                                   rtol=0, atol=1e-5)
    for k in ('obj_critic', 'obj_actor'):
        np.testing.assert_allclose(float(host_round['m'][k]), float(host_round['jm'][k]),
                                   rtol=1e-4, atol=1e-5)
    # round_fn is that host round: bitwise what the two steps give by hand,
    # its carry's obs the pool's last obs
    rc, rm, hc, hm, hlast = host_round['round_fn']
    np.testing.assert_array_equal(rc.obs.numpy(), hlast)
    for x, y in zip(jax.tree.leaves(ctx.agent.state_to_numpy(rc.agent_state)),
                    jax.tree.leaves(ctx.agent.state_to_numpy(hc.agent_state))):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for k in ('obj_critic', 'obj_actor', 'exp_r'):
        assert float(rm[k]) == float(hm[k]), k


def test_host_eval_matches_jax():
    """Greedy episodes on the host path (a pool of one seed on each side,
    the same weights): the same returns and lengths."""
    spec = EnvSpec('Pendulum-v1', N, 200, 3, 1, False)
    jspec = JEnvSpec('Pendulum-v1', N, 200, 3, 1, False)
    jctx = jbuild_training(_args(JConfig, JAgentPPO, jmake_host_env(_pendulum, jspec, seed=5)))
    ctx = build_training(_args(Config, AgentPPO, make_host_env(_pendulum, spec, seed=5),
                               device='cpu'))
    env = make_host_env(_pendulum, spec, seed=11)
    jenv = jmake_host_env(_pendulum, jspec, seed=11)
    fn = make_eval_fn(env, ctx.agent.greedy_action, 2, 200, torch.device('cpu'))
    jfn = jmake_eval_fn(jenv, jctx.agent.greedy_action, 2, 200)
    assert fn.__name__ == jfn.__name__ == 'eval_fn_host'
    state = ctx.agent.state_from_numpy(_np(jctx.carry.agent_state), 'cpu')
    ret, steps = fn(state, None)
    jret, jsteps = jfn(jctx.carry.agent_state, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(steps, jsteps)
    np.testing.assert_allclose(ret, jret, rtol=1e-5, atol=1e-3)


def test_host_rollout_flag_disables_host_eval(tmp_path):
    spec = EnvSpec('Pendulum-v1', N, 200, 3, 1, False)
    env = make_host_env(_pendulum, spec)
    fn = make_eval_fn(env, lambda s, o: torch.zeros((o.shape[0], 1)), 2, 4,
                      torch.device('cpu'), host_eval=False)
    assert fn.__name__ != 'eval_fn_host'
    a = _args(Config, AgentPPO, env, device='cpu', net_dims=(16,), batch_size=32,
              eval_per_step=64, eval_times=2, break_step=128, host_rollout=False,
              cwd=str(tmp_path / 'no_host'))
    assert not build_training(a).use_host_rollout
    r = train_agent(a)
    assert r['total_step'] >= 128 and np.isfinite(r['recorder'][:, 1]).all()


def test_host_rollout_resume_repoints_obs(tmp_path):
    """continue_train with a host pool keeps the restored agent, but points
    obs at the freshly reset pool's episodes, not the checkpointed ones."""
    spec = EnvSpec('Pendulum-v1', N, 200, 3, 1, False)

    def args():
        return _args(Config, AgentPPO, make_host_env(_pendulum, spec), device='cpu',
                     batch_size=32, eval_per_step=64, eval_times=2, break_step=64,
                     cwd=str(tmp_path / 'resume'), if_remove=False)

    r = train_agent(args())
    assert r['total_step'] >= 64 and np.isfinite(r['recorder'][:, 1]).all()
    a2 = args()
    a2.continue_train = True
    ctx = build_training(a2)
    fresh = _HostPool(_pendulum, 0).reset_all(N)
    np.testing.assert_array_equal(ctx.carry.obs.numpy(), fresh)
    saved = ctx.agent.state_to_numpy(r['agent_state'])
    for x, y in zip(jax.tree.leaves(ctx.agent.state_to_numpy(ctx.carry.agent_state)),
                    jax.tree.leaves(saved)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
