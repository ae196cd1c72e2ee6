"""The stock body of the port's fused rollouts (``elegantrl_tpu_torch/ops/
fused_rollout.py:make_stock_body``, the plain version of the CUDA
``StockBody``) against the JAX package's (``elegantrl_tpu/ops/
pallas_rollout.py:make_stock_body``): the body alone, the on-policy rollout
and the ddpg, sac and modsac off-policy rollouts against the Pallas kernels
in interpret mode, with the same weights (through numpy) and the noise the
JAX wrappers draw from their key (``kz, ku = split(key)``: normals ``(H, A,
N)``, then the reset's uniforms ``(H, 17, N)``), handed to the port as
injected noise; then the reset's draws, statistically.

8 envs, 8 steps, nets (16, 16), a market cut to 10 days (``end_idx``) so
that the horizon crosses the terminal day (bonus, ``cumulative_returns``)
and a reset (the in-body Box-Muller).

Tolerances: log-probabilities, values and actions 1e-4 (f32 sums in another
order over 8 steps); rewards 1e-4 absolute and relative (deltas of totals
near 1e6 scaled by 2^-12, so one ulp of a total is up to 3.05e-5 of a
reward, and the terminal bonus, the mean reward over (1 - gamma), carries the
episode's reward sum times 1 / (d (1 - gamma)) = 20 at d = 5); stored states
1e-5 (the market rows are table rows times powers of two, exactly equal);
final env rows rtol 1e-5 / atol 1e-3 (cash and totals near 1e6); integer
lots, days and flags exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu.agents.ddpg_td3 import _make as jmake_ddpg_td3
from elegantrl_tpu.agents.ppo import make_ppo as jmake_ppo
from elegantrl_tpu.agents.sac import make_sac as jmake_sac
from elegantrl_tpu.config import Config as JConfig
from elegantrl_tpu.envs.stock_trading import make_stock_trading as jmake_stock
from elegantrl_tpu.ops import pallas_rollout as jpr
from elegantrl_tpu_torch.envs import stock_trading as st
from elegantrl_tpu_torch.ops import fused_rollout as fr
from elegantrl_tpu_torch.utils.jax_params import (ddpg_state_from_numpy, env_state_from_numpy,
                                                  ppo_state_from_numpy, sac_state_from_numpy)

torch.set_num_threads(1)
NET_DIMS = (16, 16)
H, N, END = 8, 8, 10
S, A = 151, 15


def _envs():
    jenv = jmake_stock(end_idx=END)
    env = st.make_stock_trading(end_idx=END)
    jstate = jax.jit(jax.vmap(jenv.init))(jax.random.split(jax.random.PRNGKey(9), N))
    jstate = jstate._replace(day=jnp.full((N,), 4, jnp.int32))   # 5 steps to the last day
    state = env_state_from_numpy(st.StockState, jax.tree.map(np.asarray, jstate), 'cpu')
    return jenv, env, jstate, state


def _noise(key):
    kz, ku = jax.random.split(key)
    return jnp.concatenate([jax.random.normal(kz, (H, A, N), jnp.float32),
                            jax.random.uniform(ku, (H, 17, N), jnp.float32)], axis=1)


def _check_rows(f, i, jf, ji):
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji).reshape(i.shape))
    np.testing.assert_array_equal(f[1:1 + A].numpy(), np.asarray(jf)[1:1 + A])   # lots
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-5, atol=1e-3)


def test_body_matches_jax_body():
    """obs, step (from a state two steps before the last day, then at it:
    bonus, ``cumulative_returns``, the day wrap) and the masked reset."""
    jenv, env, jstate, state = _envs()
    jbody, body = jenv.kernel_body, env.kernel_body
    assert (body.n_f32, body.n_reset, body.n_step) == (jbody.n_f32, jbody.n_reset, 0)
    fetch = lambda ti, day: jax.lax.dynamic_slice_in_dim(jbody.tables[ti], day, 1, axis=0)  # noqa
    jobs = jax.jit(lambda f, i: jbody.obs(f, i, (i[0, 0],), fetch))
    jstep = jax.jit(lambda f, i, a: jbody.step(f, i, a, jnp.zeros((0, N)), (i[0, 0],), fetch))
    jreset = jax.jit(lambda f, i, u, done: jbody.reset(f, i, u, done, fetch))
    jf, ji = jbody.pack(jstate)
    f, i = body.pack(state)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_allclose(body.obs(f, i).numpy(),
                               np.asarray(jobs(jf, ji)), atol=1e-7)
    rng = np.random.default_rng(2)
    for d in (END - 3, END - 2):   # an ordinary step, then the terminal one
        ji = jnp.full_like(ji, d)
        i = torch.full_like(i, d)
        a = rng.uniform(-0.99, 0.99, (A, N)).astype(np.float32)
        jout = jstep(jf, ji, jnp.asarray(a))
        out = body.step(f, i, torch.from_numpy(a), torch.zeros((0, N)))
        _check_rows(out[0], out[1], jout[0], jout[1])
        ulp = float(np.spacing(np.abs(np.asarray(jout[0])[1 + A]).max())) * 2.0 ** -12
        np.testing.assert_allclose(out[2].numpy(), np.asarray(jout[2]), rtol=1e-5, atol=ulp)
        np.testing.assert_array_equal(out[3].numpy(), np.asarray(jout[3]))
        # the next step's day: the block's first lane after the masked reset
        day = fr.block_day(body.reset(out[0], out[1], torch.zeros((17, N)), out[3] | out[4])[1])
        assert int(day[0]) == int(jout[5][0])
    assert bool(out[3].all()) and int(day[0]) == 0
    u = rng.uniform(0, 1, (17, N)).astype(np.float32)
    done = np.arange(N)[None] % 2 == 0
    jr = jreset(jout[0], jout[1], jnp.asarray(u), jnp.asarray(done))
    r = body.reset(out[0], out[1], torch.from_numpy(u), torch.from_numpy(done))
    _check_rows(r[0], r[1], jr[0], jr[1])


@pytest.fixture(scope='module')
def onpolicy():
    jenv, env, jstate, state = _envs()
    args = JConfig()
    args.net_dims = NET_DIMS
    js = jmake_ppo(NET_DIMS, S, A, args).init(jax.random.PRNGKey(0))
    js = js._replace(norm_avg=jnp.linspace(-0.1, 0.1, S), norm_std=jnp.linspace(0.8, 1.2, S))
    fast = jpr.make_fused_rollout(jenv.kernel_body, NET_DIMS, H, N, 0.5, discrete=False,
                                  block=8, interpret=True)
    key = jax.random.PRNGKey(3)
    jro, jstate2, jobs2 = jax.jit(fast)(js, jstate, jax.vmap(jenv.obs)(jstate), key)
    ps = ppo_state_from_numpy(jax.tree.map(np.asarray, js), 'cpu')
    ro, state2, obs2 = fr.make_fused_rollout(env.kernel_body, NET_DIMS, H, N, 0.5)(
        ps, state, None, noise=torch.tensor(np.asarray(_noise(key))))
    return jax.tree.map(np.asarray, (jro, jstate2, jobs2)), (ro, state2, obs2), ps, env


def test_onpolicy_rollout_matches(onpolicy):
    (jro, jstate2, jobs2), (ro, state2, obs2), _, env = onpolicy
    assert ro.extras['tsn'] and ro.states.shape == (H, S, N)
    for name, tol in (('states', 1e-5), ('actions', 1e-4), ('logprobs', 1e-4)):
        np.testing.assert_allclose(getattr(ro, name).numpy(), getattr(jro, name), rtol=0,
                                   atol=tol, err_msg=name)
    np.testing.assert_allclose(ro.rewards.numpy(), jro.rewards, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ro.extras['values'].numpy(), jro.extras['values'], atol=1e-4)
    np.testing.assert_array_equal(ro.undones.numpy(), jro.undones)
    assert float((1 - ro.undones).sum()) == N            # every lane ends its episode once
    close, tech = env.kernel_body.tables.close, env.kernel_body.tables.tech
    days = (4 + np.arange(H)) % (END - 1)                 # the shared day, wrapped at the end
    np.testing.assert_array_equal(ro.states[:, 16:31].numpy(),
                                  np.repeat(close[days][:, :, None] * 2 ** -7, N, 2))
    np.testing.assert_array_equal(ro.states[:, 31:].numpy(),
                                  np.repeat(tech[days][:, :, None] * 2 ** -6, N, 2))
    _check_rows(*env.kernel_body.pack(state2), *jpr_pack(jstate2))
    np.testing.assert_allclose(obs2.numpy(), jobs2, rtol=1e-5, atol=1e-5)


def jpr_pack(jstate):
    f = np.concatenate([jstate.amount[None], jstate.shares.T, jstate.total_asset[None],
                        jstate.reward_sum[None], jstate.cumulative_returns[None]])
    return torch.from_numpy(f), torch.from_numpy(np.array(jstate.day[None]))


def test_critic_pass_is_the_in_loop_critic(onpolicy):
    """The plain critic pass over the stored states gives the rollout's
    values: the CUDA route runs the critic as this second pass."""
    _, (ro, _, _), ps, _ = onpolicy
    v = fr.critic_values(ps.cri_flat, ps.norm_avg, ps.norm_std, ro.states, net_dims=NET_DIMS)
    torch.testing.assert_close(v, ro.extras['values'], rtol=0, atol=1e-6)


@pytest.mark.parametrize('head', ['ddpg', 'sac', 'modsac'])
def test_offpolicy_rollout_matches(head):
    jenv, env, jstate, state = _envs()
    args = JConfig()
    if head == 'ddpg':
        js = jmake_ddpg_td3(NET_DIMS, S, A, args, None, td3=True).init(jax.random.PRNGKey(1))
        flat = ddpg_state_from_numpy(jax.tree.map(np.asarray, js), 'cpu').act
    else:
        js = jmake_sac(NET_DIMS, S, A, args, None, modsac=head == 'modsac').init(
            jax.random.PRNGKey(1))
        flat = sac_state_from_numpy(jax.tree.map(np.asarray, js), 'cpu', head == 'modsac').act
    std_clip = (-20.0, 2.0) if head == 'modsac' else (-16.0, 2.0)
    fast = jpr.make_fused_offpolicy_rollout(
        jenv.kernel_body, NET_DIMS, H, N, 0.5, head=head,
        head_cfg={'noise_std': 0.1, 'explore_rate': 0.25, 'std_clip': std_clip}, block=8,
        interpret=True)
    key = jax.random.PRNGKey(4)
    jro, jstate2, _ = jax.jit(fast)(js, jstate, jax.vmap(jenv.obs)(jstate), key)
    f0, i0 = env.kernel_body.pack(state)
    got = fr.offpolicy_rollout(flat, f0, i0, body=env.kernel_body, head=head,
                               net_dims=NET_DIMS, horizon_len=H, reward_scale=0.5,
                               noise_std=0.1, std_clip=std_clip,
                               noise=torch.tensor(np.asarray(_noise(key))))
    jro = jax.tree.map(np.asarray, jro)
    np.testing.assert_allclose(got.states.numpy(), jro.states, atol=1e-5)
    np.testing.assert_allclose(got.actions.numpy(), jro.actions, atol=1e-4)
    np.testing.assert_allclose(got.rewards.numpy(), jro.rewards, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(1.0 - got.terminals.numpy(), jro.undones)
    assert float(got.terminals.sum()) == N
    _check_rows(got.env_f, got.env_i, *jpr_pack(jax.tree.map(np.asarray, jstate2)))


def test_reset_draws():
    """The reset's cash is U[0.75, 1.25) x 1e6 and its lots are
    floor(|clip(z, -2, 2)|) x 128 for z ~ N(0, 1): 0, 128 and 256 lots with
    the probabilities of |z| < 1, 1 <= |z| < 2 and |z| >= 2 (0.6827, 0.2718,
    0.0455), within 0.005 over 15 x 16,384 draws (three standard errors are
    0.003), from the kernel's Philox uniforms."""
    body = st.make_stock_trading().kernel_body
    n = 16384
    u = fr.philox_uniforms(torch.tensor([5, -3], dtype=torch.int32), 1, n, 17)[0]
    f = torch.zeros((body.n_f32, n))
    i = torch.full((1, n), 7, dtype=torch.int32)
    f2, i2 = body.reset(f, i, u, torch.ones((1, n), dtype=torch.bool))
    cash, lots = f2[0], f2[1:1 + A] / 128
    assert bool((i2 == 0).all()) and float(cash.min()) >= 7.5e5 and float(cash.max()) < 1.25e6
    assert abs(float(cash.mean()) - 1e6) < 5e3
    freq = torch.stack([(lots == k).float().mean() for k in range(3)])
    assert float((freq - torch.tensor([0.6827, 0.2718, 0.0455])).abs().max()) < 0.005, freq
    assert float(freq.sum()) == 1.0
    total = st.total_asset(torch.from_numpy(body.tables.close[0])[:, None], f2[1:1 + A], cash)
    torch.testing.assert_close(f2[1 + A], total, rtol=0, atol=0)


def test_stock_kernel_fits_the_recipes_widths():
    """The stock body at the recipes' (128, 128): the actor kernel's largest
    layout (one block a lane group) and the critic pass each fit a block,
    and a cluster of c blocks holds 1/c of W2 (64 of its rows at c = 2).  At
    (256, 256) the actor takes a cluster of 2 or more and the critic pass
    streams W2, so both fit; past (448, 448) the actor's slices do not, and
    the streamed design (W2 read from device memory) takes the stock body to
    (1184, 1184) in float32 on 32-lane groups, and past that on groups of
    16 lanes and fewer, to (2624, 2624), where the critic pass's 16-sample
    tiles stop."""
    body = st.StockTradingVecEnv(num_envs=1)._def.kernel_body
    S, A = body.state_dim, body.action_dim
    assert fr.rollout_fits(body, (128, 128))
    sizes = [fr.actor_smem_bytes(S, (128, 128), A, c) for c in (1, 2, 4, 8)]
    assert sizes[0] <= fr.SMEM_LIMIT and sizes == sorted(sizes, reverse=True)
    assert sizes[0] - sizes[1] > 4 * 128 * 64     # W2's rows halve
    assert not fr.rollout_fits_resident(body, (1024, 1024))
    wide = [fr.actor_smem_bytes(S, (256, 256), A, c) for c in (1, 2, 4, 8)]
    assert wide[0] > fr.SMEM_LIMIT >= min(wide) and fr.rollout_fits_resident(body, (256, 256))
    assert fr.critic_smem_bytes((256, 256)) <= fr.SMEM_LIMIT
    assert (fr.rollout_fits_resident(body, (448, 448))
            and not fr.rollout_fits_resident(body, (452, 452)))
    assert fr.rollout_fits(body, (452, 452)) and fr.rollout_fits(body, (1024, 1024))
    assert fr.rollout_fits(body, (1184, 1184)) and fr.rollout_fits(body, (1188, 1188))
    assert [fr.rollout_group_lanes(body, (d, d)) for d in (1184, 1188, 1280)] == [32, 16, 16]
    assert fr.rollout_fits(body, (2624, 2624)) and not fr.rollout_fits(body, (2628, 2628))
    assert fr.critic_tile((1408, 1408)) == 32 and fr.critic_tile((1412, 1412)) == 16


def test_other_stock_count_is_refused_on_a_card_with_the_reason(tmp_path):
    """The CUDA stock body is built for 15 stocks: a market of another
    width runs the plain body on the CPU and is refused on a card, saying
    why (the decision is made before anything launches)."""
    from elegantrl_tpu_torch import Config
    from elegantrl_tpu_torch.agents import AgentPPO
    from elegantrl_tpu_torch.train import runner
    rng = np.random.default_rng(0)
    path = str(tmp_path / 'market.npz')
    np.savez(path, close_ary=rng.uniform(5, 50, (30, 4)).astype(np.float32),
             tech_ary=rng.normal(size=(30, 32)).astype(np.float32))
    args = Config(AgentPPO, st.make_stock_trading(npz_path=path, end_idx=30),
                  {'env_name': 'StockTradingEnv-v2', 'num_envs': 32, 'max_step': 29,
                   'state_dim': 41, 'action_dim': 4, 'if_discrete': False})
    args.net_dims, args.horizon_len, args.batch_size = (16, 16), 16, 128
    env = runner._resolve_env_def(args)
    assert env.kernel_body.action_dim == 4 and not fr.rollout_fits(env.kernel_body, (16, 16))
    agent = runner._make_agent(args, None)
    args.device = 'cuda'
    with pytest.raises(ValueError, match='built for 15 stocks; this market has 4'):
        runner._maybe_fused_rollout(args, env, agent, torch.device('cuda'), 32, 16, 1.0)
