"""The port's stock-trading env (``elegantrl_tpu_torch/envs/stock_trading.py``)
against the JAX package's (``elegantrl_tpu/envs/stock_trading.py``): the
market data bit for bit, then init/obs/step on the same states and numpy
actions.

Tolerances are the JAX package's own for its stock body against its env
(``tests/test_pallas_rollout.py:test_stock_body_step_parity``): float rows
rtol 1e-5 / atol 1e-3 (cash and totals near 1e6, where one f32 ulp is
0.0625); rewards to one ulp of the total times 2^-12 (:func:`_reward_atol`),
because the reward is the difference of two totals near 1e6 scaled by
2^-12, and the two packages sum the total in another order (the port stock
by stock, XLA by a reduction tree), which can move it by one ulp: 0.0625 *
2^-12 ~ 1.5e-5 below 2^20, the 2e-5 of the JAX test, and 0.125 * 2^-12 ~
3.05e-5 for a total above 2^20 = 1,048,576, which a random reset's cash of
up to 1.25e6 reaches.  Integer lots, days and flags are compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import torch

from elegantrl_tpu.envs import stock_trading as jst
from elegantrl_tpu_torch.envs import StockTradingVecEnv, vec_step
from elegantrl_tpu_torch.envs import stock_trading as st
from elegantrl_tpu_torch.utils.jax_params import env_state_from_numpy

torch.set_num_threads(1)
N = 8


def _states(end_idx=1113, steps=3, seed=1):
    """The JAX env's state after ``steps`` random steps, and its copy as the
    port's state."""
    jenv = jst.make_stock_trading(end_idx=end_idx)
    state = jax.jit(jax.vmap(jenv.init))(jax.random.split(jax.random.PRNGKey(seed), N))
    step = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        a = rng.uniform(-1, 1, (N, jenv.spec.action_dim)).astype(np.float32)
        state, _, _, _ = step(state, jnp.asarray(a), jax.random.split(jax.random.PRNGKey(0), N))
    return jenv, step, state, env_state_from_numpy(st.StockState, state, 'cpu')


def _reward_atol(js):
    """One f32 ulp of the largest total, times the reward scale 2^-12."""
    return float(np.spacing(np.abs(np.asarray(js.total_asset)).max())) * 2.0 ** -12


def _assert_state_close(s, js):
    np.testing.assert_array_equal(s.day.numpy(), np.asarray(js.day))
    np.testing.assert_array_equal(s.shares.numpy(), np.asarray(js.shares))   # integer lots
    for name in ('amount', 'total_asset', 'reward_sum', 'cumulative_returns'):
        np.testing.assert_allclose(getattr(s, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=1e-5, atol=1e-3, err_msg=name)


def test_synthetic_market_matches():
    close, tech = st.synthetic_market_data()
    jclose, jtech = jst.synthetic_market_data()
    assert close.shape == (1113, 15) and tech.shape == (1113, 120)
    np.testing.assert_array_equal(close, jclose)
    np.testing.assert_array_equal(tech, jtech)


def test_npz_loads_the_same(tmp_path):
    rng = np.random.default_rng(3)
    close = rng.uniform(5, 50, (40, 4)).astype(np.float32)
    tech = rng.normal(size=(40, 32)).astype(np.float32)
    path = str(tmp_path / 'market.npz')
    np.savez(path, close_ary=close, tech_ary=tech)
    for a, b in zip(st.load_market_data(path), jst.load_market_data(path)):
        np.testing.assert_array_equal(a, b)
    env = st.make_stock_trading(npz_path=path, end_idx=40)
    assert env.spec.state_dim == 1 + 4 + 4 + 32 and env.spec.max_step == 39
    assert env.kernel_body.action_dim == 4


def test_dataframe_to_arrays_matches():
    rng = np.random.default_rng(4)
    days, stocks = 5, 3
    rows = [dict(day=d, tic=f's{k}', close=float(rng.uniform(5, 50)),
                 **{t: float(rng.normal()) for t in st._TECH_ID_LIST})
            for d in range(days) for k in range(stocks)]
    df = pd.DataFrame(rows).set_index('day')
    df.index.name = None
    for a, b in zip(st.dataframe_to_arrays(df), jst.dataframe_to_arrays(df)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_obs_and_steps_match():
    jenv, jstep, jstate, state = _states()
    env = st.make_stock_trading()
    np.testing.assert_allclose(env.obs(state).numpy(), np.asarray(jax.vmap(jenv.obs)(jstate)),
                               rtol=1e-6, atol=1e-7)
    rng = np.random.default_rng(5)
    for _ in range(4):   # each step from the JAX package's state, so one ulp apart
        a = rng.uniform(-1, 1, (N, 15)).astype(np.float32)
        state = env_state_from_numpy(st.StockState, jstate, 'cpu')
        jstate, jr, jt, jtr = jstep(jstate, jnp.asarray(a),
                                    jax.random.split(jax.random.PRNGKey(0), N))
        state, r, t, tr = env.step(state, torch.from_numpy(a))
        _assert_state_close(state, jstate)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-5,
                                   atol=_reward_atol(jstate))
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jtr))
    np.testing.assert_allclose(env.obs(state).numpy(), np.asarray(jax.vmap(jenv.obs)(jstate)),
                               rtol=1e-5, atol=1e-6)   # tanh of cash that agrees to 1e-5


def test_terminal_step_bonus_and_day_wrap():
    """At a short ``end_idx`` the last step pays the bonus mean-reward/(1 -
    gamma) and records ``cumulative_returns``; ``vec_step`` then resets the
    day to 0."""
    end_idx = 12
    jenv, jstep, jstate, _ = _states(end_idx=end_idx, steps=2)
    jstate = jstate._replace(day=jnp.full((N,), end_idx - 2, jnp.int32))
    state = env_state_from_numpy(st.StockState, jstate, 'cpu')
    env = st.make_stock_trading(end_idx=end_idx)
    a = np.random.default_rng(6).uniform(-1, 1, (N, 15)).astype(np.float32)
    js2, jr, jt, _ = jstep(jstate, jnp.asarray(a), jax.random.split(jax.random.PRNGKey(0), N))
    s2, r, t, _ = env.step(state, torch.from_numpy(a))
    assert bool(t.all()) and bool(np.asarray(jt).all())
    _assert_state_close(s2, js2)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-5, atol=_reward_atol(js2))
    delta = (s2.total_asset - state.total_asset) * 2.0 ** -12
    bonus = (s2.reward_sum / float(end_idx - 1)) / (1 - 0.99)
    np.testing.assert_allclose(r.numpy(), (delta + bonus).numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s2.cumulative_returns.numpy(),
                               s2.total_asset.numpy() / 1e6 * 100, rtol=1e-6)
    s3, *_ = vec_step(env, state, torch.from_numpy(a), torch.Generator().manual_seed(0))
    assert bool((s3.day == 0).all()) and bool((s3.reward_sum == 0).all())


def test_cash_constraint():
    """All-buy actions on little cash: the stocks buy in order while cash
    lasts, each at most floor(cash / price) lots, and cash never goes
    negative."""
    env = st.make_stock_trading(if_random_reset=False, initial_amount=2000.0)
    state = env.init(torch.Generator().manual_seed(0), N, 'cpu')
    state, _, _, _ = env.step(state, torch.ones((N, 15)))
    close = torch.from_numpy(env.kernel_body.tables.close)
    assert bool((state.amount >= 0).all())
    bought = state.shares[0]
    price = close[1]
    cash = torch.tensor(2000.0)
    for k in range(15):   # replay the loop: each buy is what the cash allowed
        want = min(float(torch.floor(cash / price[k])), 100.0)
        assert float(bought[k]) == want
        cash = cash - price[k] * want * 1.001
    assert float(bought.sum()) > 0 and float(bought[-1]) < 100


def test_vec_env_reports_cumulative_returns():
    """The property reads the state's per-env record, as the JAX package's:
    0 before a reset, then one value per env (0 until an episode ends)."""
    env = StockTradingVecEnv(num_envs=4, end_idx=6, device='cpu')
    jenv = jst.StockTradingVecEnv(num_envs=4, end_idx=6)
    assert env.cumulative_returns == jenv.cumulative_returns == 0.0
    env.reset()
    jenv.reset()
    for _ in range(2):
        env.step(torch.zeros((4, 15)))
        jenv.step(np.zeros((4, 15), np.float32))
    assert env.cumulative_returns == jenv.cumulative_returns == [0.0] * 4


def test_init_draws_like_jax():
    """The init's draws come from each package's own generator, so their
    values differ; their law does not: cash in [0.75, 1.25) x 1e6, shares
    floor(|clip(z, -2, 2)| x 128), integers in [0, 256] with mean ~99.4 and
    std ~71 (over 7,680 draws each mean's standard error is ~0.8; the two
    means within 6, about five standard errors of their difference), day
    and reward sum 0, and the total asset the holdings at day 0's close plus
    the cash."""
    n = 512
    env = st.make_stock_trading()
    s = env.init(torch.Generator().manual_seed(0), n, 'cpu')
    jenv = jst.make_stock_trading()
    js = jax.jit(jax.vmap(jenv.init))(jax.random.split(jax.random.PRNGKey(0), n))
    close0 = torch.from_numpy(env.kernel_body.tables.close[0])
    for amount, shares, total, day, rsum in (
            (s.amount, s.shares, s.total_asset, s.day, s.reward_sum),
            tuple(torch.from_numpy(np.array(getattr(js, k))) for k in
                  ('amount', 'shares', 'total_asset', 'day', 'reward_sum'))):
        assert float(amount.min()) >= 7.5e5 and float(amount.max()) < 1.25e6
        assert bool((shares == torch.floor(shares)).all())
        assert float(shares.min()) == 0.0 and float(shares.max()) == 256.0
        assert int(day.abs().sum()) == 0 and float(rsum.abs().sum()) == 0.0
        np.testing.assert_allclose(total.numpy(), (shares @ close0 + amount).numpy(), rtol=1e-6)
    assert abs(float(s.shares.mean()) - float(np.asarray(js.shares).mean())) < 6.0
    fixed = st.make_stock_trading(if_random_reset=False).init(torch.Generator(), 4, 'cpu')
    assert bool((fixed.amount == 1e6).all()) and bool((fixed.shares == 0).all())
