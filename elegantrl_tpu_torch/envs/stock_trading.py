"""Stock-trading env as batched tensors (counterpart of
``elegantrl_tpu/envs/stock_trading.py``): daily trading over S stocks with
integer share lots, a transaction cost, a cash constraint and a
delta-total-asset reward.

- actions in [-1, 1] per stock, dead zone |a| < 0.1, scaled by
  ``max_stock`` and truncated to integer lots;
- stocks traded one after another, so buys compete for the same cash: a
  loop over the stock axis carrying the cash, over all envs at once;
- reward = (total_asset_t - total_asset_{t-1}) * 2^-12; at the terminal
  step a bonus ``mean(episode rewards) / (1 - gamma)`` is added and
  ``cumulative_returns = total_asset / initial_amount * 100`` is recorded;
- the random reset jitters the cash by U[0.75, 1.25) and holds
  ``floor(|clip(N(0, 1), -2, 2)| * 2^7)`` shares (the env's ``init``; the
  kernel body's reset floors before scaling, ``floor(|z|) * 2^7``, as the
  JAX package's two do).

``total_asset`` is summed in one fixed order, ``sum_k price_k * shares_k``
stock by stock and then the cash (:func:`total_asset`): totals sit near
1e6, where one float32 ulp is 0.0625, and the kernel body
(``ops/fused_rollout.py:make_stock_body``, ``csrc/fused_rollout.cu``
``StockBody``) sums in the same order.

Market data: ``China_A_shares.numpy.npz`` when present, otherwise a
deterministic synthetic market of the same shape (1113 days x 15 stocks, 8
technical factors per stock).  Nothing is downloaded.  The tables are
numpy arrays; :class:`MarketTables` puts one copy on each device that asks
for it, so the env runs wherever its state lives.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .base import EnvDef, EnvSpec, VecEnv

_NPZ_CANDIDATES = (
    './China_A_shares.numpy.npz',
    './elegantrl_tpu/envs/China_A_shares.numpy.npz',
)
_SYN_DAYS = 1113
_SYN_STOCKS = 15
_SYN_TECHS_PER_STOCK = 8


def load_market_data(npz_path: Optional[str] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Return (close, tech) float32 arrays of shape (T, S) and (T, 8*S)."""
    paths = (npz_path,) if npz_path else _NPZ_CANDIDATES
    for p in paths:
        if p and os.path.exists(p):
            d = np.load(p, allow_pickle=True)
            return (np.asarray(d['close_ary'], np.float32),
                    np.asarray(d['tech_ary'], np.float32))
    return synthetic_market_data()


_TECH_ID_LIST = ["macd", "boll_ub", "boll_lb", "rsi_30", "cci_30", "dx_30",
                 "close_30_sma", "close_60_sma"]


def dataframe_to_arrays(df, tech_id_list=None) -> Tuple[np.ndarray, np.ndarray]:
    """A pandas frame with one row per (day, stock) -> (close, tech): per
    day the tech vector is tech-major ``[tech0_stock0..tech0_stockS,
    tech1_stock0, ...]`` and close is the per-stock close series."""
    tech_id_list = _TECH_ID_LIST if tech_id_list is None else tech_id_list
    close_ary, tech_ary = [], []
    for day in range(len(df.index.unique())):
        item = df.loc[day]
        tech_items = [item[tech].values.tolist() for tech in tech_id_list]
        tech_ary.append(sum(tech_items, []))
        close_ary.append(item.close)
    return (np.array(close_ary, np.float32), np.array(tech_ary, np.float32))


def synthetic_market_data(days: int = _SYN_DAYS, stocks: int = _SYN_STOCKS,
                          seed: int = 1943) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic GBM market with moving-average and momentum technical
    factors, shaped like the reference dataset."""
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(5.0, 80.0, size=stocks)
    drift = rng.normal(3e-4, 2e-4, size=stocks)
    vol = rng.uniform(0.01, 0.03, size=stocks)
    log_ret = rng.normal(drift, vol, size=(days, stocks))
    close = p0 * np.exp(np.cumsum(log_ret, axis=0))
    close = close.astype(np.float32)

    def sma(x, w):
        c = np.cumsum(np.pad(x, ((w, 0), (0, 0)), mode='edge'), axis=0)
        return (c[w:] - c[:-w]) / w

    sma12, sma26 = sma(close, 12), sma(close, 26)
    sma30, sma60 = sma(close, 30), sma(close, 60)
    macd = sma12 - sma26
    mom = np.diff(close, axis=0, prepend=close[:1])
    std30_num = sma(np.square(close), 30) - np.square(sma30)
    std30 = np.sqrt(np.maximum(std30_num, 0.0))
    boll_ub = sma30 + 2 * std30
    boll_lb = sma30 - 2 * std30
    rsi = 50.0 + 50.0 * np.tanh(sma(mom, 30) / (std30 + 1e-6))
    cci = (close - sma30) / (0.015 * (std30 + 1e-6))
    techs = np.stack([macd, boll_ub, boll_lb, rsi, np.clip(cci, -300, 300),
                      np.abs(np.tanh(mom)) * 100, sma30, sma60], axis=2)
    tech = techs.reshape(days, stocks * _SYN_TECHS_PER_STOCK).astype(np.float32)
    return close, tech


class MarketTables:
    """The (close (T, S), tech (T, 8S)) tables, with one tensor copy per
    device that asks (:meth:`on`)."""

    def __init__(self, close: np.ndarray, tech: np.ndarray):
        self.close = np.ascontiguousarray(close, np.float32)
        self.tech = np.ascontiguousarray(tech, np.float32)
        self._copies = {}

    @property
    def nbytes(self) -> int:
        return self.close.nbytes + self.tech.nbytes

    def on(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        dev = torch.device(device)
        if dev.type == 'cuda' and dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
        if dev not in self._copies:
            self._copies[dev] = (torch.from_numpy(self.close).to(dev),
                                 torch.from_numpy(self.tech).to(dev))
        return self._copies[dev]


class StockState(NamedTuple):
    day: torch.Tensor                 # (N,) int32
    amount: torch.Tensor              # (N,) cash
    shares: torch.Tensor              # (N, S)
    total_asset: torch.Tensor         # (N,)
    reward_sum: torch.Tensor          # (N,) running sum of the episode's rewards
    cumulative_returns: torch.Tensor  # (N,) recorded at the terminal step


def total_asset(prices: torch.Tensor, shares: torch.Tensor, amount: torch.Tensor):
    """``sum_k prices[k] * shares[k] + amount`` over the leading (stock) axis,
    stock by stock in order, then the cash."""
    total = prices[0] * shares[0]
    for k in range(1, shares.shape[0]):
        total = total + prices[k] * shares[k]
    return total + amount


def trade(amount: torch.Tensor, shares: torch.Tensor, a_int: torch.Tensor,
          prices: torch.Tensor, cost_pct: float):
    """The sequential cash-constrained trades on ``(S, N)`` rows (``prices``
    broadcasts against them): stock k buys ``min(floor(cash / price),
    a_k)`` lots when ``a_k > 0`` and otherwise sells ``clip(-a_k, 0,
    shares_k)``, then the cash moves by the price with a cost of
    ``cost_pct`` both ways.  Returns (cash, shares)."""
    buy_cost, sell_cost = 1.0 + cost_pct, 1.0 - cost_pct
    rows = []
    for k in range(shares.shape[0]):
        price, a_k, share_k = prices[k], a_int[k], shares[k]
        can_buy = torch.floor(amount / price)
        buy = torch.where(a_k > 0, torch.minimum(can_buy, a_k), torch.zeros_like(a_k))
        sell = torch.where(a_k > 0, torch.zeros_like(a_k),
                           torch.minimum(torch.clamp(-a_k, min=0.0), share_k))
        amount = amount - price * buy * buy_cost + price * sell * sell_cost
        rows.append(share_k + buy - sell)
    return amount, torch.stack(rows)


def action_lots(action: torch.Tensor, max_stock: float) -> torch.Tensor:
    """Dead zone |a| < 0.1, then ``trunc(a * max_stock)``."""
    a = torch.where(torch.abs(action) < 0.1, torch.zeros_like(action), action)
    return torch.trunc(a * max_stock)


def make_stock_trading(initial_amount: float = 1e6, max_stock: float = 1e2,
                       cost_pct: float = 1e-3, gamma: float = 0.99,
                       beg_idx: int = 0, end_idx: int = 1113,
                       if_random_reset: bool = True,
                       npz_path: Optional[str] = None) -> EnvDef:
    close_np, tech_np = load_market_data(npz_path)
    tables = MarketTables(close_np[beg_idx:end_idx], tech_np[beg_idx:end_idx])
    num_shares = tables.close.shape[1]
    max_step = tables.close.shape[0] - 1
    reward_scale = 2 ** -12
    state_dim = 1 + num_shares + num_shares + tables.tech.shape[1]

    def init(gen: torch.Generator, num_envs: int, device) -> StockState:
        close, _ = tables.on(device)
        if if_random_reset:
            amount = initial_amount * (torch.rand(num_envs, generator=gen, device=device)
                                       * 0.5 + 0.75)
            z = torch.randn((num_envs, num_shares), generator=gen, device=device)
            shares = torch.floor(torch.abs(torch.clamp(z, -2.0, 2.0)) * 2 ** 7)
        else:
            amount = torch.full((num_envs,), initial_amount, device=device)
            shares = torch.zeros((num_envs, num_shares), device=device)
        zero = torch.zeros(num_envs, device=device)
        return StockState(torch.zeros(num_envs, dtype=torch.int32, device=device), amount,
                          shares, total_asset(close[0][:, None], shares.T, amount), zero, zero)

    def obs(s: StockState) -> torch.Tensor:
        close, tech = tables.on(s.amount.device)
        day = torch.clamp(s.day.long(), max=max_step)    # as JAX's gather clamps
        return torch.cat([torch.tanh(s.amount * 2 ** -18)[:, None],
                          torch.tanh(s.shares * 2 ** -10),
                          close[day] * 2 ** -7,
                          tech[day] * 2 ** -6], dim=1)

    def step(s: StockState, action: torch.Tensor, gen=None):
        close, _ = tables.on(s.amount.device)
        day = s.day + 1
        # past the last day (a frozen episode of an evaluation longer than the
        # table) the prices stay the last day's, as JAX's gather clamps
        prices = close[torch.clamp(day.long(), max=max_step)].T     # (S, N)
        amount, shares = trade(s.amount, s.shares.T, action_lots(action, max_stock).T,
                               prices, cost_pct)
        total = total_asset(prices, shares, amount)
        reward = (total - s.total_asset) * reward_scale
        reward_sum = s.reward_sum + reward
        terminal = day >= max_step
        bonus = (reward_sum / day.float()) / (1.0 - gamma)
        reward = torch.where(terminal, reward + bonus, reward)
        cum_returns = torch.where(terminal, total / initial_amount * 100.0,
                                  s.cumulative_returns)
        return (StockState(day, amount, shares.T, total, reward_sum, cum_returns),
                reward, terminal, torch.zeros_like(terminal))

    spec = EnvSpec(env_name='StockTradingEnv-v2', num_envs=1, max_step=max_step,
                   state_dim=state_dim, action_dim=num_shares, if_discrete=False)
    from ..ops.fused_rollout import make_stock_body
    body = make_stock_body(tables, initial_amount=initial_amount, max_stock=max_stock,
                           cost_pct=cost_pct, gamma=gamma, if_random_reset=if_random_reset)
    return EnvDef(spec=spec, init=init, obs=obs, step=step,
                  episode_return=lambda s: s.cumulative_returns, kernel_body=body)


class StockTradingVecEnv(VecEnv):
    def __init__(self, initial_amount: float = 1e6, max_stock: float = 1e2,
                 cost_pct: float = 1e-3, gamma: float = 0.99,
                 beg_idx: int = 0, end_idx: int = 1113, num_envs: int = 4,
                 if_random_reset: bool = True, seed: int = 0, device: str = None,
                 **_kwargs):
        super().__init__(
            make_stock_trading(initial_amount, max_stock, cost_pct, gamma,
                               beg_idx, end_idx, if_random_reset),
            num_envs=num_envs, seed=seed, device=device)

    @property
    def cumulative_returns(self):
        if self._state is None:
            return 0.0
        return self._state.cumulative_returns.cpu().numpy().tolist()


class StockTradingEnv(StockTradingVecEnv):
    def __init__(self, **kwargs):
        kwargs.setdefault('num_envs', 1)
        super().__init__(**kwargs)


class StockTradingVmapEnv(StockTradingVecEnv):
    """Name alias for the reference's helloworld ``StockTradingVmapEnv``."""
