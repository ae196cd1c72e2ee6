"""PPO on the stock-trading vec env (FinRL China-A-shares style), on the card.

The PyTorch counterpart of ``examples/demo_FinRL_stock_trading.py``: train
on the first 834 trading days, evaluate on the held-out tail, report
``cumulative_returns``.  Uses the deterministic synthetic market when the
``China_A_shares.numpy.npz`` dataset is absent.

Run: python examples_torch/demo_FinRL_stock_trading.py
"""

from elegantrl_tpu_torch.config import Config
from elegantrl_tpu_torch.agents import AgentPPO
from elegantrl_tpu_torch.envs import StockTradingVecEnv
from elegantrl_tpu_torch.envs.stock_trading import make_stock_trading
from elegantrl_tpu_torch.train.runner import train_agent


def train_ppo_for_stock_trading(num_envs: int = 1024):
    train_def = make_stock_trading(beg_idx=0, end_idx=834)
    eval_def = make_stock_trading(beg_idx=834, end_idx=1113,
                                  if_random_reset=False)
    spec = train_def.spec
    env_args = {'env_name': spec.env_name, 'num_envs': num_envs,
                'max_step': spec.max_step, 'state_dim': spec.state_dim,
                'action_dim': spec.action_dim, 'if_discrete': False}
    args = Config(AgentPPO, train_def, env_args)
    args.eval_env_class = eval_def
    args.break_step = int(2e6)
    args.net_dims = (128, 128)
    args.gamma = 0.99
    args.horizon_len = 128
    args.batch_size = 1024
    args.repeat_times = 16
    args.learning_rate = 2e-4
    args.eval_times = 8
    args.eval_per_step = int(2e5)
    return train_agent(args)


if __name__ == '__main__':
    train_ppo_for_stock_trading()
