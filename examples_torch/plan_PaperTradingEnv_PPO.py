"""Paper trading a SERVED stock policy: the deployment recipe, on the card.

The PyTorch counterpart of ``examples/plan_PaperTradingEnv_PPO.py`` (train
on StockTradingEnv, then deploy the actor into a paper-trading loop; the
reference's deployment half needs the external ``finrl`` package plus
Alpaca API credentials, :12-16).  Here the whole loop is self-contained:

1. train PPO on the first 834 days of the market;
2. start a :class:`~elegantrl_tpu_torch.serve.PolicyServer` on the saved
   checkpoint: the process that owns the card serves the actor;
3. paper-trade the HELD-OUT tail (days 834-1113) by posting observations
   to the server over HTTP on localhost and executing its actions in the
   market sim: the client/server split a live Alpaca loop would use.

Run:  python examples_torch/plan_PaperTradingEnv_PPO.py [quick]
"""

import json
import os
import sys
import urllib.request

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import numpy as np                                          # noqa: E402
import torch                                                # noqa: E402

from elegantrl_tpu_torch.config import Config, resolve_device   # noqa: E402
from elegantrl_tpu_torch.agents import AgentPPO             # noqa: E402
from elegantrl_tpu_torch.envs.stock_trading import make_stock_trading  # noqa: E402
from elegantrl_tpu_torch.serve import PolicyServer          # noqa: E402
from elegantrl_tpu_torch.train.runner import train_agent    # noqa: E402

NET_DIMS = (128, 128)


def train(quick: bool) -> Config:
    train_def = make_stock_trading(beg_idx=0, end_idx=834)
    spec = train_def.spec
    env_args = {'env_name': spec.env_name, 'num_envs': 256 if quick else 1024,
                'max_step': spec.max_step, 'state_dim': spec.state_dim,
                'action_dim': spec.action_dim, 'if_discrete': False}
    args = Config(AgentPPO, train_def, env_args)
    args.net_dims = NET_DIMS
    args.gamma = 0.99
    args.horizon_len = 128
    args.batch_size = 1024
    args.repeat_times = 16
    args.learning_rate = 2e-4
    args.eval_times = 8
    args.eval_per_step = int(2e5)
    args.break_step = int(3e5) if quick else int(2e6)
    train_agent(args)
    return args


def paper_trade(args: Config) -> float:
    """The deploy loop: observations -> HTTP -> actions -> market.  The
    server and the market sim run on ``args.device``."""
    device = resolve_device(args)
    srv = PolicyServer(AgentPPO, net_dims=NET_DIMS,
                       env_args=dict(args.env_args),
                       checkpoint=os.path.join(args.cwd, 'agent.npz'),
                       device=str(device))
    port = srv.start(port=0)
    base = f'http://127.0.0.1:{port}'
    try:
        env = make_stock_trading(beg_idx=834, end_idx=1113,
                                 if_random_reset=False)
        gen = torch.Generator(device=device).manual_seed(0)
        state = env.init(gen, 1, device)
        obs = env.obs(state)
        done = False
        while not done:
            req = urllib.request.Request(
                base + '/act',
                data=json.dumps({'obs': obs.cpu().numpy().tolist()}).encode(),
                headers={'Content-Type': 'application/json'})
            with urllib.request.urlopen(req, timeout=60) as r:
                action = np.asarray(json.loads(r.read())['action'], np.float32)
            state, reward, terminal, truncate = env.step(
                state, torch.as_tensor(action, device=device), gen)
            obs = env.obs(state)
            done = bool(terminal[0]) or bool(truncate[0])
        cr = float(state.cumulative_returns[0])
        print(f"paper trading on held-out days 834-1113: "
              f"cumulative_returns {cr:.2f} (buy-and-hold-all baseline and "
              f"random-action sanity values: see StockTradingEnv docstring)")
        return cr
    finally:
        srv.stop()


if __name__ == '__main__':
    quick = 'quick' in sys.argv
    trained_args = train(quick)
    paper_trade(trained_args)
