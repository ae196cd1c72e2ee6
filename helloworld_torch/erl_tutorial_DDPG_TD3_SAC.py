"""Tutorial: train DDPG / TD3 / SAC / ModSAC on Pendulum with the framework
(mirror of reference ``helloworld/erl_tutorial_*`` off-policy tutorials),
run on the CUDA card (`Config.device` defaults to it)."""
import sys
import os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from elegantrl_tpu_torch.config import Config
from elegantrl_tpu_torch.agents import AgentDDPG, AgentModSAC, AgentSAC, AgentTD3
from elegantrl_tpu_torch.envs import PendulumEnv
from elegantrl_tpu_torch.train.runner import train_agent


def train_for_pendulum(agent_class=AgentModSAC):
    env_args = {'env_name': 'Pendulum-v1', 'num_envs': 8, 'max_step': 200,
                'state_dim': 3, 'action_dim': 1, 'if_discrete': False}
    args = Config(agent_class, PendulumEnv, env_args)
    args.break_step = int(2e5)
    args.net_dims = (64, 64)
    args.gamma = 0.97
    args.horizon_len = 100
    args.buffer_size = int(1e6)
    args.batch_size = 256
    args.learning_rate = 5e-4
    args.eval_times = 16
    args.eval_per_step = int(2e4)
    return train_agent(args)


if __name__ == '__main__':
    name = sys.argv[1] if len(sys.argv) > 1 else 'modsac'
    train_for_pendulum({'ddpg': AgentDDPG, 'td3': AgentTD3,
                        'sac': AgentSAC, 'modsac': AgentModSAC}[name])
