from .base import AgentDef, Rollout  # noqa: F401
from .ppo import (AgentA2C, AgentDiscreteA2C, AgentDiscretePPO, AgentPPO,  # noqa: F401
                  PPOState, make_ppo)
from .dqn import AgentD3QN, AgentDoubleDQN, AgentDQN, AgentDuelingDQN, DQNState, make_dqn  # noqa: F401
from .ddpg_td3 import AgentDDPG, AgentTD3, DDPGState, make_ddpg, make_td3  # noqa: F401
from .sac import AgentModSAC, AgentSAC, SACState, make_sac  # noqa: F401
