from .base import AgentDef, Rollout  # noqa: F401
from .ppo import (AgentA2C, AgentDiscreteA2C, AgentDiscretePPO, AgentPPO,  # noqa: F401
                  PPOState, make_ppo)
