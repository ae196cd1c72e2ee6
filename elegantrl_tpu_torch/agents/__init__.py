from .base import AgentDef, Rollout  # noqa: F401
from .ppo import (AgentA2C, AgentDiscreteA2C, AgentDiscretePPO, AgentPPO,  # noqa: F401
                  AgentPPOHterm, PPOHtermState, PPOState, make_ppo)
from .dqn import AgentD3QN, AgentDoubleDQN, AgentDQN, AgentDuelingDQN, DQNState, make_dqn  # noqa: F401
from .ddpg_td3 import (AgentDDPG, AgentDDPGHterm, AgentTD3, AgentTD3Hterm,  # noqa: F401
                       DDPGHtermState, DDPGState, make_ddpg, make_ddpg_hterm, make_td3,
                       make_td3_hterm)
from .sac import (AgentModSAC, AgentModSACHterm, AgentSAC, AgentSACHterm,  # noqa: F401
                  SACHtermState, SACState, make_sac)
from .embed_dqn import AgentEmbedDQN, AgentEnsembleDQN, EmbedDQNState, make_embed_dqn  # noqa: F401
from .hterm import HtermBuffer  # noqa: F401
from .pixel import AgentPixelPPO, PixelPPOState, make_pixel_ppo  # noqa: F401
