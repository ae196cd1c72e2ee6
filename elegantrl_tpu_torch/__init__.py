"""elegantrl_tpu_torch — the PyTorch/CUDA port of elegantrl_tpu.

A second package beside the JAX one, with the same module layout and
public names.  Plain tensor code is PyTorch; each TPU (Pallas) kernel on a
ported path is a hand-written CUDA kernel for Hopper (``ops/csrc``), with
a plain PyTorch version beside it that the CPU path and the tests use.
Entry points run on the CUDA card unless ``Config.device='cpu'``.

Ported so far: the on-policy family (``AgentPPO``, ``AgentDiscretePPO``,
``AgentA2C``, ``AgentDiscreteA2C``, ``AgentPPOHterm``) and the off-policy
family (``AgentDQN``, ``AgentDoubleDQN``, ``AgentDuelingDQN``,
``AgentD3QN``, ``AgentEmbedDQN``, ``AgentEnsembleDQN``, ``AgentDDPG``,
``AgentTD3``, ``AgentSAC``, ``AgentModSAC`` and the H-term variants
``AgentDDPGHterm``, ``AgentTD3Hterm``, ``AgentSACHterm``,
``AgentModSACHterm``, with the replay buffer of ``train/replay_buffer.py``,
prioritised replay (``ops/per.py``), the cumulative-return fit and buffer
save and load) on Pendulum, CartPole, HopperSlip, PointChasing
(continuous and discrete), StockTradingEnv-v2 and LunarLander (discrete
and continuous), through ``Config``, ``build_training``, ``train_agent``
(and its three aliases) and ``valid_agent``/``render_agent``, with the
fused rollout (all six kernel bodies, the stock body's market tables
included; Gaussian, categorical, ddpg, sac, modsac and DQN heads), the
fused PPO update (continuous and discrete heads), the fused DQN-family,
DDPG/TD3 (also under PER) and SAC/ModSAC update chunks, and the V-trace
recursion, the replay gather and the fused 3-layer MLP forward
(``ops/kernels.py``).  Where the JAX package runs XLA ops instead of a
kernel, the port runs PyTorch ops, on a card too.
"""

__version__ = "0.1.0"

from .config import Config, build_env, get_gym_env_args, kwargs_filter  # noqa: F401
from .train.runner import (TrainCarry, build_training, render_agent, train_agent,  # noqa: F401
                           train_agent_multiprocessing, train_agent_multiprocessing_multi_gpu,
                           train_agent_single_process, valid_agent)
from .agents import (AgentD3QN, AgentDDPG, AgentDDPGHterm, AgentDoubleDQN,  # noqa: F401
                     AgentDQN, AgentDuelingDQN, AgentEmbedDQN, AgentEnsembleDQN,
                     AgentModSAC, AgentModSACHterm, AgentPPOHterm, AgentSAC, AgentSACHterm,
                     AgentTD3, AgentTD3Hterm)
from . import agents, envs, ops, train, utils  # noqa: F401
