from .base import EnvSpec, EnvDef, VecEnv, vec_reset, vec_step  # noqa: F401
from .pendulum import PendulumEnv, PendulumState, make_pendulum  # noqa: F401
from .cartpole import CartPoleEnv, CartPoleState, make_cartpole  # noqa: F401
from .hopper import HopperEnv, HopperState, make_hopper  # noqa: F401
from .point_chasing import (ChasingState, PointChasingDiscreteEnv, PointChasingEnv,  # noqa: F401
                            PointChasingVecEnv, make_point_chasing,
                            make_point_chasing_discrete)
from .stock_trading import (StockState, StockTradingEnv, StockTradingVecEnv,  # noqa: F401
                            StockTradingVmapEnv, dataframe_to_arrays, load_market_data,
                            make_stock_trading, synthetic_market_data)
from .lunar_lander import (LanderState, LunarLanderContinuousEnv, LunarLanderEnv,  # noqa: F401
                           make_lunar_lander)
