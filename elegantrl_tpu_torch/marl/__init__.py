from .env import MultiAgentEnvDef  # noqa: F401
from .chasing import make_team_chasing, make_team_chasing_discrete  # noqa: F401
from .mappo import make_mappo, train_mappo  # noqa: F401
from .mappo_rnn import make_mappo_rnn, train_mappo_rnn  # noqa: F401
from .qmix import make_qmix, train_qmix  # noqa: F401
from .qmix_rnn import make_qmix_rnn, train_qmix_rnn  # noqa: F401
from .maddpg import make_maddpg, train_maddpg  # noqa: F401
