from .replay_buffer import BufferState, ReplayBuffer  # noqa: F401
from .runner import TrainCarry, TrainContext, build_training, train_agent  # noqa: F401
from .evaluator import Evaluator  # noqa: F401
