"""Deep Q-learning of the port: DQN and its variants, and R2D1."""
from .dqn import DQN, huber  # noqa: F401
from .r2d1 import R2D1  # noqa: F401
