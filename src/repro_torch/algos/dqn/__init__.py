"""Deep Q-learning of the port (so far DQN and its variants)."""
from .dqn import DQN, huber  # noqa: F401
