"""RL algorithms of the port (so far: DQN and its variants, GAE and the
LM-scale PPO step)."""
from .dqn.dqn import DQN  # noqa: F401
