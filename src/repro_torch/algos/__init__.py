"""RL algorithms of the port (so far: DQN and its variants, A2C, PPO, GAE
and the LM-scale PPO step)."""
from .dqn.dqn import DQN  # noqa: F401
from .pg.a2c import A2C  # noqa: F401
from .pg.ppo import PPO  # noqa: F401
