"""RL algorithms of the port: the three model-free families on one
substrate (the paper's thesis) — policy gradient (A2C, PPO, GAE and the
LM-scale PPO step), deep Q-learning (DQN and its variants, R2D1) and
Q-value policy gradient (DDPG, TD3, SAC)."""
from .pg.gae import discounted_returns, gae_associative, gae_scan  # noqa: F401
from .dqn.dqn import DQN  # noqa: F401
from .dqn.r2d1 import R2D1, value_rescale, value_rescale_inv  # noqa: F401
from .pg.a2c import A2C  # noqa: F401
from .pg.ppo import PPO  # noqa: F401
from .qpg.ddpg import DDPG  # noqa: F401
from .qpg.td3 import TD3  # noqa: F401
from .qpg.sac import SAC  # noqa: F401
