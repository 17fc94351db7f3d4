"""The Q-value policy-gradient family (paper §1.1): DDPG, TD3 and SAC."""
from .ddpg import DDPG  # noqa: F401
from .sac import SAC  # noqa: F401
from .td3 import TD3  # noqa: F401
