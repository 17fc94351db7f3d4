"""Runners of the port: the per-iteration TrainLoop, the on- and
off-policy shells over it, and the asynchronous actor / learner runners
(transition and rollout modes, and R2D1's sequence mode)."""
from .train_loop import TrainLoop  # noqa: F401
from .minibatch import OffPolicyRunner, OnPolicyRunner  # noqa: F401
from .async_rl import AsyncRunner, AsyncR2D1Runner  # noqa: F401
