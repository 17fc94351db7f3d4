"""Runners of the port: the per-iteration TrainLoop and the off-policy
shell over it."""
from .train_loop import TrainLoop  # noqa: F401
from .minibatch import OffPolicyRunner  # noqa: F401
