"""Runners of the port: the per-iteration TrainLoop and the on- and
off-policy shells over it."""
from .train_loop import TrainLoop  # noqa: F401
from .minibatch import OffPolicyRunner, OnPolicyRunner  # noqa: F401
