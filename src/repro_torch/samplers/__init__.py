"""Samplers of the port: the serial sampler and the offline-evaluation
sampler."""
from .serial import SerialSampler, SamplerState, RolloutBatch  # noqa: F401
from .eval import EvalSampler  # noqa: F401
