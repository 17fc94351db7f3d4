"""Samplers of the port (so far the serial sampler)."""
from .serial import SerialSampler, SamplerState, RolloutBatch  # noqa: F401
