"""Samplers of the port: the serial sampler, the alternating sampler
(two half-batches, the paper's Alternating-GPU schedule) and the
offline-evaluation sampler."""
from .serial import SerialSampler, SamplerState, RolloutBatch  # noqa: F401
from .alternating import AlternatingSampler  # noqa: F401
from .eval import EvalSampler  # noqa: F401
from .sharded import ShardedSampler  # noqa: F401
