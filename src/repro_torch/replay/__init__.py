"""Replay of the port (paper §1.1): n-step returns, prioritized (sum tree),
sequence replay with periodic recurrent-state storage, frame-based dedup.

Two substrates:
- ``host``: numpy ring buffers (the paper's shared-memory buffers; they
  feed the asynchronous runner), with the numpy ``SumTree``;
- ``device``: the torch ring and sum tree on the device (the TrainLoop
  path; its sampling is the hand-written sum-tree kernel on the card).
"""
from .sum_tree import SumTree  # noqa: F401
from .host import (  # noqa: F401
    TransitionSamples,
    SequenceSamples,
    UniformReplayBuffer,
    PrioritizedReplayBuffer,
    SequenceReplayBuffer,
    FrameReplayBuffer,
)
from . import device  # noqa: F401
from .interface import (ReplayLike, DeviceReplay, HostTransitionReplay,  # noqa: F401
                        HostSequenceReplay, LockedReplay, host_tree,
                        transition_example)
