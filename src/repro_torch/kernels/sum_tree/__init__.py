"""Prioritized-replay sampling: the hand-written CUDA kernel
(``csrc/sum_tree.cu``) behind ``ops.tree_sample_blocked`` /
``ops.sample_proportional``, its plain version ``sum_tree.sample_plain`` and
the flat oracle ``ref.sample_reference``."""
from .ops import (BlockedPriorities, init_priorities, set_priorities,  # noqa: F401
                  sample_proportional, tree_sample_blocked, tree_update_blocked)
from .ref import sample_reference  # noqa: F401
