"""Training substrate of the port: optimizers, checkpoints with elastic
re-shard, and gradient compression."""
from .optim import (  # noqa: F401
    OptState, adam, sgd, constant, linear_warmup_cosine, clip_by_global_norm,
    soft_update, Optimizer,
)
from .checkpoint import save_checkpoint, restore_checkpoint, latest_step  # noqa: F401
from .compress import (ef_quantize, ef_dequantize,  # noqa: F401
                       cross_pod_allreduce, EFState)
