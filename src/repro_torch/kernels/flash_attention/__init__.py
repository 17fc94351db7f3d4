from .ops import flash_attention, flash_attention_decode  # noqa: F401
from .ref import attention_reference  # noqa: F401
