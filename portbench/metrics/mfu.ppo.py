"""The whole step's share of the card's bf16 peak: model FLOPs (2 N a
rollout token, 6 N an update token, N the parameters a token executes) over the
window's wall and 989 TFLOP/s, in percent."""
from bench import arith


def read(rec):
    c = rec["counters"]
    return 100.0 * c["model_flops"] / c["wall_s"] / arith.PEAK_FLOPS_BF16
