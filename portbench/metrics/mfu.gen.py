"""The window's share of the card's bf16 peak: 2 N model FLOPs a token
admitted or emitted in the window (N the parameters a token's forward
executes, the shared block at each of its sites) over the window's wall
and 989 TFLOP/s, in percent."""
from bench import arith


def read(rec):
    c = rec["counters"]
    return 100.0 * c["model_flops"] / c["wall_s"] / arith.PEAK_FLOPS_BF16
