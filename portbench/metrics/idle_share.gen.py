"""Share of the profiled stretch after the window (from the first profiled
decode block's start to the last one's end, with the admissions between
them) in which no operation ran on the device, in percent."""


def read(rec):
    tr = rec.get("trace")
    win = tr.window("decode_block") if tr is not None else None
    if win is None or not tr.kernels:
        return None
    lo, hi = win
    return 100.0 * (1.0 - tr.busy(lo, hi) / (hi - lo))
