"""Share of the traced training step in which no operation ran on the
device: 1 - (union of device intervals) / the step's wall, in percent."""


def read(rec):
    tr = rec.get("trace")
    win = tr.window("step") if tr is not None else None
    if win is None or not tr.kernels:
        return None
    lo, hi = win
    return 100.0 * (1.0 - tr.busy(lo, hi) / (hi - lo))
