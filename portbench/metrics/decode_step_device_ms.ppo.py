"""Device milliseconds a decode step of the rollout: the profiler's time of
every device operation inside the traced rollout, over the horizon."""


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    ops = tr.kernels_in(tr.range_bounds("rollout"))
    if not ops:
        return None
    return sum(e - s for _, s, e in ops) / rec["counters"]["horizon"] * 1e3
