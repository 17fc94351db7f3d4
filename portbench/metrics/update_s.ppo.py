"""Seconds an update takes: the benchmark's synchronised clock around
``build_batch`` (GAE) and the train step, over the window's steps."""
import statistics


def read(rec):
    xs = rec["spans"].get("update_s")
    return statistics.fmean(xs) if xs else None
