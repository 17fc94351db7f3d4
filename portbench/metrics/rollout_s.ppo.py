"""Seconds a rollout takes: the benchmark's synchronised clock around
``rollout(params, gen)``, over the window's rollouts."""
import statistics


def read(rec):
    xs = rec["spans"].get("rollout_s")
    return statistics.fmean(xs) if xs else None
