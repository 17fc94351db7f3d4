"""Milliseconds of an admission's bucket prefill: the mean host wall of the
program's ``slots.prefill`` spans in the profiled stretch after the window
(the prompt's cache made from a fresh single-slot cache at the largest
bucket under its length).  The span does not synchronise: the host's
time, which the device may outlast."""
from bench import progspans


def read(rec):
    pt = progspans.read(rec)
    return progspans.mean_ms(pt.named("slots.prefill")) if pt else None
