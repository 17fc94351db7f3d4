"""Milliseconds of an admission's teacher-forced tail: the mean host wall
of the program's ``slots.tail`` spans in the profiled stretch after the
window, one an admission (0 to 15 eager B=1 decode steps, the prompt past
its bucket)."""
from bench import progspans


def read(rec):
    pt = progspans.read(rec)
    return progspans.mean_ms(pt.named("slots.tail")) if pt else None
