"""Share of the ``slots.tail`` spans' host wall in the profiled stretch in
which no operation ran on the device, in percent: near 100 where the
eager B=1 tail is paced by the host, near 0 where the card is."""
from bench import progspans


def read(rec):
    pt = progspans.read(rec)
    tails = pt.named("slots.tail") if pt else []
    wall = sum(s.wall for s in tails)
    if not pt or not pt.ops or wall <= 0:
        return None
    return 100.0 * (1.0 - sum(pt.busy(s.t0, s.t1) for s in tails) / wall)
