"""Device milliseconds of the backward (``autograd.grad`` of the loss) in the
traced update: the profiler's time of every device operation launched inside
the program's ``ppo.backward`` spans, each microbatch's, over the updates
traced.  Each operation is joined to its launch on the host
(``bench/progspans.py``), so work that runs after its span has ended counts
too."""
from bench import progspans


def read(rec):
    pt = progspans.read(rec)
    if not pt or not pt.ops:
        return None
    return progspans.device_ms(progspans.update_phases(pt)["ppo.backward"],
                               len(pt.named("ppo.step")))
