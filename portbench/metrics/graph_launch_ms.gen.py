"""Milliseconds of host time a decode block's graph launch takes: the mean
host wall of the program's ``graph.replay`` spans of the engine's decode
block (``cudaGraphLaunch`` and what the replay does around it) in the
profiled stretch after the window."""
from bench import progspans


def read(rec):
    pt = progspans.read(rec)
    if not pt:
        return None
    return progspans.mean_ms(pt.named("graph.replay",
                                      graph="engine.decode_block"))
