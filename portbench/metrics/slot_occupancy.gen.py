"""Share of the window's slot-steps that emitted a token, in percent: the
tokens the decode blocks emitted over blocks x steps a block x slots.  A
slot retired inside a block idles for the rest of it."""


def read(rec):
    occ = rec["counters"].get("slot_occupancy")
    return None if occ is None else 100.0 * occ
