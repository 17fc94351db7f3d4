"""Milliseconds a decode step of the slot batch: the window's decode
blocks' synchronised wall over their steps."""


def read(rec):
    return rec["counters"].get("decode_step_ms")
