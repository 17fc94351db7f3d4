"""Milliseconds an admission takes inside the window: the benchmark's
synchronised clock around the engine's ``write_prefill_at`` (bucket
prefill, teacher-forced tail, slot write), over the admissions."""


def read(rec):
    c = rec["counters"]
    if not c.get("requests"):
        return None
    return c["admit_s"] / c["requests"] * 1e3
