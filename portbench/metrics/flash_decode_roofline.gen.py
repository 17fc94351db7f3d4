"""The decode attention kernel's share of its roofline over the profiled
decode blocks, in percent: the least time the kv_len the slots held allows
a launch, on average over the launches the blocks made, over the average
device time of the launches the trace holds.  The profiler can drop
records under load, so the trace may hold fewer launches than the blocks
made; more than that means something else was counted, and then, as with
none, the metric is left out."""
import sys


def read(rec):
    tr, c = rec.get("trace"), rec["counters"]
    if tr is None or not c.get("attn_launches"):
        return None
    ops = tr.kernels_in(tr.range_bounds("decode_block"), "flash_decode")
    made = c["attn_launches"]
    print(f"flash_decode_roofline.gen: {len(ops)} of {made} launches in "
          "the trace", file=sys.stderr)
    if not ops or len(ops) > made:
        return None
    per_launch = sum(e - s for _, s, e in ops) / len(ops)
    return 100.0 * c["attn_bound_s"] / made / per_launch
