"""The SSD scan kernel's share of its roofline in the traced update: the
least time its shapes allow (bytes over HBM bandwidth or operations over
the bf16 peak, whichever is larger) over its device time a launch."""
from bench import arith


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    ops = tr.kernels_in(tr.range_bounds("update"), "ssd_scan")
    if not ops:
        return None
    c = rec["cfg"]
    B, T = rec["counters"]["batch"], rec["counters"]["horizon"]
    P, N = c["ssm_headdim"], c["d_state"]
    H = c["ssm_expand"] * c["d_model"] // P
    G = c["ssm_n_groups"]
    bound, _ = arith.bound_s(arith.ssd_bytes(B, T, H, P, G, N),
                             arith.ssd_flops(B, T, H, P, G, N,
                                             min(c["ssd_chunk"], T)))
    per_launch = sum(e - s for _, s, e in ops) / len(ops)
    return 100.0 * bound / per_launch
