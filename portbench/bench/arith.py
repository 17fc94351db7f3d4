"""The yardstick's arithmetic, frozen here so that a change to the program
does not move it: the card's published peaks, a kernel's least time from
its operations and bytes, the operations and bytes of the kernels the
cells time, the parameter count behind ``mfu``, and the union of device
intervals behind the idle share.

The bound and the SSD operation count are copies of ``chip_smoke.py``'s
``bound_ms`` and ``ssd_flops``; ``n_params`` / ``n_active_params`` copy
``repro_torch/models/config.py``'s (the dry run's ``model_flops`` reads
them) and take the configuration as a dict of its fields;
``token_params`` counts what a token's forward executes, which ``mfu``
reads.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12


def pad_vocab(v: int, multiple: int = 128) -> int:
    return ((v + multiple - 1) // multiple) * multiple


def bound_s(nbytes: float, flops: float, peak: float = PEAK_FLOPS_BF16):
    """(least seconds, "bytes" or "operations"): the larger of the bytes
    over the HBM bandwidth and the operations over the peak."""
    t_bytes, t_ops = nbytes / HBM_BW, flops / peak
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def ssd_flops(B, T, H, P, G, N, chunk):
    """Multiply-adds x 2 that the scan needs on these shapes: C.B^T once
    per (batch, group, chunk) and, per (batch, head, chunk), M.x over the
    causal (q, k) pairs, C.S_prev and B^T.(x w) over the chunk's rows."""
    total = 0
    for c in range(-(-T // chunk)):
        tc = min(chunk, T - c * chunk)
        pairs = tc * (tc + 1) // 2
        total += B * G * 2 * pairs * N + B * H * (2 * pairs * P
                                                  + 4 * tc * N * P)
    return total


def ssd_bytes(B, T, H, P, G, N):
    """Each input read once and each output written once: x and y in
    bf16, dt and A in f32, B and C in bf16, the final state in f32."""
    return (2 * B * T * H * P * 2 + B * T * H * 4 + H * 4
            + 2 * B * T * G * N * 2 + B * H * P * N * 4)


def decode_attn_bytes(B, H, Hkv, dh, n_kv):
    """flash_attn_decode over ``n_kv`` cached positions summed over the
    batch: q read and out written (bf16), the K and V rows it attends
    (bf16), kv_len (int32)."""
    return 2 * (2 * B * H * dh + 2 * n_kv * Hkv * dh) + 4 * B


def decode_attn_flops(H, dh, n_kv):
    """Q.K^T and P.V over the attended positions, every query head."""
    return 4 * dh * H * n_kv


def n_params(c: dict) -> int:
    """Analytic parameter count of the configuration's fields."""
    D, V = c["d_model"], pad_vocab(c["vocab"])
    n = V * D + D * V
    H_ = c.get("n_heads", 0)
    Hkv = c.get("n_kv_heads", 0)
    dh = c.get("d_head", 0)
    fam = c["family"]

    def attn():
        return D * H_ * dh * 2 + D * Hkv * dh * 2

    def mlp(ff):
        return 3 * D * ff

    def ssm():
        P = c.get("ssm_headdim", 64)
        H = c.get("ssm_expand", 2) * D // P
        G, N = c.get("ssm_n_groups", 1), c["d_state"]
        p = D * H * P * 2 + D * G * N * 2 + D * H + H * 2
        p += (H * P + 2 * G * N) * c.get("conv_kernel", 4)
        p += H * P + H * P * D
        return p

    L = c["n_layers"]
    if fam == "dense":
        n += L * (attn() + mlp(c["d_ff"]))
    elif fam == "moe":
        E, Fe = c["n_experts"], c["d_ff_expert"]
        n += L * (attn() + D * E + E * 3 * D * Fe
                  + c.get("n_shared_experts", 0) * 3 * D * Fe)
    elif fam == "ssm":
        n += L * ssm()
    elif fam == "hybrid":
        n += L * ssm() + attn() + mlp(c["d_ff"])
    else:
        raise ValueError(f"n_params: family {fam!r} has no count here")
    return n + L * 2 * D + D


def n_active_params(c: dict) -> int:
    """Parameters a token passes through: a moe layer's top-k routed and
    its shared experts, not all of them."""
    n = n_params(c)
    if c["family"] != "moe":
        return n
    D, L, Fe = c["d_model"], c["n_layers"], c["d_ff_expert"]
    return n - L * (c["n_experts"] - c["top_k"]) * 3 * D * Fe


def token_params(c: dict) -> int:
    """Parameters a token's forward multiplies by, as executed: the active
    parameters (the embedding counted, as the dry run counts it), with a
    hybrid's shared attention + MLP block counted at every one of its
    ``n_layers // attn_every`` sites, since each site runs it again.  A
    forward token is 2 x this in FLOPs, an update token 6 x."""
    n = n_active_params(c)
    if c["family"] != "hybrid":
        return n
    D, H_, Hkv, dh = c["d_model"], c["n_heads"], c["n_kv_heads"], c["d_head"]
    block = D * H_ * dh * 2 + D * Hkv * dh * 2 + 3 * D * c["d_ff"]
    return n + (c["n_layers"] // c["attn_every"] - 1) * block


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] that at least one (start, end) interval covers."""
    spans = sorted((max(s, lo), min(e, hi)) for s, e in intervals
                   if e > lo and s < hi)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def gaps(intervals, lo: float, hi: float):
    """The idle stretches of [lo, hi]: [(start, end)], longest first."""
    spans = sorted((max(s, lo), min(e, hi)) for s, e in intervals
                   if e > lo and s < hi)
    out, t = [], lo
    for s, e in spans:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return sorted(out, key=lambda g: g[0] - g[1])
