"""The numbers that decide ``correct``, each compared with its limit.

A cell's limits are ``limits/<cell>.json``: {number: limit}.  Every number
is a gap between what the program produced and what the reference works
out, so a sound run reads small and a fault reads large.
"""
from __future__ import annotations

import json
import math
import statistics
from pathlib import Path

LIMITS = Path(__file__).resolve().parents[1] / "limits"


def load_limits(cell: str) -> dict:
    return json.loads((LIMITS / f"{cell}.json").read_text())


def rel_gap(prog: float, ref: float) -> float:
    return abs(prog - ref) / max(abs(ref), 1e-30)


def leaf_gap(prog: dict, ref: dict, keep=None, worst: bool = True) -> float:
    """The gap between the program's and the reference's norm of a leaf,
    over the larger of that leaf's reference norm and the median leaf's
    (some leaves' norms are all but zero): the worst leaf's, or with
    ``worst=False`` the median leaf's.  ``keep``: the leaves that count
    (all where None)."""
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in ref)
    gaps = [abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names]
    return max(gaps) if worst else statistics.median(gaps)


def moving_leaves(grad1_ref: dict, share: float = 1e-3) -> set:
    """Leaves whose first reference gradient is at least ``share`` of the
    median leaf's: the others move under Adam by round-off alone."""
    med = statistics.median(grad1_ref.values())
    return {n for n, g in grad1_ref.items() if g >= share * med}


def judge(values: dict, limits: dict):
    """(correct, {number: {"value", "limit"}}): every number finite and at
    most its limit; a number without a limit fails."""
    checks, ok = {}, True
    for name, val in values.items():
        lim = limits.get(name)
        checks[name] = {"value": val, "limit": lim}
        if lim is None or not math.isfinite(val) or val > lim:
            ok = False
    return ok, checks
