"""Share of the traced update in which no operation ran on the device, in
percent: from the program's ``ppo.step`` span's start on the host to the
end of the last device operation it launched.  Also prints, to standard
error, the device time each phase launched and what no phase holds."""
import sys

from bench import progspans


def read(rec):
    pt = progspans.read(rec)
    steps = pt.named("ppo.step") if pt and pt.ops else []
    shares = []
    for s in steps:
        ops = pt.launched_in([s])
        if not ops:
            continue
        end = max(o.end for o in ops)
        shares.append(1.0 - pt.busy(s.t0, end) / (end - s.t0))
    if not shares:
        return None
    phases = progspans.update_phases(pt)
    print("update_idle_share.ppo: device ms a phase " + ", ".join(
        f"{name or 'no phase'} {progspans.device_ms(ops, len(steps)) or 0.0:.3f}"
        f" ({len(ops)} ops)" for name, ops in phases.items()),
        file=sys.stderr)
    return 100.0 * sum(shares) / len(shares)
