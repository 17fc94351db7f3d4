"""Milliseconds the device idles between two decode blocks: from the end
of the last operation launched in one ``engine.block`` span (the block's
graph) to the start of the first one launched in the next (its masks'
upload), less the time other device work covers, on average over the
profiled pairs of blocks with no admission between them.  The host's
readback and bookkeeping after a block and the next block's launch lie in
that gap."""
from bench import progspans


def read(rec):
    pt = progspans.read(rec)
    if not pt or not pt.ops:
        return None
    blocks = pt.named("engine.block")
    admits = pt.named("engine.admit")
    gaps = []
    for a, b in zip(blocks, blocks[1:]):
        if any(x.t1 > a.t1 and x.t0 < b.t0 for x in admits):
            continue
        ops_a, ops_b = pt.launched_in([a]), pt.launched_in([b])
        if not ops_a or not ops_b:
            continue
        end = max(ops_a, key=lambda o: (o.launch, o.end)).end
        start = min(ops_b, key=lambda o: (o.launch, o.start)).start
        gaps.append(max(0.0, start - end - pt.busy(end, start)))
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
