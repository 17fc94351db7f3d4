"""Readings that set a cell's limits: the program's numbers on sound runs,
the control's, and the numbers of planted faults.

  python3 portbench/control.py --workload <cell> --seeds 1,2,3 \\
      --modes sound,control,half_batch,token [--seconds 10]

prints one JSON line a (seed, mode): the numbers ``correct`` compares,
each computed as a run computes it.

- ``sound``: the program as the cell runs it, against the reference;
- ``control``: the reference itself in the next precision below the
  program's (bf16 -> float8 e4m3 products), in the program's place on the
  same tokens (a training cell's check steps; a served cell's prompts and
  served tokens: the token the control puts first at each position);
- a fault of ``bench/faults.py`` planted in the program.

Training cells need no window (their readings are the check steps');
served cells run the window at ``--seconds`` to serve as a run does.  Run
it on the card; a chip is looked for as ``run.py`` does.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as entry  # noqa: E402


def ppo_readings(ctx, modes):
    import gc

    import torch

    from bench import faults, ppo
    out = {}
    base = ppo.program_pieces
    for mode in modes:
        if mode == "control":
            continue
        ppo.program_pieces = base if mode == "sound" \
            else faults.ppo_pieces(base, mode)
        try:
            s = ppo.build(ctx)
            read = ppo.check_steps(ctx, s)
        finally:
            ppo.program_pieces = base
        ppo.free(s)
        ref = ppo.reference(ctx, s, read, "f32")
        out[mode] = dict(ppo.numbers(read, ref),
                         diag=ppo.diagnostics(read, ref))
        if mode == "sound" and "control" in modes:
            low = ppo.reference(ctx, s, read, "fp8")
            ctl = dict(read, **{k: low[k] for k in (
                "loss", "grad1", "change", "logp", "value", "reward")
                + ppo.LOSS_KEYS})
            out["control"] = dict(ppo.numbers(ctl, ref),
                                  diag=ppo.diagnostics(ctl, ref))
            del low, ctl
        del read, ref
        s.chain = None
        s = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def serve_readings(ctx, modes):
    import gc

    import torch

    from bench import batchgen, faults
    out = {}
    for mode in modes:
        if mode == "control":
            continue
        _, weights, engine, reqs = batchgen.build(ctx)
        if mode != "sound":
            faults.serve_token(engine)
        batchgen.serve(ctx, engine, reqs)
        del engine
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        done = batchgen.finished(reqs)
        whole = [r for r in done if len(r.tokens) == r.max_tokens]
        chosen = batchgen.sample(ctx, whole)
        for name, prec in ((mode, "f32"), ("control", "fp8")):
            if name == "control" and (mode != "sound"
                                      or "control" not in modes):
                continue
            stats = batchgen.judge_served(ctx, weights, whole, chosen, prec)
            out[name] = dict(batchgen.served_numbers(stats),
                             short_requests=float(len(done) - len(whole)),
                             diag=batchgen.served_diagnostics(stats))
    return out


def readings(bench, cell, seed, modes, seconds, device, **kw):
    from bench import harness
    ctx = harness.context(bench, cell, seed, seconds, False, device,
                          time.perf_counter(), **kw)
    fn = ppo_readings if ctx.mix["kind"] == "lm_ppo" else serve_readings
    return fn(ctx, modes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="sound,control")
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    entry.prepare_env()
    from bench import spec
    bench = spec.load_benchmark()
    cell = spec.find_cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("control readings need a CUDA device", file=sys.stderr)
        return 2
    modes = args.modes.split(",")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        got = readings(bench, cell, seed, modes, args.seconds, "cuda:0")
        for mode, nums in got.items():
            print(json.dumps({"cell": args.workload, "seed": seed,
                              "mode": mode, "numbers": nums,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    bad = entry.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
