#!/usr/bin/env python3
"""How far rounding alone moves one LM-PPO update's loss and gradients, on
one H100: the update of ``chip_smoke.py``'s training checks (its weights,
first rollout and sgd(0) step, at the slice's batch and horizon) under
several routes, at each depth cut of a full-width config:

    python3 tools/train_route_spread.py [ARCH] [DEPTH ...]

(default: zamba2-7b at 4, 7 and 15 layers).  The routes, each a valid
implementation of the same function, against the plain SSD scan with the
attention kernel (the plain route of the training checks):

- the plain attention: a change of rounding in the attention alone;
- the plain SSD scan at half the chunk: a change of rounding in the SSD
  alone (another order of the same f32 sums), the baseline the kernel is
  read against;
- the SSD kernel: the kernel route of the training checks.

For each: loss, grad_norm, the relative distance of the whole gradient
(||g - g_plain|| / ||g_plain||) and the leaves that carry most of it.
Prints one line a depth and route, then one JSON line.
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

torch = cs.torch
PLAIN = "ssd=ref,attention=cuda"
ROUTES = ((PLAIN, 1), ("ssd=ref,attention=ref", 1), (PLAIN, 2),
          ("ssd=cuda,attention=cuda", 1))


def update(cfg, params, batch, spec):
    """loss, grad_norm and the f32 gradients (sgd(0)'s momentum buffer is
    the gradient) of one update under ``spec``."""
    with cs.registry.override(spec):
        opt = cs.optim.sgd(0.0)
        step = cs.make_lm_ppo_train_step(cfg, opt, entropy_coeff=0.003)
        _, st, m = step(params, opt.init(params.parameters()), batch)
    return float(m["loss"]), float(m["grad_norm"]), st.mu


def spread(arch, depth, run):
    cfg = cs.dataclasses.replace(cs.get_config(arch), n_layers=depth)
    env = cs.make_token_lm(vocab=cfg.vocab, episode_len=run["horizon"],
                           device=cs.DEV)
    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
    params = cs.bb.init_lm(cfg, device=cs.DEV, generator=gen,
                           dtype=torch.float32, requires_grad=True)
    rollout = cs.train.make_lm_rollout(cfg, env, run["batch"],
                                       run["horizon"], device=cs.DEV)
    batch = cs.train.build_batch(*rollout(params, gen))
    names = [n for n, _ in params.named_parameters()]
    out, base = {}, None
    for spec, div in ROUTES:
        c = cs.dataclasses.replace(cfg, ssd_chunk=cfg.ssd_chunk // div)
        loss, gnorm, g = update(c, params, batch, spec)
        label = spec + ("" if div == 1 else f",chunk {c.ssd_chunk}")
        if base is None:
            base = (loss, gnorm, g)
            out[label] = {"loss": loss, "grad_norm": gnorm}
            continue
        d = [float((a - b).norm()) for a, b in zip(g, base[2])]
        total = sum(x * x for x in d) ** 0.5
        top = sorted(zip(d, names), reverse=True)[:4]
        out[label] = {
            "loss": loss, "grad_norm": gnorm,
            "loss_rel": abs(loss - base[0]) / abs(base[0]),
            "grad_norm_rel": abs(gnorm - base[1]) / abs(base[1]),
            "grad_rel": total / base[1],
            "top_leaves": {n: x / base[1] for x, n in top}}
        del g
    for label, r in out.items():
        print(f"  {arch} {depth} layers {cs.bb.superblock_layout(cfg)}, "
              f"{label}: loss {r['loss']:.6f} grad_norm {r['grad_norm']:.4f}"
              + ("" if "grad_rel" not in r else
                 f"; against {PLAIN}: loss {r['loss_rel']:.3e}, grad_norm "
                 f"{r['grad_norm_rel']:.3e}, gradient {r['grad_rel']:.3e} "
                 "(leaves: " + ", ".join(f"{n} {x:.2e}" for n, x in
                                         r["top_leaves"].items()) + ")"))
    del params, batch, base
    torch.cuda.empty_cache()
    return out


def main():
    arch = sys.argv[1] if len(sys.argv) > 1 else "zamba2-7b"
    depths = [int(d) for d in sys.argv[2:]] or [4, 7, 15]
    run = cs.TRAIN7 if arch == "zamba2-7b" else cs.TRAIN
    print(cs.smi())
    print(f"{arch}: batch {run['batch']}, horizon {run['horizon']}, seed "
          f"{cs.SEED}")
    res = {d: spread(arch, d, run) for d in depths}
    print(json.dumps({"train_route_spread": {
        "arch": arch, "device": torch.cuda.get_device_name(0),
        "by_depth": res}}))


if __name__ == "__main__":
    main()
