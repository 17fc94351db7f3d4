"""Faults planted under the timed path, to show that ``correct`` catches
them: the control runs and the tests wrap the program's pieces with these.

- ``unchanged``: the train step returns its state as it got it;
- ``half_batch``: the train step sees the first half of the batch's rows,
  its loss the mean over those;
- ``token``: one sampled token altered where it is produced (the
  rollout's action after the environment took it; a served token after the
  decode block emitted it).
"""
from __future__ import annotations

import torch

TRAIN_FAULTS = ("unchanged", "half_batch", "token")
SERVE_FAULTS = ("token",)


def ppo_pieces(make, fault):
    """``make`` (bench.ppo.program_pieces) with ``fault`` planted."""

    def pieces(cfg, env, mix, dev):
        rollout, step, opt = make(cfg, env, mix, dev)
        if fault == "unchanged":
            def unchanged(params, opt_state, batch):
                state = list(params.parameters()) + list(opt_state.mu) \
                    + list(opt_state.nu)
                keep = [t.detach().clone() for t in state]
                _, _, met = step(params, opt_state, batch)
                with torch.no_grad():
                    for t, k in zip(state, keep):
                        t.copy_(k)
                return params, opt_state, met
            return rollout, unchanged, opt
        if fault == "half_batch":
            def half(params, opt_state, batch):
                n = batch["tokens"].shape[0] // 2
                return step(params, opt_state,
                            {k: v[:n] for k, v in batch.items()})
            return rollout, half, opt
        if fault == "token":
            def altered(params, gen):
                traj, v_last = rollout(params, gen)
                a = traj["actions"]
                a[a.shape[0] // 2, 0] = (a[a.shape[0] // 2, 0] + 1) \
                    % env.action_space.n
                return traj, v_last
            return altered, step, opt
        raise ValueError(f"unknown fault {fault!r}")

    return pieces


def serve_token(engine):
    """Alter the first token a decode block emits for slot 0, once."""
    orig = engine._run_block
    done = [False]

    def run_block(active, remaining):
        act, rem, toks, emitted = orig(active, remaining)
        if not done[0] and bool(emitted[0, 0]):
            toks = toks.clone()
            toks[0, 0] = (toks[0, 0] + 1) % engine.cfg.vocab
            done[0] = True
        return act, rem, toks, emitted

    engine._run_block = run_block
