"""Rank bodies for the tests of the LM mesh's 'model' axis
(``tests/test_torch_lm_tp*.py``): tensor parallelism on gloo ranks on the
CPU.

The ranks are spawned processes (``_torch_ranks.run_ranks``); they import
this module to find their body, so it imports torch and the port only,
never JAX.  Every input is numpy (JAX's parameters in its layout, seeded
activations and batches) and every output is numpy, the blocks of a leaf
the model axis splits gathered to its global value.
"""
import numpy as np
import torch

from _torch_ranks import t2n


def _mesh(n_data, n_model):
    from repro_torch.launch import mesh as tmesh
    return tmesh.install_2d(tmesh.make_2d_mesh(n_data, n_model, device="cpu"))


def _lm(np_params, cfg, requires_grad=True):
    from repro_torch.models.convert import params_from_jax
    return params_from_jax(np_params, cfg, device="cpu", dtype=torch.float32,
                           requires_grad=requires_grad)


def _full(lm, cfg, mesh, named_tensors):
    """{name: numpy} of ``(name, tensor)`` pairs of ``lm``'s leaves, each
    gathered over the model axis."""
    from repro_torch.models import sharding as shd
    specs = shd.param_pspecs(lm, cfg)
    return {n: t2n(shd.gather_leaf(n, t.detach(), specs[n], mesh.model))
            for n, t in named_tensors}


def _grads(lm, loss, extra=()):
    leaves = [p for _, p in lm.named_parameters()]
    gs = torch.autograd.grad(loss, leaves + list(extra),
                             materialize_grads=True)
    return list(gs[:len(leaves)]), list(gs[len(leaves):])


def _layer(lm, cfg, which, x, w):
    """One layer's output and gradients: ``which`` names the module of
    layer 0 and its function; the loss is ``sum(y * w)`` (+ the moe's
    aux)."""
    from repro_torch.models import layers as TL
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w)
    block = lm.layers[0]
    if which == "attention":
        mod = block.attn
        y, _ = TL.attention_train(mod, xt, cfg, window=cfg.window)
        loss = torch.sum(y * wt)
    elif which == "mlp":
        mod = block.mlp
        y = TL.mlp(mod, xt)
        loss = torch.sum(y * wt)
    elif which == "moe":
        mod = block.moe
        y, aux = TL.moe(mod, xt, cfg)
        loss = torch.sum(y * wt) + 3.0 * aux
    elif which == "ssd":
        mod = block.ssd
        y, _ = TL.ssd_block_train(mod, xt, cfg)
        loss = torch.sum(y * wt)
    else:
        raise ValueError(which)
    return y, loss, xt


def _split_grads(lm, cfg, grads):
    from repro_torch.models import sharding as shd
    return shd.model_split(lm, cfg).sum_split_(grads)


def tp_body(world, n_model, cases):
    """Every case of ``cases`` ({name: dict(kind=..., ...)}) on a 1 x
    ``n_model`` mesh of the spawned world; returns {name: numpy dict}."""
    from repro_torch.launch import mesh as tmesh
    mesh = _mesh(world.size // n_model, n_model)
    try:
        return {name: _CASES[c["kind"]](mesh, **{k: v for k, v in c.items()
                                                 if k != "kind"})
                for name, c in cases.items()}
    finally:
        tmesh.install_2d(None)


def layer_case(mesh, np_params, cfg, which, x, w):
    """A layer of layer 0 of ``cfg``'s smoke model on the rank: its
    output, the input's gradient and every leaf's (summed and
    gathered), for the module's leaves."""
    lm = _lm(np_params, cfg)
    y, loss, xt = _layer(lm, cfg, which, x, w)
    grads, (gx,) = _grads(lm, loss, [xt])
    grads = _split_grads(lm, cfg, grads)
    prefix = {"attention": "layers.0.attn.", "mlp": "layers.0.mlp.",
              "moe": "layers.0.moe.", "ssd": "layers.0.ssd."}[which]
    named = [(n, g) for (n, _), g in zip(lm.named_parameters(), grads)
             if n.startswith(prefix)]
    return {"y": t2n(y), "gx": t2n(gx), "grads": _full(lm, cfg, mesh, named)}


def vocab_case(mesh, np_params, cfg, tokens, actions, h, w):
    """The vocab-parallel lookup and logits: the embedded tokens, the
    gathered logits, ``logp`` of ``actions`` and the entropy over the
    full vocabulary, and the gradients of ``tok_embed``, ``lm_head`` and
    the hidden state under loss ``sum(x * w) - mean(logp) - mean(ent)``."""
    import torch.nn.functional as F
    from repro_torch.models import backbones as tbb
    lm = _lm(np_params, cfg)
    x = tbb.embed(lm, torch.from_numpy(tokens), cfg)
    ht = torch.from_numpy(h).requires_grad_(True)
    logits = tbb.lm_logits(lm, ht, cfg).float()
    logp_all = F.log_softmax(logits, dim=-1)
    logp = torch.gather(logp_all, -1,
                        torch.from_numpy(actions).long()[..., None])[..., 0]
    ent = -torch.sum(torch.exp(logp_all) * logp_all, dim=-1)
    loss = torch.sum(x * torch.from_numpy(w)) - logp.mean() - ent.mean()
    grads, (gh,) = _grads(lm, loss, [ht])
    named = [(n, g) for (n, _), g in zip(lm.named_parameters(), grads)
             if n in ("tok_embed", "lm_head")]
    return {"x": t2n(x), "logits": t2n(logits), "logp": t2n(logp),
            "ent": t2n(ent), "gh": t2n(gh),
            "grads": _full(lm, cfg, mesh, named),
            "local_vocab": int(lm.tok_embed.shape[0])}


def forward_case(mesh, np_params, cfg, tokens, sabotage=()):
    """``forward_train`` on the rank: the hidden state and aux, and the
    gradient of loss ``mean(logits) + sum of values + aux`` summed over
    the split-use leaves and gathered; the two lists; and, for each name
    in ``sabotage``, the gradient of that leaf with the leaf moved to the
    other list (a split-use leaf left partial, a replicated-use one
    summed)."""
    from repro_torch.models import backbones as tbb
    from repro_torch.models import sharding as shd
    lm = _lm(np_params, cfg)
    hidden, aux = tbb.forward_train(lm, torch.from_numpy(tokens), cfg)
    logits = tbb.lm_logits(lm, hidden, cfg)
    loss = torch.mean(logits.float()) + torch.sum(
        tbb.value_out(lm, hidden)) * 1e-2 + aux
    raw, _ = _grads(lm, loss)
    split = shd.model_split(lm, cfg)
    names = list(split.names)
    grads = split.sum_split_(raw)
    out = {"hidden": t2n(hidden), "aux": float(aux),
           "grads": _full(lm, cfg, mesh, zip(names, grads)),
           "split_use": [n for n, s in zip(names, split.split_use) if s],
           "sharded": [n for n, s in zip(names, split.sharded) if s],
           "sabotaged": {}}
    for name in sabotage:
        i = names.index(name)
        g = raw[i] if split.split_use[i] else mesh.model.psum(raw[i])
        out["sabotaged"][name] = t2n(g)
    return out


def ppo_case(mesh, np_params, cfg, batches, lr, compress=None):
    """JAX's LM-PPO step on the rank, ``len(batches)`` Adam steps (clip
    1.0) under ``cross_replica`` over the data axis with the model
    split; each batch {key: (D, B, T)}, this data rank's row.  Returns
    the metrics a step, the gathered params, their names, and the
    gathered EF residual with compression."""
    from repro_torch.algos.pg.ppo import make_lm_ppo_train_step
    from repro_torch.models import sharding as shd
    from repro_torch.models.convert import jax_leaf_groups
    from repro_torch.train.optim import adam, cross_replica
    lm = _lm(np_params, cfg)
    split = shd.model_split(lm, cfg)
    names = [n for n, _ in lm.named_parameters()]
    opt = cross_replica(adam(lr, grad_clip=1.0), mesh.data,
                        compress=compress, ef_shards=mesh.data.size,
                        scale_groups=jax_leaf_groups(names, cfg),
                        model=split)
    state = opt.init(lm.parameters())
    step = make_lm_ppo_train_step(cfg, opt, entropy_coeff=0.003,
                                  param_pspecs=shd.param_pspecs(lm, cfg))
    metrics = []
    for b in batches:
        mine = {k: torch.from_numpy(np.ascontiguousarray(v[mesh.data.index]))
                for k, v in b.items()}
        lm, state, m = step(lm, state, mine)
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "names": names,
           "params": _full(lm, cfg, mesh, lm.named_parameters()),
           "local": [t2n(p) for p in lm.parameters()], "split": split.sharded}
    if compress:
        out["residual"] = _full(lm, cfg, mesh, zip(
            names, [r[0] for r in state.ef.residual]))
    return out


def rollout_case(mesh, np_params, cfg, batch, horizon, seed):
    """One rollout of the LM (``make_lm_rollout``, eager) on the rank from
    the generator seeded ``seed``: its (T, B) actions, logp and values;
    and the rank's blocks gathered back into JAX's layout
    (``params_to_jax(specs=, mesh=)``)."""
    from repro_torch.envs.token_lm import make_token_lm
    from repro_torch.launch.train import make_lm_rollout
    from repro_torch.models import sharding as shd
    from repro_torch.models.convert import params_to_jax
    lm = _lm(np_params, cfg, requires_grad=False)
    env = make_token_lm(vocab=cfg.vocab, episode_len=horizon, device="cpu")
    rollout = make_lm_rollout(cfg, env, batch, horizon, device="cpu",
                              graph=False)
    traj, v_last = rollout(lm, torch.Generator().manual_seed(seed))
    out = {k: t2n(traj[k]) for k in ("actions", "logp", "value")}
    out["to_jax"] = t2n(params_to_jax(lm.named_parameters(), cfg,
                                      specs=shd.param_pspecs(lm, cfg),
                                      mesh=mesh.model))
    out["local_vocab"] = int(lm.tok_embed.shape[0])
    return out


def ckpt_case(mesh, np_params, cfg, batch, lr, save_dir, restore_dir):
    """One Adam step on the rank, then save at this mesh into
    ``save_dir`` (the gathered params and moments returned); and a fresh
    LM and optimizer restored from ``restore_dir`` (written at another
    model extent), this rank's blocks returned."""
    from repro_torch.algos.pg.ppo import make_lm_ppo_train_step
    from repro_torch.models import sharding as shd
    from repro_torch.train.checkpoint import (restore_lm_checkpoint,
                                              save_lm_checkpoint)
    from repro_torch.train.optim import adam, cross_replica
    lm = _lm(np_params, cfg)
    opt = cross_replica(adam(lr, grad_clip=1.0), mesh.data,
                        model=shd.model_split(lm, cfg))
    state = opt.init(lm.parameters())
    step = make_lm_ppo_train_step(cfg, opt, entropy_coeff=0.003)
    lm, state, _ = step(lm, state, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    names = [n for n, _ in lm.named_parameters()]
    save_lm_checkpoint(save_dir, 1, lm, state, cfg, mesh=mesh)
    saved = {"params": _full(lm, cfg, mesh, lm.named_parameters()),
             "mu": _full(lm, cfg, mesh, zip(names, state.mu)),
             "nu": _full(lm, cfg, mesh, zip(names, state.nu))}
    fresh = _lm(np_params, cfg)
    st = opt.init(fresh.parameters())
    st, manifest = restore_lm_checkpoint(restore_dir, fresh, st, cfg,
                                         mesh=mesh)
    restored = {"params": [t2n(p) for p in fresh.parameters()],
                "mu": t2n(st.mu), "nu": t2n(st.nu), "step": int(st.step),
                "names": names}
    return {"saved": saved, "restored": restored,
            "manifest_mesh": manifest["mesh_shape"]}


_CASES = {"layer": layer_case, "vocab": vocab_case, "forward": forward_case,
          "ppo": ppo_case, "rollout": rollout_case, "ckpt": ckpt_case}
