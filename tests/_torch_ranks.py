"""Rank helpers for the port's data-parallel mesh tests: a spawn wrapper
with a deadline, and the bodies the spawned ranks run.

The ranks are spawned processes (``repro_torch.launch.mesh.spawn_ranks``:
gloo on the CPU, one intra-op thread each); they import this module to find
their body, so it imports torch and the port only, never JAX.  Inputs are
drawn from seeded numpy in ``inputs_*`` so the test process hands the
same numbers to the JAX reference.  Every body returns numpy.
"""
from contextlib import contextmanager, nullcontext

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.launch.mesh import make_axis_meshes, spawn_ranks

# each multi-rank call fails in seconds, well inside the suite's limit
DEADLINE_S = 120.0
COLLECTIVE_TIMEOUT_S = 30.0


def run_ranks(fn, n: int, *args, timeout: float = DEADLINE_S):
    """``fn(mesh, *args)`` on ``n`` gloo ranks on the CPU, results in rank
    order; raises on any rank's failure or at the deadline."""
    return spawn_ranks(fn, n, args, device="cpu", timeout=timeout,
                       collective_timeout=COLLECTIVE_TIMEOUT_S)


@contextmanager
def one_thread():
    """One intra-op thread for the test process's own reference runs, as
    the ranks have (tiny ops on many threads are 40x slower here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def t2n(tree):
    return pytree.tree_map(
        lambda x: x.detach().cpu().numpy().copy()
        if isinstance(x, torch.Tensor) else x, tree)


# ---------------------------------------------------------------------------
# seeded inputs (shared with the JAX reference)
# ---------------------------------------------------------------------------

PARAM_SHAPES = {"b": (4,), "w": (3, 4)}   # JAX's leaf order: sorted keys
N_STEPS = 3


def inputs_grads(n_ranks: int, seed: int = 0):
    """(params {name: (shape)}, grads[step][rank] {name: array}): the
    gradients differ per rank and per step; one leaf of rank 0 is large so
    the int8 scale truncates the others."""
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in PARAM_SHAPES.items()}
    grads = [[{k: (rng.standard_normal(s) * (1 + r)).astype(np.float32)
               for k, s in PARAM_SHAPES.items()} for r in range(n_ranks)]
             for _ in range(N_STEPS)]
    grads[0][0]["w"][0, 0] = 40.0
    return params, grads


def residual_of(g):
    """A residual for cross_pod_allreduce from a gradient (in numpy, so
    both sides see the same f32 values)."""
    return g * np.float32(0.01)


def inputs_sentinels(n_ranks: int, seed: int = 1):
    """Per-rank values of every Sentinels field ({field: (n_ranks,)})."""
    from repro_torch.telemetry.sentinels import Sentinels
    rng = np.random.default_rng(seed)
    out = {}
    for f in Sentinels._fields:
        if f in ("nonfinite_grads", "nonfinite_params", "env_steps"):
            out[f] = rng.integers(0, 50, n_ranks).astype(np.int32)
        else:
            out[f] = rng.uniform(0.1, 9.0, n_ranks).astype(np.float32)
    return out


def inputs_info(n_ranks: int, b: int = 3, seed: int = 2):
    """Per-rank OptInfo leaves: loss, grad_norm, a scalar extra and a
    batch-leading td_abs (b,)."""
    rng = np.random.default_rng(seed)
    return {"loss": rng.standard_normal(n_ranks).astype(np.float32),
            "grad_norm": rng.uniform(0, 3, n_ranks).astype(np.float32),
            "q_mean": rng.standard_normal(n_ranks).astype(np.float32),
            "td_abs": rng.uniform(0, 2, (n_ranks, b)).astype(np.float32)}


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------

def _run_opt(opt, params, grads_of_rank):
    """N_STEPS updates of ``opt`` from ``params``; returns (params,
    [state after each step], [gnorm]).  Each update gets fresh gradient
    tensors, as a step's own (the compressed one reduces them in place)."""
    p = [torch.from_numpy(params[k].copy()) for k in sorted(PARAM_SHAPES)]
    state = opt.init(p)
    states, norms = [], []
    for g in grads_of_rank:
        p, state, gn = opt.update(
            [torch.tensor(g[k]) for k in sorted(PARAM_SHAPES)], state, p)
        states.append(t2n(state))
        norms.append(float(gn))
    return t2n(p), states, norms


def collectives_body(mesh, n_ranks):
    """Every collective-bearing function on one axis of ``n_ranks``, and
    the two-stage cross_replica on a (pod 2, data n/2) layout."""
    from repro_torch.core.algorithm import OptInfo
    from repro_torch.runners.train_loop import TrainLoop
    from repro_torch.telemetry.sentinels import Sentinels, replicate
    from repro_torch.train.compress import EFState, cross_pod_allreduce
    from repro_torch.train.optim import adam, cross_replica
    i = mesh.index
    out = {}
    params, grads = inputs_grads(n_ranks)
    mine = [g[i] for g in grads]
    x = torch.from_numpy(mine[0]["w"])
    out["psum"] = t2n(mesh.psum(x))
    out["pmean"] = t2n(mesh.pmean(x))
    out["pmax"] = t2n(mesh.pmax(x))
    out["all_gather"] = t2n(mesh.all_gather(x, dim=1))
    keys = sorted(PARAM_SHAPES)
    g, ef = cross_pod_allreduce(
        [torch.from_numpy(mine[0][k]) for k in keys],
        EFState(residual=[torch.from_numpy(residual_of(mine[1][k]))
                          for k in keys]), axis=mesh)
    out["cross_pod"] = (t2n(g), t2n(ef.residual))
    for compress in (None, "int8_ef"):
        opt = cross_replica(adam(1e-2), mesh, compress=compress,
                            ef_shards=n_ranks)
        out[f"cross_replica_{compress}"] = _run_opt(opt, params, mine)
    sent = inputs_sentinels(n_ranks)
    s = Sentinels(**{k: torch.tensor(v[i]) for k, v in sent.items()})
    out["replicate"] = t2n(replicate(s, mesh)._asdict())
    info_in = inputs_info(n_ranks)
    info = OptInfo(loss=torch.tensor(info_in["loss"][i]),
                   grad_norm=torch.tensor(info_in["grad_norm"][i]),
                   extra={"q_mean": torch.tensor(info_in["q_mean"][i]),
                          "td_abs": torch.from_numpy(info_in["td_abs"][i])})
    rep = TrainLoop._replicate_info(_Loop(mesh), info)
    out["replicate_info"] = {"loss": t2n(rep.loss),
                             "grad_norm": t2n(rep.grad_norm),
                             **t2n(rep.extra)}
    if n_ranks == 4:
        axes = make_axis_meshes((2, 2), ("pod", "data"), device="cpu")
        for compress in (None, "int8_ef"):
            opt = cross_replica(adam(1e-2), axes, compress=compress,
                                ef_shards=2)
            out[f"cross_replica_2d_{compress}"] = _run_opt(opt, params, mine)
    return out


def replicate_body(mesh, vals):
    """sentinels.replicate of this rank's row of ``vals`` ({field:
    (n_ranks,)})."""
    from repro_torch.telemetry.sentinels import Sentinels, replicate
    s = Sentinels(**{k: torch.from_numpy(np.asarray(v[mesh.index]))
                     for k, v in vals.items()})
    return t2n(replicate(s, mesh)._asdict())


class _Loop:
    """What ``TrainLoop._replicate_info`` reads of its loop."""

    def __init__(self, mesh):
        self.mesh = mesh


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

def a2c_stack(mesh, n_envs=8, horizon=16):
    """JAX's sharded A2C test stack: CartPole, make_pg_mlp(4, 2), A2C with
    Adam 1e-3, ShardedSampler(8 envs x 16) on ``mesh``."""
    from repro_torch.agents import make_categorical_pg_agent
    from repro_torch.algos import A2C
    from repro_torch.core.distributions import Categorical
    from repro_torch.envs import make_env
    from repro_torch.models.rl_models import make_pg_mlp
    from repro_torch.samplers import ShardedSampler
    from repro_torch.train.optim import adam
    model = make_pg_mlp(4, 2)
    agent = make_categorical_pg_agent(model)
    algo = A2C(model.apply, adam(1e-3), distribution=Categorical(2))
    sampler = ShardedSampler(make_env("cartpole"), agent, n_envs=n_envs,
                             horizon=horizon, mesh=mesh)
    params = agent.init_params(
        torch.Generator(device=mesh.device).manual_seed(0))
    return sampler, algo, params


def a2c_body(mesh, n_iters=20, compress=None, sentinels=False, fuse=True):
    """``n_iters`` A2C iterations: on a rank through TrainLoop(mesh=...), in
    one process (a mesh without a group) through the plain TrainLoop on the
    global batch of the same ShardedSampler.  Returns the params, each
    iteration's loss, the step, the sentinels' row of the last window and
    the EF residual's leaf shapes."""
    from repro_torch.runners import TrainLoop
    from repro_torch.telemetry.sentinels import summarize
    from repro_torch.train.optim import CrossReplicaState
    dev = mesh.device
    sampler, algo, params = a2c_stack(mesh)
    loop = TrainLoop(sampler, algo, mesh=mesh if mesh.distributed else None,
                     compress=compress, sentinels=sentinels, fuse=fuse)
    ts = loop.algo.init_train_state(None, params)
    ss = sampler.init(torch.Generator(device=dev).manual_seed(1))
    gen = torch.Generator(device=dev).manual_seed(2)
    losses, sents = [], []
    for _ in range(n_iters):
        ts, ss, _, info, sent = loop.run_window(ts, ss, None, gen, 1)
        losses.append(float(info.loss))
        sents.append(sent)
    out = {"params": t2n(pytree.tree_leaves(ts.params)), "losses": losses,
           "step": ts.step, "row": None, "residual_shapes": None,
           "stats": {k: float(v) for k, v in sampler.traj_stats(ss).items()}}
    if sentinels:
        from repro_torch.core.tree import tree_concat
        out["row"] = summarize(tree_concat(sents))
    if isinstance(ts.opt_state, CrossReplicaState):
        out["residual_shapes"] = [tuple(r.shape)
                                  for r in ts.opt_state.ef.residual]
    return out


def a2c_misinit_body(mesh):
    """A compressed loop given a train state of the UNwrapped algo raises
    the clear ValueError; returns its message."""
    from repro_torch.runners import TrainLoop
    sampler, algo, params = a2c_stack(mesh)
    loop = TrainLoop(sampler, algo, mesh=mesh, compress="int8_ef")
    ts_bad = algo.init_train_state(None, params)
    ss = sampler.init(torch.Generator().manual_seed(1))
    try:
        loop.run_window(ts_bad, ss, None, torch.Generator().manual_seed(2), 1)
    except ValueError as e:
        return str(e)
    return None


def dqn_runner(mesh, ckpt_dir=None, n_iterations=4, fuse=True):
    """JAX's sharded DQN smoke stack: Catch, a small conv Q net, double DQN,
    ShardedSampler(8 envs x 8), prioritized replay 512, batch 32, 2
    updates a collect, warm-up 128, epsilon 0.2; checkpoints every 2
    iterations into ``ckpt_dir``."""
    from repro_torch.agents import make_dqn_agent
    from repro_torch.algos import DQN
    from repro_torch.envs import make_env
    from repro_torch.models.rl_models import make_q_conv
    from repro_torch.runners import OffPolicyRunner
    from repro_torch.samplers import ShardedSampler
    from repro_torch.train.optim import adam
    from repro_torch.utils.logger import Logger
    model = make_q_conv(1, 3, img_hw=(10, 5), channels=(8,), kernels=(3,),
                        strides=(1,), d_out=32)
    agent = make_dqn_agent(model, 3)
    algo = DQN(model.apply, adam(1e-3), double=True,
               target_update_interval=50)
    sampler = ShardedSampler(make_env("catch"), agent, n_envs=8, horizon=8,
                             mesh=mesh)
    return OffPolicyRunner(
        sampler, algo, replay_capacity=512, batch_size=32,
        n_iterations=n_iterations, updates_per_collect=2, min_replay=128,
        prioritized=True, log_interval=2, logger=Logger(sinks=()),
        agent_state_kwargs={"epsilon": 0.2}, mesh=mesh,
        ckpt_dir=ckpt_dir, ckpt_interval=2 if ckpt_dir else 0, fuse=fuse)


def dqn_body(mesh, ckpt_dir):
    """The sharded DQN smoke on a rank, saving checkpoints; then this rank's
    restore of the last one (shardings=) against its live state, and a
    data-sharded (8, 4) leaf saved for the elastic restore."""
    from repro_torch.kernels.sum_tree import ops as st_ops
    from repro_torch.train.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
    runner = dqn_runner(mesh, ckpt_dir)
    ts, ss, info = runner.run(0, device=mesh.device)
    rs = runner.replay_state
    like = (ts, rs)
    (ts2, rs2), manifest = restore_checkpoint(
        ckpt_dir, like, shardings=runner.loop.checkpoint_specs(like))
    same = all(torch.equal(a, b) for a, b in zip(
        pytree.tree_leaves((ts.params, ts.opt_state, rs)),
        pytree.tree_leaves((ts2.params, ts2.opt_state, rs2))))
    x = torch.arange(32.0).reshape(8, 4)
    save_checkpoint(ckpt_dir + "_x", 1, {"params": ts.params,
                                         "x": mesh.block(x)},
                    shardings={"params": None, "x": mesh})
    return {"step": ts.step, "loss": float(info.loss),
            "td_abs_shape": tuple(info.extra["td_abs"].shape),
            "restored_equal": same, "manifest_mesh": manifest["mesh_shape"],
            "iteration": manifest["extra"]["iteration"],
            "params": t2n(pytree.tree_leaves(ts.params)),
            "replay": t2n(rs._asdict()), "filled": int(rs.filled),
            "launches": st_ops.tree_sample_blocked.launches}


def rerun_body(mesh, fuse):
    """One sharded DQN runner run twice from seed 0 on a rank: the params
    and this rank's replay after each run (the rank's replay draws must
    start again with the seed), with ``fuse`` as given."""
    runner = dqn_runner(mesh, n_iterations=2, fuse=fuse)
    out = []
    for _ in range(2):
        ts, _, _ = runner.run(0, device=mesh.device)
        out.append({"params": t2n(pytree.tree_leaves(ts.params)),
                    "replay": t2n(pytree.tree_leaves(
                        runner.replay_state))})
    return out


def replicated_ckpt_body(mesh, ckpt_dir):
    """A checkpoint with no sharded leaf on a mesh: OnPolicyRunner(mesh=)
    without compression saves after 2 A2C iterations, then every rank
    saves a leaf holding its own index through ``save_checkpoint(mesh=)``.
    Returns the first's manifest."""
    from repro_torch.runners import OnPolicyRunner
    from repro_torch.train.checkpoint import restore_checkpoint
    from repro_torch.train.checkpoint import save_checkpoint
    from repro_torch.utils.logger import Logger
    sampler, algo, _ = a2c_stack(mesh)
    runner = OnPolicyRunner(sampler, algo, n_iterations=2, log_interval=2,
                            logger=Logger(sinks=()), ckpt_dir=ckpt_dir,
                            ckpt_interval=2, fuse=False, mesh=mesh)
    ts, _, _ = runner.run(0, device=mesh.device)
    _, manifest = restore_checkpoint(ckpt_dir, ts)
    save_checkpoint(ckpt_dir + "_x", 1,
                    {"x": torch.full((2,), float(mesh.index))}, mesh=mesh)
    return manifest


def elastic_body(mesh, ckpt_dir):
    """Restore on this mesh (another size than the saving one): the
    replicated params whole, the data-sharded leaf's block."""
    from repro_torch.train.checkpoint import restore_checkpoint
    runner = dqn_runner(mesh)
    params = runner.sampler.agent.init_params(torch.Generator())
    out, manifest = restore_checkpoint(
        ckpt_dir + "_x", {"params": params,
                          "x": torch.zeros(8 // mesh.size, 4)},
        shardings={"params": None, "x": mesh})
    return {"params": t2n(pytree.tree_leaves(out["params"])),
            "x": t2n(out["x"]), "saved_mesh": manifest["mesh_shape"]}


def failing_body(mesh):
    """Rank 1 raises while rank 0 waits in a collective."""
    if mesh.index == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return t2n(mesh.psum(torch.ones(2)))


def hanging_body(mesh):
    """Rank 0 never returns."""
    import time
    if mesh.index == 0:
        time.sleep(600)
    return mesh.index


def a2c_records_body(mesh, compress=None):
    """One A2C iteration through TrainLoop(mesh=..., compress=...) with the
    mesh's collectives recorded (``record_collectives``); returns the
    records and the gradient's element count."""
    from repro_torch.launch.mesh import record_collectives
    from repro_torch.runners import TrainLoop
    dev = mesh.device
    sampler, algo, params = a2c_stack(mesh)
    loop = TrainLoop(sampler, algo, mesh=mesh, compress=compress)
    ts = loop.algo.init_train_state(None, params)
    ss = sampler.init(torch.Generator(device=dev).manual_seed(1))
    gen = torch.Generator(device=dev).manual_seed(2)
    with record_collectives() as records:
        loop.run_window(ts, ss, None, gen, 1)
    leaves = pytree.tree_leaves(params)
    return {"records": list(records),
            "n_elems": sum(int(p.numel()) for p in leaves),
            "n_leaves": len(leaves)}


def records_body(mesh):
    """The records of a psum of 3 f32 and an all_gather of (2, 5) f32."""
    from repro_torch.launch.mesh import record_collectives
    with record_collectives() as records:
        mesh.psum(torch.ones(3, device=mesh.device))
        got = mesh.all_gather(torch.full((2, 5), float(mesh.index),
                                         device=mesh.device))
    return {"records": list(records), "gathered": t2n(got)}


# ---------------------------------------------------------------------------
# the LM mesh (launch/train.py --mesh Dx1)
# ---------------------------------------------------------------------------

def lm_steps(mesh, np_params, cfg, batches, compress=None, lr=1e-3,
             opt="adam", instrument=False):
    """``make_lm_ppo_train_step`` under ``cross_replica`` on this rank: the
    LM from JAX's ``init_lm`` params (numpy), one step a batch of
    ``batches`` ({key: (n_ranks, B, T)} each, this rank's row).  ``opt``
    "adam" (lr, clip 1.0) or "sgd" (lr, no momentum); ``instrument`` sums
    the pmean'd (true) gradients beside the compressed update.  Returns
    numpy: params, metrics a step (the loss also pmean'd), and with
    compression this rank's residual and the ranks' mean residual."""
    from repro_torch.algos.pg.ppo import make_lm_ppo_train_step
    from repro_torch.models.convert import jax_leaf_groups, params_from_jax
    from repro_torch.train.optim import Optimizer, adam, cross_replica, sgd
    lm = params_from_jax(np_params, cfg, device="cpu", dtype=torch.float32,
                         requires_grad=True)
    base = adam(lr, grad_clip=1.0) if opt == "adam" else sgd(lr)
    copt = cross_replica(base, mesh, compress=compress, ef_shards=mesh.size,
                         scale_groups=jax_leaf_groups(
                             [n for n, _ in lm.named_parameters()], cfg))
    out = {"p0": [t2n(p) for p in lm.parameters()]}
    o = copt
    if instrument:
        acc = [torch.zeros_like(p) for p in lm.parameters()]

        def update(grads, state, params):
            for a, g in zip(acc, mesh.pmean_all(grads)):
                a.add_(g)
            return copt.update(grads, state, params)

        o = Optimizer(copt.init, update)
    state = o.init(lm.parameters())
    step = make_lm_ppo_train_step(cfg, o, entropy_coeff=0.003)
    out["metrics"] = []
    for b in batches:
        mine = {k: torch.from_numpy(np.ascontiguousarray(v[mesh.index]))
                for k, v in b.items()}
        lm, state, m = step(lm, state, mine)
        row = {k: float(v) for k, v in m.items()}
        row["loss_pmean"] = float(mesh.pmean(m["loss"]))
        out["metrics"].append(row)
    out["names"] = [n for n, _ in lm.named_parameters()]
    out["params"] = [t2n(p) for p in lm.parameters()]
    if compress:
        res = [r[0] for r in state.ef.residual]
        out["residual"] = t2n(res)
        out["residual_mean"] = t2n(mesh.pmean_all(res))
    if instrument:
        out["acc"] = t2n(acc)
    return out


def lm_steps_body(mesh, cases):
    """``lm_steps`` for each case ({name: kwargs})."""
    return {name: lm_steps(mesh, **kw) for name, kw in cases.items()}


def train_main_restore_body(mesh, ckpt_dir, argv):
    """``train.main`` on the group ``spawn_ranks`` initialized: ``argv``
    with ``--steps 4`` unbroken, then ``--steps 2`` saving at 2, then
    ``--steps 4 --restore``.  Returns (the unbroken run's params, the
    restored run's), numpy, and the mesh ``train.main`` built."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_2d_mesh
    whole = train.main(argv + ["--steps", "4"])
    ck = ["--ckpt-dir", ckpt_dir, "--ckpt-interval", "2"]
    train.main(argv + ["--steps", "2"] + ck)
    resumed = train.main(argv + ["--steps", "4", "--restore"] + ck)
    m = make_2d_mesh(device="cpu")
    return {"whole": [t2n(p) for p in whole.parameters()],
            "resumed": [t2n(p) for p in resumed.parameters()],
            "mesh": (m.shape, m.data.index, m.data.distributed)}


# ---------------------------------------------------------------------------
# the fused mesh (TrainLoop(mesh=, fuse=True), the model axis' rollout)
# ---------------------------------------------------------------------------

FUSED_MESH_ALGOS = ("a2c", "ppo", "dqn")


def fused_mesh_stack(mesh, name):
    """(loop, (ts, ss, rs, generator)) of a fused-mesh case on ``mesh``:
    ``a2c`` (JAX's sharded A2C stack, int8_ef, sentinels), ``ppo`` (PPO on
    CartPole, 8 envs x 16, 2 epochs x 2 minibatches, sentinels), ``dqn``
    (the sharded prioritized DQN smoke, its replay warmed to
    ``min_replay``)."""
    from repro_torch.algos import PPO
    from repro_torch.core.distributions import Categorical
    from repro_torch.replay.interface import transition_example
    from repro_torch.runners import TrainLoop
    from repro_torch.train.optim import adam
    dev = mesh.device
    gens = [torch.Generator(device=dev).manual_seed(i) for i in range(3)]
    if name == "dqn":
        runner = dqn_runner(mesh)
        loop, sampler = runner.loop, runner.sampler
        params = sampler.agent.init_params(gens[0])
        ts = loop.algo.init_train_state(gens[0], params)
        ss = sampler.init(gens[1], runner.agent_state_kwargs)
        rs = runner.replay.init_sharded(
            transition_example(sampler.env, device=dev), mesh.size,
            index=mesh.index)
        while int(rs.filled) * mesh.size < runner.min_replay:
            ss, rs = loop.collect_insert(ts.params, ss, rs)
        return loop, (ts, ss, rs, gens[2])
    sampler, algo, params = a2c_stack(mesh)
    if name == "a2c":
        loop = TrainLoop(sampler, algo, mesh=mesh, compress="int8_ef",
                         sentinels=True)
    else:
        algo = PPO(algo.apply, adam(7e-4, grad_clip=0.5),
                   distribution=Categorical(2), epochs=2, minibatches=2)
        loop = TrainLoop(sampler, algo, mesh=mesh, sentinels=True)
    ts = loop.algo.init_train_state(None, params)
    return loop, (ts, sampler.init(gens[1]), None, gens[2])


def _snap(tree):
    """Numpy of every leaf, generators by their state."""
    return [x.get_state().numpy().copy() if isinstance(x, torch.Generator)
            else x.detach().cpu().numpy().copy()
            if isinstance(x, torch.Tensor) else x
            for x in pytree.tree_leaves(tree, is_leaf=lambda v: isinstance(
                v, torch.Generator))]


def fused_mesh_body(mesh, n, archs, drawn):
    """The fused mesh's CPU checks on this rank: for each of
    FUSED_MESH_ALGOS, ``n`` iterations unfused and fused from the same
    seeds (the fused ones under ``NoHostReads``), each iteration's state,
    info and sentinels, and the collectives it recorded; whether the
    rank's replay generator is a leaf of the fused graph's state.  Then
    the model axis' rollout at 1 x 2 under ``NoHostReads`` for each of
    ``archs`` (smoke configs), and ``a2c_drawn`` on ``drawn``."""
    from _torch_host_reads import NoHostReads
    from repro_torch.core.graphs import is_leaf
    from repro_torch.launch.mesh import record_collectives
    out = {}
    for name in FUSED_MESH_ALGOS:
        res = {"snaps": {}, "records": {}}
        for fuse in (False, True):
            loop, state = fused_mesh_stack(mesh, name)
            loop.fuse = fuse
            snaps, records = [], []
            for _ in range(n):
                with record_collectives() as rec, \
                        NoHostReads() if fuse else nullcontext():
                    ts, ss, rs, info, sent = loop.run_window(*state, 1)
                state = (ts, ss, rs, state[3])
                snaps.append(_snap((ts, ss, rs, state[3], info, sent)))
                records.append(list(rec))
            res["snaps"][fuse], res["records"][fuse] = snaps, records
            if fuse:
                (graph,) = loop.graphs.values()
                res["shard_leaf"] = any(
                    x is loop._shard_gen for x in pytree.tree_leaves(
                        graph.args, is_leaf=is_leaf))
        out[name] = res
    out["rollouts"] = rollout_host_reads(mesh, archs)
    out["drawn"] = a2c_drawn(mesh, **drawn)
    return out


def rollout_host_reads(world, archs, batch=2, horizon=5):
    """``make_lm_rollout(graph=True)`` on a 1 x 2 mesh of this world (the
    model axis' tp collectives inside its step) for each smoke config of
    ``archs``: a warm-up rollout, then one under ``NoHostReads``; returns
    each second rollout's actions."""
    from _torch_host_reads import NoHostReads
    from repro_torch.configs import get_smoke_config
    from repro_torch.envs.token_lm import make_token_lm
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch.train import make_lm_rollout
    from repro_torch.models import backbones as bb
    tmesh.install_2d(tmesh.make_2d_mesh(1, 2, device="cpu"))
    out = {}
    try:
        for arch in archs:
            cfg = get_smoke_config(arch)
            lm = bb.init_lm(cfg, device="cpu", generator=torch.Generator()
                            .manual_seed(0), dtype=torch.float32)
            env = make_token_lm(vocab=cfg.vocab, episode_len=horizon,
                                device="cpu")
            rollout = make_lm_rollout(cfg, env, batch, horizon, device="cpu",
                                      graph=True)
            gen = torch.Generator().manual_seed(3)
            rollout(lm, gen)
            with NoHostReads():
                traj, _ = rollout(lm, gen)
            out[arch] = t2n(traj["actions"])
    finally:
        tmesh.install_2d(None)
    return out


def a2c_drawn(mesh, params, env_state, obs, agent_noise, env_noise, n,
              B, T):
    """A2C (Adam 1e-3, JAX's defaults) on CartPole through
    ``TrainLoop(mesh=, fuse=True)``, this rank's block of ``B`` envs x
    ``T`` drawing JAX's numbers (``agent_noise``: the Gumbel noise of
    JAX's categorical sample a step, (B, 2); ``env_noise``: the fresh
    CartPole state a step, (B, 4)) from JAX's initial ``env_state`` /
    ``obs`` and its ``params``; returns the params and each iteration's
    loss after ``n`` iterations."""
    from repro_torch.agents import make_categorical_pg_agent
    from repro_torch.algos import A2C
    from repro_torch.core.distributions import Categorical
    from repro_torch.envs import cartpole
    from repro_torch.models.convert import rl_params_from_jax
    from repro_torch.models.rl_models import make_pg_mlp
    from repro_torch.runners import TrainLoop
    from repro_torch.samplers import ShardedSampler
    from repro_torch.train.optim import adam
    b = B // mesh.size
    mine = slice(mesh.index * b, (mesh.index + 1) * b)
    it_env = iter([x[mine] for x in env_noise])
    it_agent = iter([x[mine] for x in agent_noise])
    model, dist = make_pg_mlp(4, 2), Categorical(2)

    def agent_step(params, generator, obs, pa, pr, state):
        logits, value = model.apply(params, obs, pa, pr)
        action = torch.argmax(logits + torch.from_numpy(next(it_agent)), -1)
        return action, {"logp": dist.log_likelihood(action, logits),
                        "value": value}, state

    def env_step(state, action, generator):
        return cartpole.step_with_noise(state, action,
                                        torch.from_numpy(next(it_env)))

    env = cartpole.make_cartpole()._replace(step=env_step)
    agent = make_categorical_pg_agent(model)._replace(step=agent_step)
    sampler = ShardedSampler(env, agent, n_envs=B, horizon=T, mesh=mesh)
    algo = A2C(model.apply, adam(1e-3), distribution=dist)
    loop = TrainLoop(sampler, algo, mesh=mesh, fuse=True)
    ts = loop.algo.init_train_state(None, rl_params_from_jax(params))
    ss = sampler.init(torch.Generator())
    ss = ss._replace(env_state=pytree.tree_map(
        lambda x: torch.from_numpy(np.ascontiguousarray(x[mine])), env_state),
        obs=torch.from_numpy(np.ascontiguousarray(obs[mine])))
    gen, losses = torch.Generator(), []
    for _ in range(n):
        ts, ss, _, info, _ = loop.run_window(ts, ss, None, gen, 1)
        losses.append(float(info.loss))
    return {"params": t2n(pytree.tree_leaves(ts.params)), "losses": losses,
            "step": ts.step}


def fused_pair_body(mesh, name, n):
    """``n`` iterations of ``fused_mesh_stack(name)`` unfused and fused on
    this rank (cuDNN deterministic): each iteration's state, info and
    sentinels (numpy), and the fused loop's graph replays."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for fuse in (False, True):
            loop, state = fused_mesh_stack(mesh, name)
            loop.fuse = fuse
            snaps = []
            for _ in range(n):
                ts, ss, rs, info, sent = loop.run_window(*state, 1)
                state = (ts, ss, rs, state[3])
                snaps.append(_snap((ts, ss, rs, state[3], info, sent)))
            out[fuse] = snaps
        out["replays"] = sum(g.replays for g in loop.graphs.values())
    finally:
        torch.backends.cudnn.deterministic = was
    return out
