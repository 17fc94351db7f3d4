#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA device of compute capability 9.0 and the CUDA toolkit
(nvcc); imports nothing of JAX.  Phases, each of which raises on failure:

1. the card's name and power limit (nvidia-smi);
2. build every hand-written kernel from csrc/ (one nvcc per source, all at
   once: flash_attention.cu, ssd_scan.cu, sum_tree.cu) and print the build
   time and ptxas' register / shared memory / spill report;
3. kernel phase: each kernel entry point against its plain PyTorch version
   (``attention_reference``) in bf16 on the card, within its own tolerance
   (``TOL``) at every shape the main path gives it: prefill at B 4, T 1024
   and ragged T 1000, H 8, Hkv 4, dh 256, causal, softcap 50, window 4096
   and 256, at the fixed-round shape (B 8, T 1024, local and global
   layers) and at the continuous run's bucketed B 1 prompts (T 8-64, one
   partial tile, local and global); decode at B 8, S 2048 with ragged
   kv_len, at the fixed-round shape (S 1089), and at the continuous run's
   B 8 slot batch and B 1 prompt-tail steps (S 97, ragged kv_len); decode
   also at kv_len on every boundary of its split plan +-1 and at kv_len 1
   (every split but the first empty); prefill also at the gemma2 training
   shape (B 8, T 256, local and global layers), where the
   ``autograd.Function``'s backward (the reference's vjp) must equal
   autograd through ``attention_reference`` bit for bit, and a perturbed
   saved k must be caught.  One case per entry point scales q by 20 so
   that the scores reach the softcap.  Sensitivity checks show
   that the tolerance would catch a dropped softcap, a window or causal
   edge off by one, one key lost from kv_len and one decode split's
   partial lost in the merge.  Then each entry point's grid (and for
   decode its clusters against how many the card holds at once) and its
   time at the fixed-round shape (decode also at the continuous run's B 8
   and B 1, S 97) beside its plain version, its bound and one PyTorch
   library call (``scaled_dot_product_attention``, without softcap: not
   the same function, a yardstick only — the port never calls it), all
   as device time (prefill also at the gemma2 training shape, B 8, T
   256): the calls captured in one CUDA graph and replayed, so that the
   host's cost of a call does not hide a faster kernel (the
   back-to-back time of eager calls is printed beside it).  Then each
   instance of the SSD scan (``SSD_INSTANCES``: mamba2-1.3b's P 64, N 128,
   chunk 256 at its training shape B 8, T 512, H 64; zamba2-7b's P 64, N
   64, chunk 256 at B 8, T 256, H 112; the smoke configs' P 16, N 16,
   chunk 8 at B 16, T 32, H 8; bf16 x/B/C) against ``ssd_reference`` on
   the card within ``ssd_tolerance`` at its training shape, one chunk,
   ragged T, a short T under one chunk, a slow-decay case of four chunks
   where the carry between chunks matters, and dt x 10 so that exp(cum)
   underflows inside a chunk; on the slow-decay case the plain faulty
   variant without a fault must agree, and sensitivity checks show the
   bound catches a dropped inter-chunk carry, a causal mask off by one, dt
   left out of M and an undecayed state; then its grid against how many
   blocks the card holds at once, and its time at the training shape as
   device time (a replayed CUDA graph of the calls; the back-to-back time
   of eager calls beside it) beside its plain version and its bound (bytes
   at 3.35 TB/s against flops at the bf16 tensor-core rate; no single
   PyTorch call computes the scan: library_ms null).  Then the two
   full-width instances element by element against an f64 oracle of the
   same math at their training shapes (``ssd_f64_check``): the quantiles
   of |err| / bound of y and of the state beside the plain f32 version's,
   and zamba2-7b's (64, 64, 256) instance's distribution against
   mamba2-1.3b's (``SSD_F64_MATCH``).  Then the
   sum-tree sampler (``tree_sample_blocked``, csrc/sum_tree.cu) against its
   plain version (``sample_plain``) and the f64 flat oracle on sum trees at
   the rainbow example's shape (8192 leaves, batch 64), the replay bench's
   (2^14, 2^17, 2^20 leaves x 256) and the edges of the kernel's layout
   (``ST_SHAPES``: one block, 2048 and 8192 blocks, batches 1, 5 and 33)
   and the mesh phase's per-rank shape (4096 leaves, 32 samples),
   and through ``sample_blocked`` directly at block sizes 1 to 512 and on
   leaves 4 bytes off 16-byte alignment (``ST_EDGES``): exactly on integer
   priorities (u on boundaries, below 0, at and beyond the total, runs of
   zero leaves, a zero block), kernel == plain bit for bit there, by the
   rounding rule of ``kernels/sum_tree/ref.agreement`` on real ones;
   sensitivity checks show the checks catch '<' for '<=', a dropped clamp,
   a residual that keeps the block base and a total taken from a stale
   root; then its time at the example's shape, at 2^17 x 256 and at 2^20 x
   64 (``ST_TIMED``) as device time (a replayed CUDA graph, the eager time
   beside it) beside its plain version, its bound (bytes), the launch floor
   (a replayed graph of as many one-element ``add_`` launches) and a
   PyTorch yardstick of two calls (``cumsum`` + ``searchsorted``, which
   the port never calls);
3b. instance phase: every attention instance beside gemma2-2b's against
   ``attention_reference`` within ``TOL``, each at its config's serving
   shape (``SLICE6``: qwen2-moe-a2.7b dh 128 G 1, mixtral-8x7b dh 128 G 4
   window 4096, glm4-9b dh 128 G 16, phi3-mini-3.8b dh 96 G 1, granite-34b
   dh 128 G 48 at prefill B 8, T 1024 and decode B 8, S 1089 with ragged
   kv_len; ``SMOKE6``: the smoke qwen2-moe, mixtral (window 16, under one
   64-key tile) and granite, dh 16 with G 1, 2 and 4 at B 8, T 64, S 97;
   ``SLICE7``: zamba2-7b dh 112 G 1 and llama-3.2-vision-90b dh 128 G 8
   (H 64, Hkv 8) at T 1024, S 1089, whisper-medium dh 64 G 1 at T 384,
   S 449; ``TP_INSTANCES``: a granite-34b rank of a model axis of 2 and
   4, dh 128 G 24 and G 12 with its one KV head, at T 1024, S 1089),
   at the continuous run's B 1 prompts and B 8 / B 1 decode steps, with
   the softcap reached (q x 20), and for decode at kv_len on every
   boundary of the split plan +-1 and at kv_len 1; the sensitivity checks
   (softcap dropped, causal edge one key late, window one key wider, one
   key lost, one split lost in the merge) at dh 128 G 1 and G 16, at dh 16
   and at each slice-7 instance; then each instance's time at each serving
   shape as a replayed
   graph beside its plain version, its bound and SDPA, and the decode
   grid against the clusters the card holds at once;
3c. the entry points' smoke configs on the card: ``train --arch
   whisper-medium`` must be refused before any weight is drawn (the
   launcher passes no encoder frames, as JAX's, whose train fails on
   ``enc_frames=None``); ``train.main``'s default (smoke gemma2-2b) and
   ``train --arch`` qwen2-moe-a2.7b, mamba2-1.3b and zamba2-7b take three
   PPO steps, ``serve --arch`` gemma2-2b, granite-34b, zamba2-7b,
   whisper-medium and llama-3.2-vision-90b serve one round and the
   ``serve_decode`` twin's default (smoke mixtral-8x7b) its three, each
   launching its d_head 16 instances exactly once an attention site a
   prefill, a training forward and a decode step and the SSD scan (P 16,
   N 16, chunk 8) once a Mamba-2 layer a training forward;
   ``serve.main``'s default (smoke mamba2-1.3b, no kernel on its path)
   serves one round and launches nothing;
4. slice phase, fixed rounds: full-width gemma2-2b with random bf16 weights
   from a seeded generator on the card, through ``repro_torch.launch.serve
   .main`` (batch 8, prompt 1024, gen 64, two rounds); both kernel entry
   points must launch.  The same weights and prompts then run once with the
   kernels and once with ``--kernels ref``: prefill's last logits and the
   first decode step's logits must agree within LOGIT_TOL, and the greedy
   tokens' agreement over 64 steps is printed;
5. slice phase, continuous: 16 Poisson requests over 8 slots (prompts 8-64,
   gen 4-32) through ``serve.main --continuous``; every request must get
   its max_tokens;
5b. slice phase, the moe family and the other dense configs, at full
   width with random bf16 weights through ``serve.main --full``:
   qwen2-moe-a2.7b (the slice's main path: 24 layers, 60 routed experts
   top-4 and 4 shared) two fixed rounds at B 8, prompt 1024, gen 64 and
   the continuous run of phase 5; mixtral-8x7b (cut to 8 of 32 layers),
   glm4-9b, phi3-mini-3.8b and granite-34b (cut to 24 of 88 layers) one
   round each (``DEPTH_CUT``, ``--layers``): both entry points launch
   exactly once a layer a prefill and a decode step, peak memory, the
   prefill time and the decode step's wall printed; then each config's
   route check at ``ROUTE_LAYERS`` layers against ``--kernels ref`` on the
   same weights and prompts (dense: prefill and first-step logits within
   LOGIT_TOL; moe: see ``moe_route_check`` and ``ROUTE_AGREE_MARGIN``);
5c. slice phase, the hybrid, vlm and encdec families at full width
   (``SLICE7``) through ``serve.main --full``: zamba2-7b (the slice's main
   path: 81 layers, 13 sites of the shared attention block, dh 112) two
   fixed rounds at B 8, prompt 1024, gen 64 and the continuous run of
   phase 5; whisper-medium (B 8, prompt 384, gen 64, 1500 zero frames) and
   llama-3.2-vision-90b (cut to 20 of 100 layers, 1600 zero image tokens)
   one round each: both entry points launch exactly once an attention site
   a prefill and a decode step, the SSD scan never; peak memory, prefill
   time and decode-step wall; then each config's route check against
   ``--kernels ref`` at ``ROUTE_CUT`` layers (prefill and first-step logits
   within LOGIT_TOL);
6b. slice phase, training: zamba2-7b at full width cut to 15 layers
   (``TRAIN7``: 2 superblocks and the 3 tail layers) through ``train.main
   --layers 15``, two PPO steps at B 8, horizon 256: ``ssd_scan`` (P 64,
   N 64) exactly 2 x 15 an update (forward and recompute), the shared
   block's attention 2 x 2 an update and 2 a rollout step, every metric
   finite, peak memory; then ``train_checks`` against ``ssd=ref`` within
   ``TRAIN7_TOL`` at 7 layers (one superblock and a tail layer) and at
   15;
6a. slice phase, training: full-width gemma2-2b (26 layers, d_model 2304,
   vocab 256 000, 3.204 B parameters as f32 master weights from a seeded
   generator, bf16 compute; the token env's table-free chain) through
   ``train.main``'s default arch (``--full``, batch 8, horizon 256, two PPO
   steps): ``flash_attn_fwd`` launches exactly 2 x 26 an update (forward
   and the recompute of each checkpointed superblock) and
   ``flash_attn_decode`` 26 a rollout step (257 a rollout), peak memory <=
   ``PEAK_GIB``, every metric finite; then ``train_checks`` with
   ``attention=ref`` as the plain route, within ``GEMMA_TRAIN_TOL``, at a
   4-layer cut and at 26 layers (as phase 6);
5a. slice phase, serving the default arch: full-width mamba2-1.3b
   (``serve.main --full``: fixed rounds at batch 8, prompt 1024, gen 64,
   two rounds, then the continuous run of phase 5): every request served,
   no kernel launched (the prefill passes the cache's state, so the scan
   is the plain chunked one, as in JAX); at a 4-layer cut the prefill's
   last logits and states against a token-by-token ``decode_step``
   teacher-force of the first round's prompts within
   ``SSM_PREFILL_TOL``;
6. slice phase, training: full-width mamba2-1.3b (d_model 2048, cut from
   48 layers to 24, random f32 master weights from a seeded generator, bf16
   compute) through ``repro_torch.launch.train.main --layers 24`` (batch 8,
   horizon 512, two PPO steps of rollout + GAE + Adam update); the SSD
   kernel must launch exactly 2 x 24 an update and every logged metric be
   finite.  Then, on the same weights and first rollout, at 24 layers and
   at a 4-layer depth cut of the same width: the
   serve-path logp (decode_step, no kernel) against the train-path logp
   (forward_train through the kernel), both against the plain route's
   (``ssd=ref``) on the same data, and the kernel route against
   ``ssd=ref`` in loss and grad_norm of one update, within ``TRAIN_TOL``;
7. slice phase, RL: prioritized DQN on Catch through
   ``python -m repro_torch.examples.catch_dqn_variants --variant rainbow``'s
   ``main`` at the example's settings (16 envs x horizon 16, capacity 8192,
   batch 64, 2 updates a collect, 150 iterations, warm-up 512, epsilon
   0.2); the sum-tree kernel must launch on every prioritized sample (300)
   and every logged number be finite.  Then the learning bar of
   tests/test_learning.py::test_dqn_learns_catch (dueling + double +
   prioritized, 200 iterations, 4 updates a collect): a greedy evaluation
   of 4 collects must reach avg_return > 0 (a random policy scores about
   -0.6).  Then the rainbow configuration at rlpyt's Atari replay scale
   (capacity 2^20, 0.43 GB of Catch transitions on the card; warm-up 512,
   20 iterations), where the kernel samples over 2048 blocks;
8. slice phase, PG: PPO on CartPole through ``python -m
   repro_torch.examples.quickstart``'s ``main`` at its settings (16 envs x
   horizon 64, 4 epochs x 4 minibatches, 20 iterations (the example runs
   50; cut to keep the script's time), a row every 10,
   an EvalSampler of 8 greedy envs, sentinels): every logged number
   finite, ``sent_nonfinite_params`` 0 and ``eval_avg_return`` in every
   row; no kernel launches on this path (it runs none).  Then the two
   CartPole bars of tests/test_learning.py at seed 0, scored by 8
   stochastic collects of the training sampler: PPO after 60 iterations >
   100, A2C after 80 (horizon 32, GAE lambda 0.95) > 50;
9. slice phase, QPG: DDPG, TD3 and SAC on Pendulum through
   ``repro_torch.examples.pendulum_qpg``'s ``make_runner`` (the JAX
   factories' width: hidden 256 x 256, twin critics; 8 envs x horizon 32,
   capacity 2^20 (rlpyt's 1e6 MuJoCo replay rounded up), batch 256, warm-up
   1024, 10 iterations of 8 updates): every logged number, param and
   target finite, TD3's actor bit-unchanged by every odd update and moved
   by the even ones, SAC's alpha finite and positive, no kernel launched
   (uniform replay).  TD3 and SAC again with ``prioritized=True`` (10
   iterations): one ``sum_tree_sample`` launch per replay sample.  Then the
   SAC bar of tests/test_learning.py at seed 0 (hidden 64, capacity 16384,
   batch 128, 160 iterations of 32 updates, init_alpha 0.2): the initial
   policy's return below -500 and the trained one's above it + 100.  Then
   checkpoints on the card: a SAC runner of 4 iterations saving every 2,
   its train and replay states restored onto the card bit for bit, and a
   second runner given ``restore=True`` and 6 iterations resuming at 4 and
   ending at step 6 x 8;
10. slice phase, R2D1: the ``repro_torch.examples.r2d1_recurrent`` twin at
   its settings through ``make_runner`` (Catch, 16 envs x horizon 8 in two
   alternating groups, d_lstm 64, conv (16, 32), sequence replay 2048 x 16,
   seq_len 16, burn-in 4, state_interval 8, batch 32, replay ratio 2,
   warm-up 512, 120 iterations, threaded ``AsyncR2D1Runner``): every logged
   number finite, updates > 0, ``replay_ratio_actual`` <= 2, sequence
   priorities moved off their initial 1.0, no kernel launched.  Then the
   same stack twice in lockstep (``threaded=False``, 24 iterations, seed 0,
   ``cudnn.deterministic``): the final params bit-identical.  Then one R2D1
   learner update at the JAX factories' full width (``make_recurrent_q``
   defaults: d_lstm 256, conv (32, 64, 64) / (8, 4, 3) / (4, 2, 1), 512,
   dueling, 84 x 84 x 4, 18 actions; ``R2D1`` defaults: burn-in 40, n_step
   5, gamma 0.997; seq_len 80, batch 64 sequences drawn on the card): its
   wall over 10 updates after a warm-up, finite loss, priorities of shape
   (64,), peak memory;
11. slice phase, async: the ``repro_torch.examples.mujoco_style_sac`` twin
   at its settings (SAC, hidden 64, 8 envs x 32, host
   ``UniformReplayBuffer`` 8192 x 8 with the next obs, batch 128, replay
   ratio 8, warm-up 1024, 150 iterations, threaded ``AsyncRunner``):
   every number finite, ``replay_ratio_actual`` <= 8, ``publish_version``
   == updates / ``publish_interval``, no kernel launched; its
   ``samples_per_sec``, ``overlap_frac`` and staleness.  Then async A2C on
   CartPole in lockstep at staleness 0 with V-trace against ``TrainLoop``
   on one seed (params within 1e-4, JAX's bound), and an R2D1 checkpoint
   with its replay sidecar saved on the card and restored (buffer and
   train state bit for bit, resumed at the saved iteration, then run on);
11b. slice phase, the data-parallel mesh: two gloo ranks on cuda:0 spawned
   by ``launch.mesh.spawn_ranks`` (a rank's exception, death or the
   phase's deadline ends the script non-zero), ``fuse=False`` (a gloo
   all-reduce cannot sit in a CUDA graph).  First each collective the mesh
   uses on CUDA tensors (all-reduce SUM of f32 and int32, MAX, the byte
   all-gather of f32 and bool), exactly.  (a) A2C on CartPole through
   ``ShardedSampler(8 envs x 16)`` and ``TrainLoop(mesh=...)``, 20
   iterations, against the one-process loop on the same global batch at
   JAX's bounds (params atol 2e-5 / rtol 2e-4, every loss 1e-4); (b) the
   same with ``compress="int8_ef"`` and sentinels, 10 iterations: params
   finite, ``sent_compress_err_norm`` and ``sent_grad_norm_shard_max`` >
   0, ``sent_nonfinite_params`` 0, one residual slice a rank; (c)
   prioritized DQN on Catch through ``OffPolicyRunner(mesh=...)`` at the
   rainbow example's width (30 iterations, a ring of 4096 and 32 samples
   an update a rank): ``sum_tree_sample`` launched on each rank for every
   prioritized sample, ``td_abs`` gathered to the global batch (64,),
   params replicated, and the kernel held against ``sample_plain`` and
   the f64 oracle on each rank's own tree after the run at that shape;
   then the Catch bar on the mesh (dueling + double +
   prioritized, 200 iterations x 4 updates): greedy avg_return > 0; (d)
   the checkpoint of (c), saved on 2 ranks, restored on each rank
   (``shardings=``) and whole in one process, bit for bit.  Each rank's
   A2C iteration wall and the host time of its gradient all-reduce are
   printed with the card's name and power limit;
11c. slice phase, the LM mesh's data axis: two gloo ranks on cuda:0
   (``spawn_ranks``), each running ``train.main --mesh 2x1`` on the group
   the spawn initialized (``LM_MESH``): (a) gemma2-2b at full width cut to
   4 layers with ``--compress`` (int8 error feedback, one scale a JAX
   leaf), B 8 (4 a rank) x horizon 64, two steps; (b) mamba2-1.3b at full
   width cut to 24 layers, uncompressed, B 8 x horizon 256 (the built
   (64, 128, 256) SSD instance), two steps: each rank's launches equal
   the counts its layers, horizon and steps imply (``flash_attn_fwd`` 2 an
   attention site an update, ``flash_attn_decode`` one an attention site a
   rollout step, ``ssd_scan`` 2 a Mamba-2 layer an update), every row
   finite with JAX's keys (and ``compress_err_norm`` > 0), each rank's
   rollout_s, update_s, gradient all-reduce host time and
   ``max_memory_allocated`` printed; (c) on a fixed batch of 8 rows (the
   advantages normalised over each rank's 4): one uncompressed update on
   the ranks against the whole batch in one process, the gradient (sgd(0)'s
   momentum buffer) within twice what rounding alone moves it (the whole
   batch against its two halves, ``tools/train_route_spread.py``'s
   method), the loss likewise; (d) one ``int8_ef`` update on the same
   batch: the applied gradient within half the mean over ranks of each
   rank's int8 scale of the uncompressed pmean, element by element, plus
   f32 slack (``LM_MESH_EF_BOUND``: round to nearest, the residual 0 at the
   first step), the residual's norm finite and non-zero;
11d. slice phase, the LM mesh's 'model' axis: gloo ranks sharing cuda:0
   run ``train.main --mesh DxM`` (``LM_TP``): two ranks (a)
   qwen2-moe-a2.7b 1 x 2 at 4 layers, (b) mamba2-1.3b 1 x 2 at 4 and
   granite-34b 1 x 2 at 2 (its (128, 24) decode instance); four ranks (c)
   gemma2-2b 2 x 2 ``--compress`` at 4 and granite-34b 1 x 4 at 2 (its
   (128, 12)), two steps each at full width: launches as their layers,
   horizon and steps imply, rows finite with ``tp_allreduce_s``, the
   ranks' peaks summing to at most ``PEAK_GIB``, the replicated leaves
   equal bit for bit on a model group and its rollout's actions too; for
   (a)-(c) on a fixed batch the ranks' update (bf16, the kernels) against
   one process's at the same depth, the gradient and the loss within
   twice what rounding alone moves the one-process update (bf16 against
   f32 compute), where (b)'s split-use leaves left unsummed must fail;
   (c)'s int8 update, the same pass, within ``LM_MESH_EF_BOUND`` of the
   mean scale;
11e. slice phase, NCCL collectives in a CUDA graph: one spawned rank, a
   world-1 NCCL group on cuda:0 (``spawn_ranks(fn, 1, device="cuda")``),
   captures a ``StepGraph`` body that calls ``dist.all_reduce`` and
   ``dist.all_gather_into_tensor`` inside the mesh's event timing, and
   replays it 100 times on inputs that change between replays: each
   replay equal to an eager call of the body on the same inputs bit for
   bit (the eager calls on the same communicator between the replays),
   the captured collectives' event time finite and positive; then a gloo
   group on the same card must refuse the capture (``DataMesh.
   _refuse_capture``).  ``DataMesh``'s own collectives send nothing on one
   rank, so this phase holds the capture machinery on the installed torch
   and NCCL, not agreement across ranks: that is the four-card proof
   (``tools/chip_phases.py mesh4``, ``mesh4_phase``: ``TrainLoop(mesh=,
   fuse=True)`` and the graphed model-axis rollout on four NCCL ranks,
   not part of this script's run);
12. on the same weights (drawn again), a ``torch.profiler`` pass measures
   the device's busy time per prefill, per decode step (gemma2-2b, then
   qwen2-moe-a2.7b and zamba2-7b at full width), per rollout of
   ROLL_STEPS steps and per PPO update (gemma2-2b, mamba2-1.3b and
   zamba2-7b at their phases' depths), per RL
   iteration, per PPO CartPole iteration, per SAC
   update (at the bar's width and at full width), per full-width R2D1
   update and per async SAC learner update against
   the unprofiled wall time of the same work (the idle share), and checks
   that prefill and a decode step run exactly one attention kernel an
   attention site
   (printing its device time a launch), lists each kernel launch of one
   ssd_scan call at the training shape with its device time, and gives the
   sum-tree kernel's device time a launch at ``ST_TIMED`` — last, since the
   profiler slows every later launch of the process;
Every path that the JAX package compiles as one program runs on the card
as a CUDA graph replay (core/graphs.py): serve's decode step, the engine's
decode block, the rollout step and the TrainLoop iteration (``fuse=True``,
the default), so the phases above drive them through graphs, and each
kernel's launch count stays exact under replay (a replay adds the launches
its capture recorded).  The graph checks, on the weights each phase has
drawn: in phase 4, gemma2-2b's fixed rounds (two rounds, sampled at
temperature 1 from one generator) and the continuous trace (offline, so
both runs admit alike) with the decode replayed from graphs against eager:
tokens bit for bit, launches exact; in phase 5a the same for mamba2-1.3b's
fixed rounds; in phase 6a ``train --fuse-window 2`` against the two unfused
steps (params bit for bit on the host, one log row with JAX's keys), then
two gemma2-2b rollouts (B 8, horizon 256) replayed against eager (every
leaf of the trajectory and v_last bit for bit); in phases 7-9 the rainbow
example (60 iterations, across its first target copy), the quickstart (10)
and DDPG, TD3 and SAC (10) fused against ``fuse=False``: after every
iteration every state leaf, generator state and info bit for bit.  Each
path's wall a step or an iteration, eager beside graph, is printed at the
end with the card's name and power limit; the profile phase gives each
one's device busy time and idle share (the replays of the rollouts and RL
iterations profiled, the eager side printed beside their busy time; for
serving, the eager decode profiled and 8 replayed steps beside it: a
graph replays the eager step's kernels);
13. each phase's wall time, the ``kernels`` JSON line (launch counts from
   phases 4-7, 6a, 9, 11b (both ranks' ``sum_tree_sample``
   launches), 11c and 11d (every rank's attention and SSD launches), the
   largest error of phase 3, times at the
   serving shape; phases 5a, 8, 10 and 11 launch none; one entry an
   instance of phase 3b, its launches from phases 3c, 5b, 5c and 6b, timed
   at the first config that runs it; one entry an SSD instance, its
   launches from phases 3c, 6b and 6), then ``{"ok": true, "device":
   {...}}`` last.
"""
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0
# |kernel - attention_reference| <= atol + rtol * |reference|, per entry
# point.  Decode keeps P in f32 like the plain version, so the two differ by
# at most one bf16 rounding of the output (rtol 2^-7 covers one ulp at any
# magnitude).  Prefill also rounds P to bf16 for the P.V product: up to
# 2^-9 of each p_i |v_i|, a few 1e-3 on rows of few keys whatever the
# output's size, so its atol is 8e-3 and its rtol two ulps.  The share of
# each bound that the kernels use on the H100 is in PERF.md.
TOL = {"flash_attn_fwd": (8e-3, 1.6e-2), "flash_attn_decode": (1e-3, 8e-3)}
# the continuous run's traffic (phase 5); its shapes are checked in phase 3
CONT = {"requests": 16, "slots": 8, "prompt_min": 8, "prompt_len": 64,
        "gen_min": 4, "gen": 32, "rate": 16.0}
# kernel route vs --kernels ref at full width, bf16 logits (|logit| <= 30
# after the softcap): both routes round attention to bf16 at other places
# and the difference passes through 26 layers of random weights.
LOGIT_TOL = 0.25
# slice 6: the configs whose attention instances run beside gemma2-2b's (dh
# 256, G 2), served at full width (random bf16 weights) with the fixed
# rounds' shape, B 8, prompt 1024, gen 64 (decode S 1089); qwen2-moe-a2.7b,
# the slice's main path, at full depth, fixed rounds and the continuous run
# of CONT; the others one round each, two cut in depth to fit one 80 GB
# card (88.0 GiB of granite-34b and 87.0 GiB of mixtral-8x7b bf16 weights
# at full depth; DEPTH_CUT keeps 24.8 and 22.1 GiB).
SLICE6 = ("qwen2-moe-a2.7b", "mixtral-8x7b", "glm4-9b", "phi3-mini-3.8b",
          "granite-34b")
SERVE6 = {"batch": 8, "prompt_len": 1024, "gen": 64}
DEPTH_CUT = {"mixtral-8x7b": 8, "granite-34b": 24}
# ... and the smoke configs that hold the d_head 16 instances (decode G 1,
# 2 and 4) at serve's default shape (B 8, prompt 64, gen 32: S 97)
SMOKE6 = ("qwen2-moe-a2.7b", "mixtral-8x7b", "granite-34b")
SMOKE_SERVE = {"batch": 8, "prompt_len": 64, "gen": 32}
# the route check of each slice-6 config (kernel route vs --kernels ref on
# the same weights and prompts) at ROUTE_LAYERS layers of the full width,
# bf16 logits within LOGIT_TOL.  In a moe layer the two routes' rounding
# can move a router input across a near-tie and send a token to another
# expert, and the token's later layers then see other inputs; the logits
# are compared on the tokens whose top-k sets (and kept choices) agree in
# every layer, as do those of the earlier tokens of their sequence that
# causal attention reads.  The share of (token, layer) routings that agree
# is set by rounding alone, not by the kernel: on an H100 at 4 layers,
# B 8 x 1024, qwen2-moe's kernel route agreed with the ref route on
# 0.8961 (0.968, 0.920, 0.871, 0.826 by layer) and the kernel's plain
# version (attention_reference in its place) on 0.8999; mixtral's on
# 0.9740 and 0.9746; a route whose causal edge lets each query see one key
# ahead agreed on 0.554 and 0.810.  So the kernel route's share must reach
# the plain version's, measured in the same run, less ROUTE_AGREE_MARGIN,
# and that faulty route must fall below the same bound.
ROUTE_LAYERS = 4
ROUTE_AGREE_MARGIN = 0.02
# slice 7: the hybrid, vlm and encdec configs at full width (random bf16
# weights): zamba2-7b, the slice's main path, at full depth (81 layers: 13
# sites of the shared attention block), fixed rounds and the continuous run
# of CONT; whisper-medium (prompt 384 + gen 64: its 448 text positions,
# 1500 zero frames) and llama-3.2-vision-90b (cut to 4 of 20 superblocks:
# 163.3 GiB of bf16 weights at full depth; 1600 zero image tokens) one
# round each.  Their route checks run at a cut that holds one superblock
# (zamba2: 6 Mamba-2 layers, the shared block and a tail layer; vlm: 4 self
# layers and a cross layer) or 4 decoder layers (whisper).
SLICE7 = ("zamba2-7b", "whisper-medium", "llama-3.2-vision-90b")
SERVE7 = {"zamba2-7b": SERVE6,
          "whisper-medium": {"batch": 8, "prompt_len": 384, "gen": 64},
          "llama-3.2-vision-90b": SERVE6}
DEPTH_CUT["llama-3.2-vision-90b"] = 20
ROUTE_CUT = {"zamba2-7b": 7, "whisper-medium": 4, "llama-3.2-vision-90b": 5}
# zamba2-7b's LM-PPO training at full width, cut from 81 layers to 15 (2
# superblocks and the 3 tail layers, 1.6 B parameters: 26 GiB of f32
# weights, gradients and Adam moments; 100.6 GiB at full depth), through
# ``train --layers 15``.  Its checks, as phase 6's, at two cuts, on limits
# set from tools/train_route_spread.py on the card (the same weights, first
# rollout and update under other routes; the plain SSD scan at half the
# chunk is another order of the same f32 sums, so what it moves, rounding
# alone moves):
# - one superblock and a tail layer (7 layers): the kernel route's loss
#   7.4e-6 and grad_norm 9.8e-2 from ssd=ref's, where the half chunk alone
#   moves them 1.5e-5 and 0.158 (the whole gradient 0.70 of its norm, the
#   kernel 0.60).  Held: loss 2e-3 relative (mamba2's 4-layer limit),
#   grad_norm 0.3 (about twice what rounding alone moved), the mean
#   serve-vs-train gap 0.1 (0.043 through the kernel, 0.040 plain);
# - the 15 layers trained: the loss at 1e-3 relative (2.5e-5 through the
#   kernel, 8.9e-5 at the half chunk; gemma2's limit), grad_norm printed
#   only (the attention route alone moves it 0.75: chaotic in depth, as
#   mamba2's 48 layers).
TRAIN7 = {"batch": 8, "horizon": 256, "steps": 2, "layers": 15}
TRAIN7_TOL = {
    15: {"logp_mean": 1.0, "loss_rel": 1e-3, "grad_norm_rel": None},
    7: {"logp_mean": 0.1, "loss_rel": 2e-3, "grad_norm_rel": 0.3}}
# SSD scan (csrc/ssd_scan.cu) against ssd_reference: both compute in f32
# and round y to bf16 once, so they differ by the order of f32 sums, by
# the rounding of the chunk cumsum, by the kernel's f32 operands entering
# the tensor cores as hi / lo bf16 pairs (at most 2^-17 of each operand
# left out), and by one bf16 spacing of y where the two f32 values
# straddle a rounding point.  Per element:
#   |y - y_ref| <= 2^-7 |y_ref| + eps * y_abs,   |S - S_ref| <= eps * S_abs,
#   eps = 2^-14 + 2^-19 * max|cum|,
# where y_abs, S_abs are ssd_reference of |x|, dt, A, |B|, |C| (the sum of
# the magnitudes of every term) and max|cum| is the largest |cumsum(dt*A)|
# within a chunk: 2^-14 covers f32 sums of <= 512 terms and the hi / lo
# residue with margin, and
# 2^-19 * max|cum| eight roundings of the cumsum on each side (an absolute
# error in cum_q - cum_k is a relative error of exp(cum_q - cum_k)).
SSD_TPU_KERNEL = "src/repro/kernels/ssd_scan/ssd_scan.py:69"
# the SSD scan's instances, by kernels-line name (mamba2-1.3b's keeps the
# bare name): (P, N, chunk, H, B, T) of the training shape that runs it, the
# batch of its edge cases, and its configs: mamba2-1.3b's LM-PPO update (64
# heads, horizon 512), zamba2-7b's (112 heads, horizon 256), the smoke
# configs' (train's default batch 16 and horizon 32)
SSD_INSTANCES = {
    "ssd_scan": (64, 128, 256, 64, 8, 512, 8, "mamba2-1.3b"),
    "ssd_scan P64 N64": (64, 64, 256, 112, 8, 256, 2, "zamba2-7b"),
    "ssd_scan P16 N16": (16, 16, 8, 8, 16, 32, 2, "smoke mamba2 / zamba2")}
SSD_SOURCE = "src/repro_torch/csrc/ssd_scan.cu"
# the f64 check of the two full-width instances (ssd_f64_check): zamba2's
# kernel-over-plain error ratio at each quantile may exceed mamba2's (or 1)
# by at most this factor before its instance counts as faulty
SSD_F64_MATCH = 2.0
# the training slice (phase 6).  The random-weight model amplifies bf16
# rounding through depth (CPU calibration at full width: serve-path and
# train-path logp agree within 2e-3 in f32 at 48 layers, but differ by 0.52
# mean in bf16; reordering the SSD's f32 sums moves grad_norm 2-5x at 48
# layers and <= 2.4 % at 4).  So, on the same weights and first rollout:
# - the mean |serve logp - train logp| through the kernel is held absolutely
#   (fixed before the first chip run from that calibration);
# - the kernel route is held against the plain route (ssd=ref) on the same
#   data: its serve-vs-train gap within 1.25x (mean) and 2x (max) of the
#   plain route's, and its own distance from the plain route's train logp
#   within 1.5x (mean) and 2x (max) of the plain route's serve-vs-train gap
#   -- the kernel is then no worse than rounding.  Amplified through depth,
#   any rounding difference reaches about the same gap (4 layers on the
#   card: 0.0105, 0.0103 and 0.0096 mean), hence the margins;
# - loss and grad_norm of one update, kernel route vs ssd=ref: grad_norm
#   held at the 4-layer cut only, printed at the deep one.
# (A first design held the max |serve - train| at 0.5 (4 layers) and 6.0
# (48 layers) from a 640-sample CPU calibration; the card's 4096 samples
# gave 0.528 at 4 layers with the mean at 0.0105, and the plain route on
# the same data 0.576 (mean 0.0103).  See PERF.md, PR 12.)
# The run is cut from 48 layers to 24 (``train --layers 24``) to keep the
# script's time; the 48-layer limits hold at 24, where the gaps they bound
# are smaller.
TRAIN_TOL = {24: {"logp_mean": 1.0, "loss_rel": 5e-2, "grad_norm_rel": None},
             4: {"logp_mean": 5e-2, "loss_rel": 2e-3, "grad_norm_rel": 5e-2}}
TRAIN = {"batch": 8, "horizon": 512, "steps": 2, "layers": 24}
# the gemma2-2b training slice (phase 6a).  Sized for one 80 GB card: f32
# master weights, gradients and two Adam moments are 16 B a parameter, 51.3
# GB for 3.204 B, and the logits chain over B x T x 256 000 costs about 30
# B an element, 16 GB at B 8 x T 256 (31 GB at T 512 would not fit).
# PEAK_GIB is the limit of the run's max_memory_allocated; above it the
# horizon is halved, never a width or the depth.
GEMMA_TRAIN = {"batch": 8, "horizon": 256, "steps": 2, "graph_checks": True}
PEAK_GIB = 76.0
# Its checks, kernel route (flash_attn_fwd forward and recompute, the
# reference's vjp backward, flash_attn_decode in the rollout) against
# attention=ref on the same weights and first rollout.  gemma2 is not
# chaotic in depth as mamba2 is (post-norms and softcaps): on the CPU,
# before the first chip run, at d_model 576 (a quarter of the width) with
# the vocabulary, batch 2 x horizon 64, seeds 0 and 1, the routes' plain
# versions gave a mean |serve logp - train logp| of 0.0018-0.0026 (the
# reference route) and 0.0082-0.0090 (the chunked ref route, which rounds P
# to bf16 as the kernel does) at 4 layers, 0.0077-0.0099 and 0.0156-0.0157
# at 26; loss within 1.3e-5 and grad_norm within 1.7e-4 relative.  So:
# - 4 layers: the mean gap through the kernel held absolutely at 5e-2
#   (5x the ref route's), loss at 1e-3 and grad_norm at 1e-2 relative
#   (60x-250x the measured: the card's products round in other orders);
# - 26 layers: held relative to the ref route as phase 6 does (the kernel
#   route's gap within 1.25x / 2x of the ref route's mean / max, its
#   distance from the ref route's train logp within 1.5x / 2x), the mean
#   gap at 0.1, loss at 1e-3 and grad_norm at 2e-2.
GEMMA_TRAIN_TOL = {
    26: {"logp_mean": 0.1, "loss_rel": 1e-3, "grad_norm_rel": 2e-2},
    4: {"logp_mean": 5e-2, "loss_rel": 1e-3, "grad_norm_rel": 1e-2}}
# mamba2-1.3b serving (phase 5a): the fixed rounds' shape; its prefill takes
# the plain chunked scan (the cache's state passed in), so no kernel runs.
# At a 4-layer cut the prefill's last logits, conv and SSM states are held
# against a token-by-token decode_step teacher-force of the same prompt,
# each as max |diff| / max |teacher-forced|: both paths round to bf16 at
# other places (the scan keeps a chunk's y in f32, the recurrence rounds
# every step) through 4 layers and 1 024 steps of state.  On the CPU at full
# width (B 2, T 1024, seeds 0 and 1): logits 0.009-0.020, conv 0.018-0.019,
# ssm 0.016-0.022 (5 bf16 spacings of the largest entry); the bound is 8e-2,
# about 20 spacings.
SSM_SERVE = {"batch": 8, "prompt_len": 1024, "gen": 64, "rounds": 2}
SSM_PREFILL_TOL = 8e-2
ROLL_STEPS = 8   # decode steps of the rollout the profile phase measures
# the sum-tree sampler (phase 3) and the RL slice (phase 7)
ST_TPU_KERNEL = "src/repro/kernels/sum_tree/sum_tree.py:49"
ST_SOURCE = "src/repro_torch/csrc/sum_tree.cu"
# correctness, (leaves, samples) of sum trees read through
# tree_sample_blocked: the rainbow example's tree, the replay bench's, then
# one block, 2048 blocks at the rainbow batch, 8192 blocks, batches that
# leave a block of four samples part-empty, and a rank's tree and batch in
# the mesh phase (the rainbow example's halved over two ranks)
ST_SHAPES = [(8192, 64), (2 ** 14, 256), (2 ** 17, 256), (2 ** 20, 256),
             (512, 5), (2 ** 20, 64), (2 ** 22, 33), (8192, 1), (8192, 33),
             (4096, 32)]
# ... and (n_blocks, bs, samples, offset) through sample_blocked directly:
# block sizes the tree never gives, and leaves ``offset`` floats into their
# buffer, 4 bytes off 16-byte alignment (the kernel's scalar-load path)
ST_EDGES = [(2048, 1, 33, 0), (16, 16, 5, 0), (16, 100, 64, 0),
            (3, 100, 256, 1), (4, 256, 1, 0), (1, 256, 33, 0),
            (4, 256, 64, 1), (16, 512, 64, 1), (8192, 16, 256, 0),
            (5, 132, 40, 0)]
# timing, (leaves, samples): the rainbow example's tree (the main path),
# the replay bench's, rlpyt's Atari replay (2^20) at the rainbow batch
ST_TIMED = [(8192, 64), (2 ** 17, 256), (2 ** 20, 64)]
RL = {"variant": "rainbow", "iters": 100, "bar_iters": 200, "bar_updates": 4,
      "big_capacity": 2 ** 20, "big_iters": 20, "profile_iters": 10,
      "identity_iters": 60}
# the quickstart (its own default is 50 iterations)
PG = {"iters": 20, "log_interval": 10, "profile_iters": 5}
# the QPG slice (phase 9): full width (the JAX factories' defaults), the
# prioritized reruns, the checkpoint runs (iterations before / after the
# restore), SAC updates timed a profile
QPG = {"algos": ("ddpg", "td3", "sac"), "iters": 10, "prio_iters": 10,
       "ckpt_iters": (4, 6), "ckpt_interval": 2, "profile_updates": 20,
       "profile_iters": 5}
# the R2D1 slice (phase 10): the r2d1_recurrent twin's iterations (threaded)
# and the lockstep determinism runs; the full-width learner update
R2D1_CFG = {"iters": 120, "lockstep_iters": 24, "lockstep_target_interval": 4}
R2D1_FULL = {"batch": 64, "seq_len": 80, "actions": 18, "d_lstm": 256,
             "warmup": 2, "timed": 10, "profiled": 3}
# the async runner (phase 11): the mujoco_style_sac twin, async A2C at
# staleness 0, the R2D1 checkpoint runs (iterations before / after the
# restore), async SAC learner updates timed a profile
ASYNC = {"sac_iters": 150, "sac_lockstep_iters": 12, "a2c_iters": 6,
         "ckpt_iters": (8, 10), "ckpt_interval": 4, "profile_updates": 20}
# the data-parallel mesh (phase 11b): two gloo ranks on the one card
MESH = {"ranks": 2, "a2c_iters": 20, "compress_iters": 10, "dqn_iters": 30,
        "bar_iters": 200, "bar_updates": 4, "timeout": 600,
        "allreduce_calls": 20}
MESH_A2C_TOL = {"params": (2e-5, 2e-4), "loss": 1e-4}  # JAX's bounds
# the LM mesh (phase 11c): two gloo ranks on the one card train full-width
# gemma2-2b cut to 4 layers (1.49 B parameters, 1.18 B of them the untied
# 256k embedding and lm_head: 6 GB of f32 weights, 12 GB of Adam moments,
# 6 GB of EF residual and a 6 GB gradient a rank) with --compress, and
# mamba2-1.3b at 24 of 48 layers uncompressed (horizon 256: the scan's
# chunk is min(256, T), and only the (64, 128, 256) instance is built);
# the identity and compression checks take LM_MESH_FIXED rows
LM_MESH = {"ranks": 2, "timeout": 600,
           "gemma2": {"arch": "gemma2-2b", "layers": 4, "batch": 8,
                      "horizon": 64, "steps": 2, "compress": True},
           "mamba2": {"arch": "mamba2-1.3b", "layers": 24, "batch": 8,
                      "horizon": 256, "steps": 2, "compress": False}}
LM_MESH_FIXED = 8
# check (d): |applied - pmean| as a share of the ranks' mean int8 scale.
# Round to nearest misses a rank's value by at most half its scale (the
# residual is 0 at the first step), so the mean misses by at most half the
# mean scale; 1e-3 of a scale covers the f32 sums (about 1e-5 of a scale
# at 127 scales a value).  A quantiser that truncates lands near 1.
LM_MESH_EF_BOUND = 0.5 + 1e-3
# the LM mesh's 'model' axis (phase 11d): gloo ranks sharing the one card
# train through train.main --mesh DxM, each rank holding its block of every
# leaf the sharding rules split.  Widths are the published ones; depth is
# cut as far as the ranks' state on one card forces (the ranks' peaks sum
# to at most PEAK_GIB): (a) qwen2-moe-a2.7b at 4 of 24 layers on 1 x 2
# (2.9 B parameters, about 23 GB of f32 weights, gradients and Adam
# moments a rank), (c) gemma2-2b at 4 of 26 on 2 x 2 with --compress;
# (b) mamba2-1.3b on 1 x 2 at horizon 256 (the scan's chunk is min(256,
# T), and only the chunk-256 instances are built) is cut to 4 of 48 layers
# by the phase's time, not its memory: its eager rollout sends 257 x (2 a
# layer + 1) gloo collectives, about 2.5 ms each between two processes on
# one card (at 24 layers the rollout took 50-61 s a step, at 4 layers
# 7.8-8.6 s; the depth returns with the CUDA-graph rollout on NCCL ranks,
# ROADMAP Queue 1 item 4).  granite-34b, one step at 1 of 88 layers on 1 x 2
# and 1 x 4, gives its ranks' decode instances (128, 24) and (128, 12)
# (its one KV head read by 24 and 12 query heads) their main-path launches
# and holds its replicated wk / wv (split-use) equal after the update.
# (a)-(c) hold the checks: the same actions and equal replicated leaves on a
# model group, and the update on a fixed batch of LM_TP_FIXED rows against
# one process's
LM_TP = {"timeout": 600,
         "qwen2": {"arch": "qwen2-moe-a2.7b", "layers": 4, "mesh": (1, 2),
                   "batch": 8, "horizon": 32, "steps": 2, "compress": False},
         "mamba2": {"arch": "mamba2-1.3b", "layers": 4, "mesh": (1, 2),
                    "batch": 8, "horizon": 256, "steps": 2,
                    "compress": False},
         "granite24": {"arch": "granite-34b", "layers": 1, "mesh": (1, 2),
                       "batch": 2, "horizon": 8, "steps": 1,
                       "compress": False},
         "gemma2": {"arch": "gemma2-2b", "layers": 4, "mesh": (2, 2),
                    "batch": 8, "horizon": 64, "steps": 2, "compress": True},
         "granite12": {"arch": "granite-34b", "layers": 1, "mesh": (1, 4),
                       "batch": 2, "horizon": 8, "steps": 1,
                       "compress": False}}
# the decode instances only a model rank runs: granite-34b's one KV head
# read by 24 (1 x 2) and 12 (1 x 4) query heads; phase 3b holds them
TP_INSTANCES = (("granite-34b", 2), ("granite-34b", 4))
LM_TP_SPAWNS = (("qwen2", "mamba2", "granite24"), ("gemma2", "granite12"))
LM_TP_CHECKED = {"qwen2", "mamba2", "gemma2"}
LM_TP_FIXED = 8
LM_TP_ROLLOUT = {"batch": 4, "horizon": 16}
# (c)'s f32 check: the M ranks' gradient on the plain versions in f32
# against one process's f32 gradient of the same rows, as a share of its
# norm (the whole and the split-use leaves), and the loss relative to
# itself.  The ranks sum other partial products than one process, so f32
# rounding alone separates them: 1.5e-06 (gemma2-2b) to 1.0e-04
# (mamba2-1.3b, 4 layers) of the norm on the card; mamba2's split-use
# leaves left partial read 0.42
LM_TP_F32_BOUND = 1e-3
LM_TP_F32_LOSS = 1e-4
# the four-card proof (tools/chip_phases.py lm_tp4, not part of this
# script's run): NCCL ranks, one card each, at full depth.  qwen2-moe's
# 14.3 B parameters hold 53.4 GiB of f32 weights, gradients and Adam
# moments a rank on 1 x 4; gemma2-2b's 3.2 B on 2 x 2 with --compress.
LM_TP4 = {"timeout": 1800,
          "qwen2": {"arch": "qwen2-moe-a2.7b", "layers": 24, "mesh": (1, 4),
                    "batch": 8, "horizon": 256, "steps": 2,
                    "compress": False},
          "gemma2": {"arch": "gemma2-2b", "layers": 26, "mesh": (2, 2),
                     "batch": 8, "horizon": 256, "steps": 2,
                     "compress": True}}
# the fused mesh's four-card proof (tools/chip_phases.py mesh4, not part of
# this script's run): four NCCL ranks, a card each.  (a) RL, each run fused
# against unfused on the same ranks: A2C (16 envs, int8_ef, sentinels),
# PPO at the quickstart's settings, prioritized rainbow DQN at the catch
# example's (across its target copy at update 100); a checkpoint at the
# first of restore_iters restored into a new fused loop; the Catch bar,
# fused.  (b) LM at full width: mamba2-1.3b at all 48 layers and
# qwen2-moe-a2.7b at all 24 on 1 x 4, gemma2-2b at 26 on 2 x 2
# --compress, each two steps, then a rollout of the trained LM replayed
# from its graph against an eager one from the same seed
MESH4 = {"timeout": 1500, "collective_timeout": 300, "envs": 16, "a2c_iters": 20, "ppo_iters": 8,
         "dqn_iters": 60, "bar_iters": 200, "bar_updates": 4,
         "restore_iters": (20, 20), "wall_iters": 20,
         "lm": {"mamba2": {"arch": "mamba2-1.3b", "layers": 48,
                           "mesh": (1, 4), "batch": 8, "horizon": 256,
                           "steps": 2, "compress": False},
                "qwen2": {"arch": "qwen2-moe-a2.7b", "layers": 24,
                          "mesh": (1, 4), "batch": 8, "horizon": 256,
                          "steps": 2, "compress": False},
                "gemma2": {"arch": "gemma2-2b", "layers": 26,
                           "mesh": (2, 2), "batch": 8, "horizon": 256,
                           "steps": 2, "compress": True}}}
# phase 11e: one NCCL rank (a world of one on the card) captures
# all_reduce and all_gather_into_tensor on n f32 and replays them
CAPTURE = {"n": 2**20, "replays": 100, "timeout": 300}
# the tooling phase (12b): rlpyt's variant launcher on the card, the dry
# run's specs against allocations and its counts beside the phases' walls
TOOLING = {"variants": {"arch": "gemma2-2b", "steps": 2, "batch": 4,
                        "horizon": 8},
           "grid": {"lr": [1e-4, 3e-4], "seed": [0, 1]}, "capacity": 2,
           "serve": (8, 1024, 1089), "train": (8, 256), "timeout": 300}
L2_BYTES = 50 * 2**20


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


if not (REPO / "src" / "repro_torch").is_dir():
    fail(f"src/repro_torch not found beside {Path(__file__).name}: run this "
         "from a checkout of the repository")
sys.path.insert(0, str(REPO / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

if not torch.cuda.is_available():
    fail("torch.cuda.is_available() is false: this smoke run needs a GPU")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.agents import make_categorical_pg_agent  # noqa: E402
from repro_torch.algos import A2C, R2D1  # noqa: E402
from repro_torch.algos.pg.ppo import make_lm_ppo_train_step  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.distributions import Categorical  # noqa: E402
from repro_torch.envs import make_env  # noqa: E402
from repro_torch.envs.token_lm import make_token_lm  # noqa: E402
from repro_torch.examples import catch_dqn_variants as catch_dqn  # noqa: E402
from repro_torch.examples import mujoco_style_sac  # noqa: E402
from repro_torch.examples import pendulum_qpg  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.examples import r2d1_recurrent  # noqa: E402
from repro_torch.examples import serve_decode  # noqa: E402
from repro_torch.kernels import build, registry  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    FWD_BLOCK_Q, FWD_THREADS, decode_max_clusters, decode_split_plan)
from repro_torch.kernels.flash_attention.ref import attention_reference  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_reference  # noqa: E402
from repro_torch.kernels.ssd_scan.ssd_scan import (  # noqa: E402
    occupancy as ssd_occupancy)
from repro_torch.kernels.sum_tree import ops as st_ops  # noqa: E402
from repro_torch.kernels.sum_tree import ref as st_ref  # noqa: E402
from repro_torch.kernels.sum_tree.sum_tree import (  # noqa: E402
    sample_blocked, sample_plain)
from repro_torch.launch import dryrun, launcher, serve, specs, train  # noqa: E402
from repro_torch.launch.mesh import (AbstractMesh, HBM_BW,  # noqa: E402
                                     PEAK_FLOPS_BF16, make_data_mesh,
                                     spawn_ranks)
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import backbones as bb  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import sharding as shd  # noqa: E402
from repro_torch.models.config import ShapeCell  # noqa: E402
from repro_torch.models.convert import jax_leaf_groups  # noqa: E402
from repro_torch.models.layers import record_routing  # noqa: E402
from repro_torch.models.rl_models import make_pg_mlp, make_recurrent_q  # noqa: E402
from repro_torch.replay.host import SequenceSamples  # noqa: E402
from repro_torch.replay.interface import transition_example  # noqa: E402
from repro_torch.samplers.eval import fold_seed  # noqa: E402
from repro_torch.runners import AsyncRunner, OffPolicyRunner, TrainLoop  # noqa: E402
from repro_torch.samplers import SerialSampler, ShardedSampler  # noqa: E402
from repro_torch.serving import (ContinuousBatchEngine,  # noqa: E402
                                 DEFAULT_BUCKETS, poisson_trace)
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.utils.logger import Logger  # noqa: E402

PEAK_F32_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores
DEV = torch.device("cuda")
BF16 = torch.bfloat16
TPU_KERNEL = "src/repro/kernels/flash_attention/flash_attention.py:99"
SOURCE = "src/repro_torch/csrc/flash_attention.cu"


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fns, iters: int = 20) -> float:
    """Mean device time of one call, cycling through ``fns`` (closures over
    input copies that together exceed L2, so each call finds its inputs
    cold as the model's next layer does)."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fns, iters: int = 100) -> float:
    """Mean device time of one call: ``iters`` calls cycling through ``fns``
    (as in ``time_ms``) captured in one CUDA graph and replayed, so that the
    host's cost of a call (checks, allocation, the launch itself) does not
    hide a kernel that is faster than it."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def copies_for(nbytes: int) -> int:
    return max(2, math.ceil(2 * L2_BYTES / max(nbytes, 1)))


def randn(*shape, gen):
    return torch.randn(shape, generator=gen, device=DEV, dtype=BF16)


def tol_share(got, want, tol) -> float:
    """Largest |got - want| / (atol + rtol |want|): above 1 fails."""
    atol, rtol = tol
    err = (got.float() - want.float()).abs()
    return float((err / (atol + rtol * want.float().abs())).max())


def check(entry, name, got, want):
    """Kernel output against its plain version; returns the max abs error
    and the share of the tolerance it used."""
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"{entry} {name}: non-finite kernel output")
    worst = float((got.float() - want.float()).abs().max())
    share = tol_share(got, want, TOL[entry])
    print(f"  {name}: max_abs_err {worst:.3e}, tolerance used {share:.3f}")
    if share > 1:
        fail(f"{entry} {name}: kernel disagrees with attention_reference "
             f"beyond atol {TOL[entry][0]} + rtol {TOL[entry][1]} (max abs "
             f"err {worst}, {share:.2f} x the tolerance)")
    return worst, share


def must_differ(entry, fault, wrong, want):
    """The check above would catch ``fault``: the plain version with that
    fault lies outside the tolerance."""
    share = tol_share(wrong, want, TOL[entry])
    print(f"  sensitivity: {fault} -> {share:.1f} x the tolerance")
    if share <= 1:
        fail(f"{entry}: the tolerance would not catch {fault}")


def attn_sites(cfg) -> int:
    """Attention calls a forward, prefill or decode step makes through the
    flash kernel: every layer's causal self-attention (the hybrid's shared
    block once a superblock, the vlm's self layers, the encdec decoder's);
    the encoder and the cross layers take the plain path, as in JAX."""
    n_sb, per_block, _ = bb.superblock_layout(cfg)
    return {"ssm": 0, "hybrid": n_sb,
            "vlm": n_sb * (per_block - 1)}.get(cfg.family, cfg.n_layers)


def ssd_layers(cfg) -> int:
    """Mamba-2 layers a training forward runs the SSD scan in."""
    n_sb, per_block, tail = bb.superblock_layout(cfg)
    return {"ssm": cfg.n_layers,
            "hybrid": n_sb * per_block + tail}.get(cfg.family, 0)


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_FLOPS_BF16):
    t_bytes, t_ops = nbytes / HBM_BW, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def valid_pairs(T, S, causal, window):
    """(query, key) pairs the masks leave, per (batch row, head)."""
    q = torch.arange(T, device=DEV)[:, None]
    k = torch.arange(S, device=DEV)[None, :]
    m = torch.ones(T, S, dtype=torch.bool, device=DEV)
    if causal:
        m &= k <= q
    if window is not None:
        m &= k > q - window
    return int(m.sum())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain version, then times
# ---------------------------------------------------------------------------
def kernel_phase(cfg):
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    H, Hkv, dh, cap = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.softcap_attn
    errs = {"flash_attn_fwd": 0.0, "flash_attn_decode": 0.0}
    used = dict(errs)

    def record(entry, name, got, want):
        err, share = check(entry, name, got, want)
        errs[entry] = max(errs[entry], err)
        used[entry] = max(used[entry], share)

    def fwd_case(B, T, window, scale=1.0):
        q = randn(B, T, H, dh, gen=gen) * scale
        k, v = randn(B, T, Hkv, dh, gen=gen), randn(B, T, Hkv, dh, gen=gen)
        kw = dict(causal=True, window=window, softcap=cap)
        want = attention_reference(q, k, v, **kw)
        record("flash_attn_fwd", f"B{B} T{T} window {window}"
               + (f" q x{scale:g}" if scale != 1 else ""),
               ops.flash_attention(q, k, v, **kw), want)
        return q, k, v, kw, want

    print("kernel phase: flash_attn_fwd vs attention_reference (bf16, atol "
          f"{TOL['flash_attn_fwd'][0]} + rtol {TOL['flash_attn_fwd'][1]})")
    for B, T, window in ((4, 1024, 256), (4, 1000, 4096), (4, 1000, 256),
                         (8, 1024, cfg.window), (8, 1024, None)):
        fwd_case(B, T, window)
    # the gemma2 training forward (phase 6a): local and global layers; its
    # backward is the reference's vjp, held bit for bit
    for window in (cfg.window, None):
        backward_check(*fwd_case(GEMMA_TRAIN["batch"], GEMMA_TRAIN["horizon"],
                                 window)[:4], gen)
    q, k, v, kw, want = fwd_case(4, 1024, 4096)
    must_differ("flash_attn_fwd", "causal edge one key late",
                attention_reference(q, k, v, **{**kw, "q_offset": 1}), want)
    q, k, v, kw, want = fwd_case(4, 1024, 256)
    must_differ("flash_attn_fwd", "window one key wider",
                attention_reference(q, k, v, **{**kw, "window": 257}), want)
    # the continuous run's prefills: one prompt at each bucket
    for T in [b for b in DEFAULT_BUCKETS if b <= CONT["prompt_len"]]:
        for window in (cfg.window, None):
            fwd_case(1, T, window)
    fwd_case(1, 24, cfg.window, scale=20.0)
    q, k, v, kw, want = fwd_case(4, 1000, 256, scale=20.0)
    must_differ("flash_attn_fwd", "softcap skipped",
                attention_reference(q, k, v, **{**kw, "softcap": None}), want)

    print("kernel phase: flash_attn_decode vs attention_reference (bf16, atol "
          f"{TOL['flash_attn_decode'][0]} + rtol "
          f"{TOL['flash_attn_decode'][1]})")
    S_fixed = 1024 + 64 + 1
    S_cont = CONT["prompt_len"] + CONT["gen"] + 1  # serve's max_context
    ragged = [1, 37, 1089, 2048, 5, 500, 1500, 2047]
    slots = [1, 9, 24, 40, 57, 64, 96, 97]
    cases = [(8, 2048, ragged, 1.0),
             (8, S_fixed, torch.randint(1025, S_fixed, (8,), generator=gen,
                                        device=DEV).tolist(), 1.0),
             # the continuous run: the slot batch, then B 1 prompt-tail steps
             (8, S_cont, slots, 1.0), (1, S_cont, [9], 1.0),
             (1, S_cont, [33], 1.0), (1, S_cont, [64], 1.0),
             # kv_len 1: every split but the first is empty
             (8, S_fixed, [1] * 8, 1.0), (1, S_cont, [1], 1.0)]
    # kv_len at every boundary of the split plan +-1, 8 (or 1) at a time
    for B, S in ((8, S_fixed), (8, S_cont), (1, S_cont)):
        n_split, chunk = decode_split_plan(B, Hkv, S)
        vals = sorted({i * chunk + d for i in range(1, n_split)
                       for d in (-1, 0, 1)} | {S})
        cases += [(B, S, (vals[i:i + B] + [1] * B)[:B], 1.0)
                  for i in range(0, len(vals), B)]
    # last: the softcap cases, whose inputs the sensitivity checks reuse
    cases += [(8, 2048, ragged, 20.0), (8, S_cont, slots, 20.0)]
    for B, S, kvl, scale in cases:
        q = randn(B, 1, H, dh, gen=gen) * scale
        k, v = randn(B, S, Hkv, dh, gen=gen), randn(B, S, Hkv, dh, gen=gen)
        kv_len = torch.tensor(kvl, dtype=torch.int32, device=DEV)
        want = attention_reference(q, k, v, causal=False, softcap=cap,
                                   kv_len=kv_len)
        record("flash_attn_decode", f"B{B} S{S} kv_len {kvl}"
               + (f" q x{scale:g}" if scale != 1 else ""),
               ops.flash_attention_decode(q, k, v, kv_len, softcap=cap), want)
    must_differ("flash_attn_decode", "softcap skipped", attention_reference(
        q, k, v, causal=False, softcap=None, kv_len=kv_len), want)
    must_differ("flash_attn_decode", "last key of kv_len dropped",
                attention_reference(q, k, v, causal=False, softcap=cap,
                                    kv_len=torch.clamp(kv_len - 1, min=1)),
                want)
    # one split's partial lost in the merge: the reference without the
    # keys of each row's last non-empty split
    B, S = 8, S_fixed
    n_split, chunk = decode_split_plan(B, Hkv, S)
    q = randn(B, 1, H, dh, gen=gen)
    k, v = randn(B, S, Hkv, dh, gen=gen), randn(B, S, Hkv, dh, gen=gen)
    kv_len = torch.randint(chunk + 1, S + 1, (B,), generator=gen,
                           device=DEV).to(torch.int32)
    want = attention_reference(q, k, v, causal=False, softcap=cap,
                               kv_len=kv_len)
    record("flash_attn_decode", f"B{B} S{S} kv_len {kv_len.tolist()}",
           ops.flash_attention_decode(q, k, v, kv_len, softcap=cap), want)
    must_differ("flash_attn_decode", "last non-empty split dropped",
                attention_reference(q, k, v, causal=False, softcap=cap,
                                    kv_len=(kv_len - 1) // chunk * chunk),
                want)

    timing = {"grid": {}}
    # prefill at the fixed-round shape (local layer, window 4096 >= T), then
    # at the gemma2 training forward's (B 8, T 256)
    for key, B, T in (("flash_attn_fwd", 8, 1024),
                      ("flash_attn_fwd B8 T256", GEMMA_TRAIN["batch"],
                       GEMMA_TRAIN["horizon"])):
        timing[key], timing["grid"][key] = fwd_timing(cfg, B, T, gen)
    # decode at the fixed-round shape (S 1089, kv_len of the 64 decode
    # steps), then at the continuous run's slot batch and prompt-tail steps
    for key, B, S, lo in (("flash_attn_decode", 8, S_fixed, 1025),
                          ("flash_attn_decode B8 S97", 8, S_cont, 1),
                          ("flash_attn_decode B1 S97", 1, S_cont, 1)):
        timing[key], timing["grid"][key] = decode_timing(cfg, B, S, lo, gen)
    print_timing(timing)
    return errs, used, timing


def fwd_timing(cfg, B, T, gen):
    """flash_attn_fwd at (B, T) and ``cfg``'s heads, window and softcap: the
    kernel as a replayed graph (and back to back), its plain version, its
    bound and SDPA (causal, no window or softcap: the same function only
    where the config has neither inside T).  Returns (timing, grid)."""
    H, Hkv, dh, cap = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.softcap_attn
    nbytes = 2 * (2 * B * T * H * dh + 2 * B * T * Hkv * dh)
    sets = [(randn(B, T, H, dh, gen=gen), randn(B, T, Hkv, dh, gen=gen),
             randn(B, T, Hkv, dh, gen=gen))
            for _ in range(copies_for(nbytes))]
    kw = dict(causal=True, window=cfg.window, softcap=cap)
    fns = [lambda s=s: ops.flash_attention(*s, **kw) for s in sets]
    ms, call = graph_ms(fns), time_ms(fns)
    plain = graph_ms([lambda s=s: attention_reference(*s, **kw)
                      for s in sets[:2]], iters=4)
    lib = graph_ms([lambda s=s: F.scaled_dot_product_attention(
        s[0].transpose(1, 2), s[1].transpose(1, 2), s[2].transpose(1, 2),
        is_causal=True, enable_gqa=True) for s in sets])
    flops = 4 * dh * B * H * valid_pairs(T, T, True, cfg.window)
    return (dict(ms=ms, call_ms=call, plain_ms=plain, library_ms=lib,
                 shape=f"B{B} T{T} H{H} Hkv{Hkv} dh{dh} causal window "
                       f"{cfg.window} softcap {cap}",
                 same=cap is None and (cfg.window is None or cfg.window >= T),
                 bound=bound_ms(nbytes, flops)),
            f"({-(-T // FWD_BLOCK_Q)}, {H}, {B}) x {FWD_THREADS} threads, "
            "cluster 1")


def decode_timing(cfg, B, S, lo, gen):
    """flash_attn_decode at (B, S) with kv_len drawn from [lo, S) and
    ``cfg``'s heads and softcap, timed as ``fwd_timing`` times prefill
    (SDPA with a kv_len mask); the grid against the clusters the card holds
    at once.  Returns (timing, grid)."""
    H, Hkv, dh, cap = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.softcap_attn
    kvl = torch.randint(lo, S, (B,), generator=gen, device=DEV)
    kv_len = kvl.to(torch.int32)
    n_kv = int(kvl.sum())
    nbytes = 2 * (2 * B * H * dh + 2 * n_kv * Hkv * dh) + 4 * B
    sets = [(randn(B, 1, H, dh, gen=gen), randn(B, S, Hkv, dh, gen=gen),
             randn(B, S, Hkv, dh, gen=gen))
            for _ in range(copies_for(2 * 2 * B * S * Hkv * dh))]
    mask = (torch.arange(S, device=DEV)[None, :]
            < kvl[:, None])[:, None, None]
    fns = [lambda s=s: ops.flash_attention_decode(*s, kv_len, softcap=cap)
           for s in sets]
    ms, call = graph_ms(fns, iters=200), time_ms(fns, iters=200)
    plain = graph_ms([lambda s=s: attention_reference(
        *s, causal=False, softcap=cap, kv_len=kv_len) for s in sets],
        iters=20)
    lib = graph_ms([lambda s=s: F.scaled_dot_product_attention(
        s[0].transpose(1, 2), s[1].transpose(1, 2), s[2].transpose(1, 2),
        attn_mask=mask, enable_gqa=True) for s in sets], iters=200)
    flops = 4 * dh * H * n_kv
    G = H // Hkv
    n_split, chunk = decode_split_plan(B, Hkv, S)
    threads = 256 if G <= 4 else 32 * 4 * (-(-G // 16))
    grid = (f"({n_split}, {Hkv}, {B}) x {threads} threads, cluster {n_split} "
            f"({chunk} slots a split); {B * Hkv} clusters, the card holds "
            f"{decode_max_clusters(n_split, dh, G)} at once")
    return (dict(ms=ms, call_ms=call, plain_ms=plain, library_ms=lib,
                 shape=f"B{B} S{S} H{H} Hkv{Hkv} dh{dh} kv_len sum {n_kv} "
                       f"softcap {cap}",
                 same=cap is None, bound=bound_ms(nbytes, flops)), grid)


def print_timing(timing):
    for name, g in timing.pop("grid").items():
        print(f"  {name} grid {g}")
    for name, t in timing.items():
        note = "" if t["same"] else \
            " (no softcap or window: not the same function)"
        print(f"  {name} [{t['shape']}]: kernel {t['ms']:.4f} ms (device, "
              f"graph replay; {t['call_ms']:.4f} ms a call back to back), "
              f"plain {t['plain_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms "
              f"({t['bound'][1]}), library_ms{note} {t['library_ms']:.4f} ms")


def backward_check(q, k, v, kw, gen):
    """The autograd.Function's backward on the kernel route against autograd
    through attention_reference on the same (q, k, v, g): dq, dk and dv bit
    for bit (the same math on the same inputs).  Then the Function's own
    backward fed a saved k with one element moved must differ."""
    g = randn(*q.shape, gen=gen)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n0 = ops.flash_attention.launches
    got = torch.autograd.grad(ops.flash_attention(*leaves, **kw), leaves, g)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_reference(*ref, **kw), ref, g)
    torch.cuda.synchronize()
    if ops.flash_attention.launches != n0 + 1:
        fail("backward check: the kernel route did not launch flash_attn_fwd")
    same = [torch.equal(a, b) for a, b in zip(got, want)]
    print(f"  backward B{q.shape[0]} T{q.shape[1]} window {kw['window']}: "
          f"dq, dk, dv bit-identical to autograd through "
          f"attention_reference: {same}")
    if not all(same):
        fail(f"backward at window {kw['window']}: the Function's gradients "
             "differ from the reference's vjp")
    k_bad = k.clone()
    k_bad[0, 5, 0, 0] += 1.0
    ctx = types.SimpleNamespace(saved_tensors=(q, k_bad, v), opts=(
        kw["causal"], kw["window"], kw["softcap"], kw.get("q_offset", 0)))
    bad = ops._FlashAttention.backward(ctx, g)[:3]
    caught = not all(torch.equal(a, b) for a, b in zip(bad, want))
    print(f"  sensitivity: saved k perturbed in one element -> "
          f"{'caught' if caught else 'NOT caught'}")
    if not caught:
        fail("backward check: a perturbed saved k goes unnoticed")


# ---------------------------------------------------------------------------
# phase 4: kernel route vs --kernels ref on the same weights and prompts
# ---------------------------------------------------------------------------
def served_weights(cfg, prompt_len=1024):
    """The weights the fixed rounds' serve.main drew and its first round's
    prompts (B 8, prompt ``prompt_len``), drawn again from the same seeds."""
    params = bb.init_lm(cfg, device=DEV, generator=torch.Generator(
        device=DEV).manual_seed(SEED))
    prompts = serve.make_prompts(
        cfg, 8, prompt_len, torch.Generator(device=DEV).manual_seed(SEED + 1),
        DEV)
    return params, prompts


def kernel_vs_ref(cfg, params, prompts, gen):
    batch, prompt_len = prompts.shape
    # eager decode: a graph would keep the route it was captured on
    prefill, decode = serve.make_phases(cfg, batch, prompt_len, gen,
                                        device=DEV, graph=False)
    out, first_tok = {}, None
    for spec in ("cuda", "ref"):
        with registry.override(spec), torch.inference_mode():
            logits, cache = prefill(params, prompts)
            if first_tok is None:
                first_tok = torch.argmax(logits, -1).to(torch.int32)
            step_cache = {k: v.clone() for k, v in cache.items()}
            hidden, _ = bb.decode_step(params, step_cache, first_tok, cfg)
            step_logits = bb.lm_logits(params, hidden, cfg)[:, 0].float()
            del step_cache
            toks = decode(params, logits, cache, None)
            out[spec] = (logits, step_logits, toks)
        torch.cuda.synchronize()
    for i, what in enumerate(("prefill last-position logits",
                              "first decode step logits")):
        a, b = out["cuda"][i], out["ref"][i]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            fail(f"{what}: non-finite logits")
        if tuple(a.shape) != (batch, cfg.padded_vocab):
            fail(f"{what}: shape {tuple(a.shape)}")
        err = float((a - b).abs().max())
        print(f"  kernel vs ref, {what}: max abs diff {err:.4f} "
              f"(|logit| max {float(b.abs().max()):.3f}, tolerance {LOGIT_TOL})")
        if err > LOGIT_TOL:
            fail(f"{what}: kernel route and ref route differ by {err}")
    agree = float((out["cuda"][2] == out["ref"][2]).float().mean())
    first = float((out["cuda"][2][:, 0] == out["ref"][2][:, 0]).float().mean())
    print(f"  greedy-token agreement over {gen} steps: {agree:.4f} "
          f"(first step {first:.4f})")


# ---------------------------------------------------------------------------
# phase 5a: mamba2-1.3b serving (no kernel: the prefill takes the plain scan)
# ---------------------------------------------------------------------------
def ssm_prefill_check(cfg, prompts):
    """The prefill's last logits, conv and SSM states against a
    token-by-token decode_step teacher-force of the same prompts, each as
    max |diff| / max |teacher-forced|, within SSM_PREFILL_TOL."""
    B, T = prompts.shape
    params = bb.init_lm(cfg, device=DEV, generator=torch.Generator(
        device=DEV).manual_seed(SEED))
    with torch.inference_mode():
        cache = bb.init_cache(cfg, B, T + 1, device=DEV)
        hidden, cache = bb.prefill(params, prompts, cfg, cache)
        got = {"logits": bb.lm_logits(params, hidden, cfg)[:, -1].float(),
               "conv": cache["conv"], "ssm": cache["ssm"]}
        forced = bb.init_cache(cfg, B, T + 1, device=DEV)
        for t in range(T):
            hidden, forced = bb.decode_step(params, forced, prompts[:, t], cfg)
        want = {"logits": bb.lm_logits(params, hidden, cfg)[:, 0].float(),
                "conv": forced["conv"], "ssm": forced["ssm"]}
    if not torch.equal(cache["lengths"], forced["lengths"]):
        fail("ssm prefill: lengths differ from the teacher-forced decode's")
    for name in got:
        a, b = got[name].float(), want[name].float()
        if not torch.isfinite(a).all():
            fail(f"ssm prefill: non-finite {name}")
        rel = float((a - b).abs().max() / b.abs().max())
        print(f"  {cfg.n_layers} layers, B{B} prompt {T}: prefill vs "
              f"teacher-forced decode, {name}: max |diff| / max |value| "
              f"{rel:.3e} (tolerance {SSM_PREFILL_TOL})")
        if rel > SSM_PREFILL_TOL:
            fail(f"ssm prefill {name} differs from the teacher-forced decode")


def ssm_serve_phase(log_dir):
    """serve.main's default arch (mamba2-1.3b) at full width: fixed rounds
    and the continuous run; every request served, no kernel launched."""
    cfg = get_config(serve.build_parser().get_default("arch"))
    run = SSM_SERVE
    log_dir = str(Path(log_dir) / cfg.name)
    print(f"slice phase: serving {cfg.name} (the default arch; full width, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, bf16) fixed rounds "
          f"(batch {run['batch']}, prompt {run['prompt_len']}, gen "
          f"{run['gen']}, {run['rounds']} rounds)")
    t_phase = time.perf_counter()
    zero_kernel_counters()
    toks = serve.main(["--full", "--device", "cuda", "--batch",
                       str(run["batch"]), "--prompt-len",
                       str(run["prompt_len"]), "--gen", str(run["gen"]),
                       "--rounds", str(run["rounds"]), "--seed", str(SEED),
                       "--log-dir", log_dir])
    if tuple(toks.shape) != (run["batch"], run["gen"]) or \
            int(toks.min()) < 0 or int(toks.max()) >= cfg.padded_vocab:
        fail(f"{cfg.name} fixed rounds: bad tokens {tuple(toks.shape)}")
    torch.cuda.empty_cache()
    print(f"slice phase: serving {cfg.name} continuous ({CONT['requests']} "
          f"requests, {CONT['slots']} slots)")
    args = ["--full", "--device", "cuda", "--continuous", "--seed",
            str(SEED), "--log-dir", log_dir]
    for key, val in CONT.items():
        args += ["--" + key.replace("_", "-"), str(val)]
    summary = serve.main(args)
    trace = poisson_trace(
        SEED, CONT["requests"], CONT["rate"],
        prompt_len_range=(CONT["prompt_min"], CONT["prompt_len"]),
        max_tokens_range=(CONT["gen_min"], CONT["gen"]), vocab=cfg.vocab)
    want = sum(r.max_tokens for r in trace)
    if summary["n_finished"] != len(trace) or \
            summary["generated_tokens"] != want:
        fail(f"{cfg.name} continuous: {summary['n_finished']} finished, "
             f"{summary['generated_tokens']} tokens, expected {len(trace)} / "
             f"{want}")
    print(f"  p50 latency {summary['p50_latency_s']:.4f} s, p99 latency "
          f"{summary['p99_latency_s']:.4f} s, ttft p50 "
          f"{summary.get('ttft_p50_s', float('nan')):.4f} s, decode "
          f"{summary['decode_tok_per_sec']:.1f} tok/s, every request got its "
          "max_tokens")
    launches = kernel_launches()
    print(f"  kernel launches in {cfg.name} serving: {launches}")
    if any(launches.values()):
        fail(f"{cfg.name} serving launched a kernel: {launches} (its prefill "
             "takes the plain scan, its decode step plain ops)")
    torch.cuda.empty_cache()
    print(f"graph phase: {cfg.name} fixed rounds replayed from CUDA graphs "
          "against eager, on serve.main's weights and prompts")
    params, prompts = served_weights(cfg, run["prompt_len"])
    fixed_rounds_graph_check(cfg, params, prompts, run["gen"])
    del params, prompts
    torch.cuda.empty_cache()
    cut = dataclasses.replace(cfg, n_layers=4)
    prompts = serve.make_prompts(  # serve.main's first round's prompts
        cut, run["batch"], run["prompt_len"],
        torch.Generator(device=DEV).manual_seed(SEED + 1), DEV)
    ssm_prefill_check(cut, prompts)
    torch.cuda.empty_cache()
    print(f"  phase {time.perf_counter() - t_phase:.1f} s")


def profile_phase(cfg, params, prompts, steps=8):
    """Device busy time per prefill and per decode step (torch.profiler,
    CUDA kernels only) against the unprofiled wall time of the same work:
    the idle share says how far the host holds the card back."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch, prompt_len = prompts.shape
    # the fixed rounds' cache length (gen 64); only `steps` of it are run
    prefill, _ = serve.make_phases(cfg, batch, prompt_len, 64, device=DEV)

    def run_prefill():
        return prefill(params, prompts)

    def run_decode(logits, cache):
        with torch.inference_mode():
            for _ in range(steps):
                tok = torch.argmax(logits, -1).to(torch.int32)
                hidden, cache = bb.decode_step(params, cache, tok, cfg)
                logits = bb.lm_logits(params, hidden, cfg)[:, 0].float()
        return logits

    def wall_ms(fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    # `steps` decode steps replayed from serve's graph (greedy; its cache
    # holds prompt + steps + 1 positions)
    prefill_graph, decode_graph = serve.make_phases(cfg, batch, prompt_len,
                                                    steps, device=DEV)

    def run_graph(logits, cache):
        return decode_graph(params, logits, cache, None)

    # unprofiled walls first: once the profiler has run, CUPTI stays
    # attached and every later launch of the process is slower
    logits, cache = run_prefill()
    walls = {"prefill": wall_ms(run_prefill)[0],
             "decode": wall_ms(run_decode, logits, cache)[0] / steps}
    run_graph(*prefill_graph(params, prompts))   # warm-up and capture
    walls["decode (graph)"] = wall_ms(
        run_graph, *prefill_graph(params, prompts))[0] / steps
    del logits, cache, prefill_graph
    GRAPH_WALLS[f"{cfg.name} decode step (B{batch}, profile phase)"] = (
        walls["decode"], walls["decode (graph)"], "a step")

    def record(phase):
        """One profiled run of the phase: its CUDA kernels, by name."""
        fn, args = ((run_prefill, ()) if phase == "prefill"
                    else (run_decode, run_prefill()))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_ms(fn, *args)
        return [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]

    def launched(evs, name):
        return sum(e.count for e in evs if name in e.key)

    sites = attn_sites(cfg)
    busy_of = {}
    for phase in ("prefill", "decode"):
        per = 1 if phase == "prefill" else steps
        # one attention kernel an attention site: flash_attn_decode merges
        # its splits inside its one launch
        name = "flash_fwd_kernel" if phase == "prefill" else \
            "flash_decode_kernel"
        want = sites * per
        # the profiler loses a kernel record now and then (25
        # flash_fwd_kernel records of 26 in one run; decode runs of 18 472
        # kernels recording 18 471 or 18 470) and never adds one; the work
        # is deterministic, so the check reads the most complete of two to
        # four runs and a real fault shows in every run
        runs = []
        while len(runs) < 4:
            runs.append(record(phase))
            others = {e.key for e in runs[-1]
                      if "flash" in e.key and name not in e.key}
            if others:
                fail(f"profile {phase}: other attention kernels ran: "
                     f"{sorted(others)}")
            if launched(runs[-1], name) > want:
                break
            if len(runs) >= 2 and max(launched(r, name) for r in runs) == want:
                break
        evs = max(runs, key=lambda r: (launched(r, name),
                                       sum(e.count for e in r)))
        totals = [sum(e.count for e in r) for r in runs]
        if len(set(totals)) > 1:
            print(f"  profile {phase}: the profiler recorded {totals} kernels "
                  "in identical runs; the numbers below are the run with the "
                  f"most {name} records")
        if not evs:
            print(f"  profile {phase}: device time not measured (the profiler "
                  "recorded no CUDA kernels)")
            continue
        busy = busy_of[phase] = sum(e.self_device_time_total
                                    for e in evs) / 1e3 / per
        n = sum(e.count for e in evs) / per
        wall = walls[phase]
        top = sorted(evs, key=lambda e: -e.self_device_time_total)[:5]
        print(f"  profile {phase} (B{batch}, prompt {prompt_len}): wall "
              f"{wall:.3f} ms unprofiled, device busy {busy:.3f} ms "
              f"({n:.0f} kernels) per {'call' if per == 1 else 'step'}, "
              f"idle share {max(0.0, 1 - busy / wall):.3f}")
        for e in top:
            print(f"    {e.self_device_time_total / 1e3 / per:8.3f} ms "
                  f"x{e.count / per:.0f}  {e.key[:90]}")
        count = launched(evs, name) / per
        if count != sites:
            fail(f"profile {phase}: {count:g} {name} launches a "
                 f"{'call' if per == 1 else 'step'} in the most complete of "
                 f"{len(runs)} runs, expected one an attention site "
                 f"({sites})")
        us = sum(e.self_device_time_total for e in evs if name in e.key) / \
            launched(evs, name)
        print(f"    {name}: {count:g} launches a {'call' if per == 1 else 'step'} "
              f"(one an attention site, no other attention kernel), {us:.2f} "
              "us of device time a launch")
    replayed_busy(f"decode (graph) (B{batch}, prompt {prompt_len}, "
                  f"{steps} steps)", walls["decode (graph)"],
                  busy_of.get("decode"))
    return walls

# ---------------------------------------------------------------------------
# phase 3 (SSD): the scan kernel against ssd_reference, then its time
# ---------------------------------------------------------------------------
def ssd_inputs(B, T, gen, dt_scale=1.0, H=64, P=64, N=128):
    """Inputs at mamba2-1.3b's widths (or the given heads H, head dim P and
    state N; one group): bf16 x/B/C, f32 dt = softplus(z) * dt_scale and
    the model's A = -exp(A_log) = -linspace(1, 16, H)."""
    x = torch.randn(B, T, H, P, generator=gen, device=DEV).to(BF16)
    dt = F.softplus(torch.randn(B, T, H, generator=gen, device=DEV)) * dt_scale
    A = -torch.linspace(1.0, 16.0, H, device=DEV)
    Bm = (torch.randn(B, T, 1, N, generator=gen, device=DEV) * 0.5).to(BF16)
    Cm = (torch.randn(B, T, 1, N, generator=gen, device=DEV) * 0.5).to(BF16)
    return x, dt, A, Bm, Cm


def ssd_tolerance(x, dt, A, Bm, Cm, chunk):
    """(y_abs, S_abs, eps) of the SSD error model (the note above
    SSD_TPU_KERNEL)."""
    ya, sa = ssd_reference(x.abs(), dt, A, Bm.abs(), Cm.abs(), chunk=chunk)
    B, T, H = dt.shape
    nc = -(-T // chunk)
    dA = F.pad(dt * A, (0, 0, 0, nc * chunk - T))
    cmax = float(torch.cumsum(dA.reshape(B, nc, chunk, H), 2).abs().max())
    return ya.float(), sa, 2.0 ** -14 + 2.0 ** -19 * cmax


def ssd_share(y, s, yr, sr, tol):
    """Largest share of the tolerance used by y and by the state."""
    ya, sa, eps = tol
    sy = ((y.float() - yr.float()).abs()
          / (2.0 ** -7 * yr.float().abs() + eps * ya + 1e-30)).max()
    ss = ((s - sr).abs() / (eps * sa + 1e-30)).max()
    return float(sy), float(ss)


def ssd_faulty(x, dt, A, Bm, Cm, chunk, fault=None, dtype=torch.float32):
    """ssd_chunked's math (G = 1, T a multiple of chunk) with one fault, for
    the sensitivity checks: 'carry' drops y_off, 'causal' drops the
    diagonal of the mask (q > k), 'dt' leaves dt out of M, 'decay' does not
    decay the state by exp(cum_last).  With ``dtype=torch.float64`` and no
    fault it is the f64 oracle, y left unrounded."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    A = A.to(dtype)
    S = torch.zeros((Bsz, H, P, N), dtype=dtype, device=x.device)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device),
                     diagonal=-1 if fault == "causal" else 0)[None, :, :, None]
    ys = []
    for c in range(T // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        xq, dtq = x[:, sl].to(dtype), dt[:, sl].to(dtype)
        Bq, Cq = Bm[:, sl, 0].to(dtype), Cm[:, sl, 0].to(dtype)
        cum = torch.cumsum(dtq * A, dim=1)
        Ld = torch.where(tri, cum[:, :, None, :] - cum[:, None, :, :], 0.0)
        L = torch.where(tri, torch.exp(Ld), 0.0)
        M = torch.einsum("bqn,bkn->bqk", Cq, Bq)[..., None] * L
        if fault != "dt":
            M = M * dtq[:, None, :, :]
        y = torch.einsum("bqkh,bkhp->bqhp", M, xq)
        if fault != "carry":
            y = y + torch.einsum("bqn,bhpn->bqhp", Cq, S) * \
                torch.exp(cum)[..., None]
        w = torch.exp(cum[:, -1:] - cum) * dtq
        if fault != "decay":
            S = S * torch.exp(cum[:, -1])[..., None, None]
        S = S + torch.einsum("bqn,bqhp->bhpn", Bq, xq * w[..., None])
        ys.append(y if dtype == torch.float64 else y.to(x.dtype))
    return torch.cat(ys, dim=1), S


def quantiles(v, qs=(0.5, 0.99, 0.999, 1.0)):
    """Quantiles of a tensor's entries (a sort: torch.quantile refuses more
    than 2^24 entries)."""
    v = v.flatten().double().sort().values
    return [float(v[min(int(q * (v.numel() - 1)), v.numel() - 1)])
            for q in qs]


def ssd_f64_check():
    """The element-wise error of each full-width SSD instance (mamba2-1.3b's
    (64, 128, 256) and zamba2-7b's (64, 64, 256)) at its training shape
    against the f64 oracle, beside the plain f32 version's on the same
    inputs: quantiles of |err| / bound, the SSD_TPU_KERNEL note's bound
    with y64 in place of y_ref, for y and for the final state.  Fails if a
    share passes 1, or if zamba2's instance's distribution is not mamba2's:
    each of its kernel quantiles within SSD_F64_MATCH of mamba2's (the
    same ratio over the plain version's).  Returns {name: quantiles}."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 11)
    out = {}
    for name in ("ssd_scan", "ssd_scan P64 N64"):
        P, N, Q, H, B, T, _, arch = SSD_INSTANCES[name]
        inp = ssd_inputs(B, T, gen, H=H, P=P, N=N)
        y, s = ssd_ops.ssd_scan(*inp, chunk=Q)
        yp, sp = ssd_reference(*inp, chunk=Q)
        y64, s64 = ssd_faulty(*inp, Q, dtype=torch.float64)
        ya, sa, eps = ssd_tolerance(*inp, Q)
        ybound = 2.0 ** -7 * y64.abs() + eps * ya.double() + 1e-300
        sbound = eps * sa.double() + 1e-300
        row = {}
        for route, yy, ss in (("kernel", y, s), ("plain", yp, sp)):
            row[route] = {
                "y": quantiles((yy.double() - y64).abs() / ybound),
                "state": quantiles((ss.double() - s64).abs() / sbound),
                "y_rel": quantiles((yy.double() - y64).abs()
                                   / (y64.abs() + eps * ya.double())),
                "bf16_mismatch": float((yy != y64.to(BF16)).float().mean())}
        out[name] = row
        for route in ("kernel", "plain"):
            r = row[route]
            print(f"  f64 oracle, {name} ({arch}, B{B} T{T} H{H}) {route}: "
                  f"|err|/bound y p50/p99/p99.9/max "
                  f"{'/'.join(f'{v:.3g}' for v in r['y'])}, state "
                  f"{'/'.join(f'{v:.3g}' for v in r['state'])}; bf16 y "
                  f"off round(y64) {r['bf16_mismatch']:.4f}")
            if max(r["y"][-1], r["state"][-1]) > 1:
                fail(f"{name} {route} vs the f64 oracle: "
                     f"{r['y'][-1]:.2f} / {r['state'][-1]:.2f} x the bound")
        del inp, y, s, yp, sp, y64, s64, ya, sa, ybound, sbound
        torch.cuda.empty_cache()
    m, z = out["ssd_scan"]["kernel"], out["ssd_scan P64 N64"]["kernel"]
    mp, zp = out["ssd_scan"]["plain"], out["ssd_scan P64 N64"]["plain"]
    for key in ("y", "state"):
        for i, (a, b, ap, bp) in enumerate(zip(m[key], z[key], mp[key],
                                               zp[key])):
            # zamba2's kernel over its plain version against mamba2's
            rz, rm = b / max(bp, 1e-30), a / max(ap, 1e-30)
            if rz > SSD_F64_MATCH * max(rm, 1.0):
                fail(f"SSD f64 check: zamba2's instance's {key} quantile "
                     f"{i} is {rz:.2f}x its plain version's, mamba2's "
                     f"{rm:.2f}x: not the same error distribution")
    print(f"  f64 oracle: zamba2's (64, 64, 256) instance's error "
          f"distribution matches mamba2's (64, 128, 256) within "
          f"{SSD_F64_MATCH}x of each quantile's kernel / plain ratio")
    return out


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


def ssd_kernel_phase():
    """Each SSD instance (SSD_INSTANCES) against ssd_reference within the
    error model at its training shape, one chunk, ragged and short T and
    the dt edges; on a slow-decay case of four chunks the plain faulty
    variant without a fault (it must agree) and the four sensitivity
    checks; then its grid and its time at the training shape.  Returns
    ({instance name: (max abs error, tolerance share)}, {name: timing})."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
    errs, timing = {}, {}
    for name, (P, N, Q, H, B, T, Be, arch) in SSD_INSTANCES.items():
        print(f"kernel phase: {name} ({arch}: P {P}, N {N}, chunk {Q}) vs "
              "ssd_reference (bf16 x/B/C, f32 dt/A; |y - ref| <= 2^-7 |ref| "
              "+ eps y_abs, |S - ref| <= eps S_abs, eps = 2^-14 + 2^-19 "
              "max|cum|)")
        worst, keep = [0.0, 0.0], None
        for label, B_, T_, scale in (
                ("training shape", B, T, 1.0), ("one chunk", Be, Q, 1.0),
                ("ragged T", Be, 2 * Q + Q // 2 + 3, 1.0),
                ("short T", Be, max(1, Q // 2 - 3), 1.0),
                ("slow decay dt x0.01", Be, 4 * Q, 0.01),
                ("underflow dt x10", Be, 2 * Q, 10.0)):
            inp = ssd_inputs(B_, T_, gen, scale, H=H, P=P, N=N)
            chunk = min(Q, T_)
            n0 = ssd_ops.ssd_scan.launches
            y, s = ssd_ops.ssd_scan(*inp, chunk=chunk)
            torch.cuda.synchronize()
            if ssd_ops.ssd_scan.launches != n0 + 1:
                fail(f"{name} {label}: the kernel did not launch")
            if not (torch.isfinite(y).all() and torch.isfinite(s).all()):
                fail(f"{name} {label}: non-finite kernel output")
            yr, sr = ssd_reference(*inp, chunk=chunk)
            tol = ssd_tolerance(*inp, chunk)
            sy, ss = ssd_share(y, s, yr, sr, tol)
            err = float((y.float() - yr.float()).abs().max())
            print(f"  {label} B{B_} T{T_} H{H}: y max_abs_err {err:.3e} (|y| "
                  f"max {float(yr.float().abs().max()):.3e}; bf16 elements "
                  f"that differ {float((y != yr).float().mean()):.4f}), "
                  f"state {float((s - sr).abs().max()):.3e}; tolerance used "
                  f"y {sy:.3f}, state {ss:.3f} (eps {tol[2]:.2e})")
            if max(sy, ss) > 1:
                fail(f"{name} {label}: kernel disagrees with ssd_reference "
                     f"({sy:.2f} / {ss:.2f} x the tolerance)")
            worst = [max(worst[0], err), max(worst[1], sy, ss)]
            if scale == 0.01:
                keep = (inp, yr, sr, tol)
        # the sensitivity checks, where the carry between chunks matters,
        # after the control: the faulty variant without a fault must agree
        inp, yr, sr, tol = keep
        used = max(ssd_share(*ssd_faulty(*inp, Q), yr, sr, tol))
        print(f"  plain variant without fault: tolerance used {used:.3f}")
        if used > 1:
            fail(f"{name}: ssd_faulty without a fault disagrees with "
                 "ssd_reference")
        for fault, what in (("carry", "inter-chunk carry dropped (y_off = 0)"),
                            ("causal", "causal mask off by one (q > k)"),
                            ("dt", "dt left out of M"),
                            ("decay", "state not decayed by exp(cum_last)")):
            used = max(ssd_share(*ssd_faulty(*inp, Q, fault), yr, sr, tol))
            print(f"  sensitivity: {what} -> {used:.1f} x the tolerance")
            if used <= 1:
                fail(f"{name}: the tolerance would not catch {what}")
        errs[name] = tuple(worst)
        del keep, inp, yr, sr, tol

        nbytes = (2 * B * T * H * P * 2 + B * T * H * 4 + H * 4
                  + 2 * B * T * N * 2 + B * H * P * N * 4)
        sets = [ssd_inputs(B, T, gen, H=H, P=P, N=N)
                for _ in range(copies_for(nbytes))]
        fns = [lambda s=s: ssd_ops.ssd_scan(*s, chunk=Q) for s in sets]
        ms, call = graph_ms(fns), time_ms(fns)
        plain = graph_ms([lambda s=s: ssd_reference(*s, chunk=Q)
                          for s in sets[:2]], iters=4)
        flops = ssd_flops(B, T, H, P, 1, N, Q)
        t = timing[name] = dict(ms=ms, call_ms=call, plain_ms=plain,
                                library_ms=None,
                                bound=bound_ms(nbytes, flops))
        per_sm, blocks = ssd_occupancy(H, B, P, N, Q)
        waves = blocks / (per_sm * torch.cuda.get_device_properties(
            0).multi_processor_count)
        print(f"  {name} grid: {blocks} blocks (batch, head); the card holds "
              f"{per_sm} an SM at once: {waves:.2f} waves")
        print(f"  {name} [B{B} T{T} H{H} P{P} G1 N{N} chunk {Q}]: kernel "
              f"{ms:.4f} ms (device, graph replay; {call:.4f} ms a call back "
              f"to back), plain {plain:.4f} ms, bound {t['bound'][0]:.4f} ms "
              f"({t['bound'][1]}: {nbytes / 1e6:.2f} MB at 3.35 TB/s, "
              f"{flops / 1e9:.3f} GFLOP at the bf16 tensor-core rate), "
              "library_ms none (no single PyTorch call computes the scan)")
        del sets, fns
    print("kernel phase: the full-width SSD instances element by element "
          "against an f64 oracle")
    ssd_f64_check()
    return errs, timing


# ---------------------------------------------------------------------------
# phases 6a and 6: LM-PPO training of gemma2-2b and of mamba2-1.3b
# ---------------------------------------------------------------------------
# the registry op each arch's training holds against op=ref, and its counter
TRAIN_OP = {"dense": ("attention", ops.flash_attention),
            "ssm": ("ssd", ssd_ops.ssd_scan),
            "hybrid": ("ssd", ssd_ops.ssd_scan)}


def train_checks(cfg, tol, run):
    """Serve-path vs train-path logp and the kernel route vs op=ref on the
    weights and first rollout that train.main draws for ``cfg`` at ``run``'s
    batch and horizon.  Returns the rollout's batch."""
    L = cfg.n_layers
    op, counter = TRAIN_OP[cfg.family]
    per_update = 2 * (attn_sites(cfg) if op == "attention" else
                      ssd_layers(cfg))  # forward + recompute
    kern, plain = f"{op}=cuda", f"{op}=ref"
    env = make_token_lm(vocab=cfg.vocab, episode_len=run["horizon"],
                        device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params = bb.init_lm(cfg, device=DEV, generator=gen, dtype=torch.float32,
                        requires_grad=True)
    rollout = train.make_lm_rollout(cfg, env, run["batch"], run["horizon"],
                                    device=DEV)
    traj, v_last = rollout(params, gen)
    batch = train.build_batch(traj, v_last)
    del traj, env
    logp = {}
    for spec in (kern, plain):
        with registry.override(spec), torch.no_grad():
            hidden, _ = bb.forward_train(params, batch["tokens"], cfg)
            logits = bb.lm_logits(params, hidden, cfg).float()
            logp[spec] = torch.gather(F.log_softmax(logits, -1), -1,
                                      batch["actions"].long()[..., None])[
                                          ..., 0]
            del hidden, logits
    gaps = {"serve vs train (kernel)": logp[kern] - batch["logp_old"],
            f"serve vs train ({plain})": logp[plain] - batch["logp_old"],
            f"train kernel vs train {plain}": logp[kern] - logp[plain]}
    st = {}
    for name, d in gaps.items():
        d = d.abs().flatten()
        st[name] = (float(d.mean()), float(d.max()))
        print(f"  {L} layers: |logp diff| {name}: mean {st[name][0]:.4f}, "
              f"max {st[name][1]:.4f}")
    (km, kx), (rm, rx), (dm, dx) = st.values()
    checks = [(km <= tol["logp_mean"], f"mean serve-vs-train gap {km:.4f} > "
               f"{tol['logp_mean']}"),
              (km <= 1.25 * rm and kx <= 2 * rx, "the kernel route's "
               "serve-vs-train gap exceeds the plain route's"),
              (dm <= 1.5 * rm and dx <= 2 * rx, "the kernel route's logp is "
               "farther from the plain route's than rounding")]
    for ok, what in checks:
        if not ok:
            fail(f"{L} layers: {what}")
    out = {}
    for spec in (kern, plain):
        with registry.override(spec):
            opt = optim.sgd(0.0)   # weights stay as they are
            step = make_lm_ppo_train_step(cfg, opt, entropy_coeff=0.003)
            n0 = counter.launches
            _, _, m = step(params, opt.init(params.parameters()), batch)
            torch.cuda.synchronize()
            out[spec] = ({k: float(v) for k, v in m.items()},
                         counter.launches - n0)
    (mk, nk), (mr, nr) = out[kern], out[plain]
    print(f"  {L} layers: kernel route loss {mk['loss']:.6f} grad_norm "
          f"{mk['grad_norm']:.4f} ({nk} launches); {plain} loss "
          f"{mr['loss']:.6f} grad_norm {mr['grad_norm']:.4f} ({nr})")
    if nk != per_update or nr != 0:
        fail(f"{L} layers: {nk} kernel launches on the kernel route (want "
             f"{per_update}: forward + recompute), {nr} on the ref route")
    for k in ("loss", "grad_norm"):
        if not (math.isfinite(mk[k]) and math.isfinite(mr[k])):
            fail(f"{L} layers: non-finite {k}")
        rel = abs(mk[k] - mr[k]) / abs(mr[k])
        lim = tol[f"{k}_rel"]
        print(f"    {k}: relative difference {rel:.3e} (tolerance "
              f"{'none: printed only' if lim is None else lim})")
        if lim is not None and rel > lim:
            fail(f"{L} layers: kernel route and {plain} differ in {k}")
    return batch


def lm_work(cfg, run, batch):
    """The work the profile phase measures on seeded weights: ROLL_STEPS
    decode steps of the rollout (plus its bootstrap step) and one Adam
    update on ``batch``.  Weights and optimizer state live as long as the
    returned closures, so each phase drops them and the profile phase draws
    them again (two full-width trainings do not fit the card together)."""
    env = make_token_lm(vocab=cfg.vocab, episode_len=run["horizon"],
                        device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params = bb.init_lm(cfg, device=DEV, generator=gen, dtype=torch.float32,
                        requires_grad=True)
    short = train.make_lm_rollout(cfg, env, run["batch"], ROLL_STEPS,
                                  device=DEV)
    eager = train.make_lm_rollout(cfg, env, run["batch"], ROLL_STEPS,
                                  device=DEV, graph=False)
    opt = optim.adam(3e-4, grad_clip=1.0)
    state = [opt.init(params.parameters())]
    step = make_lm_ppo_train_step(cfg, opt, entropy_coeff=0.003)

    def update():
        _, state[0], _ = step(params, state[0], batch)

    return {"rollout": lambda: short(params, gen),
            "rollout (eager)": lambda: eager(params, gen), "update": update}


def lm_walls(work):
    """Unprofiled wall time (ms) of each piece of ``work``, the second of
    two runs (the first warms the allocator's cache)."""
    walls = {}
    for name, fn in work.items():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name] = (time.perf_counter() - t0) * 1e3
    return walls


def lm_train_phase(arch, run, tol, log_dir):
    """train.main --arch ``arch`` at full width (cut to ``run['layers']``
    where given) for ``run``'s steps, its launch counts, peak memory and
    metrics, then ``train_checks`` at each depth of ``tol``, shallowest
    first.  Returns (launches by kernel, profile spec)."""
    cfg = get_config(arch)
    full = cfg.n_layers
    cut = ["--layers", str(run["layers"])] if "layers" in run else []
    if cut:
        cfg = dataclasses.replace(cfg, n_layers=run["layers"])
    L = cfg.n_layers
    log_dir = str(Path(log_dir) / arch)
    n_params = sum(p.numel() for p in bb.LM(cfg, device="meta",
                                             dtype=torch.float32).parameters())
    print(f"slice phase: LM-PPO training (full-width {arch}, {L} layers"
          + (f" of {full}" if cut else "") + f" {bb.superblock_layout(cfg)} "
          f"superblocks / layers each / tail, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab}, {n_params} params, batch {run['batch']}, horizon "
          f"{run['horizon']}, {run['steps']} steps)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counters()
    t0 = t_phase = time.perf_counter()
    params = train.main(["--arch", arch, "--full", "--device", "cuda",
                         "--batch", str(run["batch"]), "--horizon",
                         str(run["horizon"]), "--steps", str(run["steps"]),
                         "--seed", str(SEED), "--log-dir", log_dir] + cut)
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    unfused = [p.detach().cpu() for p in params.parameters()] \
        if run.get("graph_checks") else None
    del params
    torch.cuda.empty_cache()
    print(f"  launches in the training run: {launches}; max_memory_allocated "
          f"{peak:.2f} GiB (limit {PEAK_GIB}); {wall:.1f} s")
    steps, T, sites = run["steps"], run["horizon"], attn_sites(cfg)
    want = {"ssd_scan": 2 * ssd_layers(cfg) * steps,
            "flash_attention": 2 * sites * steps,
            "flash_attention_decode": sites * (T + 1) * steps}
    want = {k: want.get(k, 0) for k in launches}
    if launches != want:
        fail(f"training launches {launches}, expected {want} (forward + "
             "recompute a Mamba-2 layer and an attention site an update; a "
             "decode step an attention site a rollout step)")
    if unfused is not None:
        print(f"graph phase: {arch} training with --fuse-window {steps} "
              f"against {steps} unfused steps, then the rollout against "
              "eager")
        zero_kernel_counters()
        t0 = time.perf_counter()
        fused = train.main(["--arch", arch, "--full", "--device", "cuda",
                            "--batch", str(run["batch"]), "--horizon",
                            str(T), "--steps", str(steps), "--seed",
                            str(SEED), "--fuse-window", str(steps),
                            "--log-dir", log_dir + "_fused"] + cut)
        fused_wall = time.perf_counter() - t0
        same = all(torch.equal(p.detach().cpu(), q) for p, q in zip(
            fused.parameters(), unfused))
        rows = [json.loads(ln) for ln in (Path(log_dir + "_fused") /
                "progress.jsonl").read_text().splitlines()]
        flaunches = kernel_launches()
        del fused, unfused
        torch.cuda.empty_cache()
        print(f"  --fuse-window {steps}: params == {steps} unfused steps' bit "
              f"for bit: {same}; one row {rows}; launches {flaunches}; "
              f"{fused_wall:.1f} s")
        if not same or len(rows) != 1 or flaunches != want or not {
                "avg_reward", "loss", "entropy",
                "samples_per_sec"} <= set(rows[0]):
            fail(f"--fuse-window {steps}: params equal {same}, rows {rows}, "
                 f"launches {flaunches}")
        rollout_graph_check(cfg, run)
    if peak > PEAK_GIB:
        fail(f"training peak {peak:.2f} GiB > {PEAK_GIB} GiB")
    rows = [json.loads(ln) for ln in
            (Path(log_dir) / "progress.jsonl").read_text().splitlines()]
    if len(rows) != steps or [r["step"] for r in rows] != \
            list(range(1, steps + 1)):
        fail(f"training logged rows {[r['step'] for r in rows]}")
    for r in rows:
        bad = [k for k, v in r.items() if isinstance(v, float)
               and not math.isfinite(v)]
        if bad:
            fail(f"training step {r['step']}: non-finite {bad}")
    for r in rows:
        print(f"  step {r['step']}: samples_per_sec "
              f"{r['samples_per_sec']:.2f}, rollout_s {r['rollout_s']:.3f}, "
              f"update_s {r['update_s']:.3f}, loss {r['loss']:.5f}, "
              f"grad_norm {r['grad_norm']:.3f}, entropy {r['entropy']:.4f}")
    print("  checks on the same weights and first rollout")
    for depth in sorted(tol):
        batch = train_checks(dataclasses.replace(cfg, n_layers=depth),
                             tol[depth], run)
        torch.cuda.empty_cache()
    work = lm_work(cfg, run, batch)
    walls = lm_walls(work)
    del work
    torch.cuda.empty_cache()
    GRAPH_WALLS[f"{arch} rollout step ({L} layers, B{run['batch']})"] = (
        walls["rollout (eager)"] / (ROLL_STEPS + 1),
        walls["rollout"] / (ROLL_STEPS + 1), "a step")
    print(f"  phase {time.perf_counter() - t_phase:.1f} s")
    return launches, (arch, cfg, run, batch, walls)


def profile_training(spec):
    """Device busy time of ROLL_STEPS rollout steps and of one PPO update
    against their unprofiled wall times (the idle share), on weights drawn
    again (``lm_work``) and warmed once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    arch, cfg, run, batch, walls = spec
    work = lm_work(cfg, run, batch)
    busy_of = {}
    for name, fn in work.items():
        if name == "rollout (eager)":
            replayed_busy(f"rollout (eager) ({arch}, B{run['batch']}, "
                          f"{ROLL_STEPS} + 1 decode steps)", walls[name],
                          busy_of.get("rollout"))
            continue
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        what = (f"{ROLL_STEPS} + 1 decode steps" if name.startswith(
            "rollout") else "one step")
        if not evs:
            print(f"  profile {name}: device time not measured (the profiler "
                  "recorded no CUDA kernels)")
            continue
        busy = busy_of[name] = sum(e.self_device_time_total
                                   for e in evs) / 1e3
        n = sum(e.count for e in evs)
        print(f"  profile {name} ({arch}, B{run['batch']}, {what}): "
              f"wall {walls[name]:.3f} ms unprofiled, device busy "
              f"{busy:.3f} ms ({n} kernels), idle share "
              f"{max(0.0, 1 - busy / walls[name]):.3f}")
        for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:6]:
            print(f"    {e.self_device_time_total / 1e3:8.3f} ms x{e.count}  "
                  f"{e.key[:90]}")
        for e in evs:  # the port's kernels, wherever they rank
            if any(k in e.key for k in ("ssd_scan", "flash_")):
                us = e.self_device_time_total / e.count
                print(f"    {e.key[:40]}: {e.self_device_time_total / 1e3:.3f}"
                      f" ms x{e.count} ({us:.2f} us a launch) of the "
                      f"{busy:.3f} ms")
    del work
    torch.cuda.empty_cache()


def profile_ssd():
    """Each kernel that one ssd_scan call at the training shape launches,
    with its device time a launch (torch.profiler over 20 calls; the
    profiler may miss the first launches of a window, so the count it
    recorded is printed beside)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    inp = ssd_inputs(8, 512, torch.Generator(device=DEV).manual_seed(SEED))
    n = 20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            ssd_ops.ssd_scan(*inp, chunk=256)
        torch.cuda.synchronize()
    ks = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and "ssd_" in e.key]
    if not ks:
        print("  ssd_scan launches: device time not measured (the profiler "
              "recorded no ssd kernel)")
        return
    print(f"  ssd_scan call [B8 T512 H64]: {len(ks)} kernel(s) a call")
    for e in ks:
        print(f"    {e.key[:60]}: {e.self_device_time_total / e.count:.2f} "
              f"us of device time a launch (profiler: {e.count} launches "
              f"recorded over {n} calls)")


# ---------------------------------------------------------------------------
# phase 3 (sum tree): the sampling kernel against its plain version and the
# f64 oracle, then its time
# ---------------------------------------------------------------------------
def st_tree(size, integer, gen):
    """A (2*size,) sum tree on the card, built from its leaves by pairwise
    sums as tree_set builds it; a run of zero leaves and a zero block."""
    leaves = (torch.randint(0, 5, (size,), generator=gen, device=DEV).float()
              if integer else
              torch.rand(size, generator=gen, device=DEV) * 2 + 0.01)
    leaves[size // 3: size // 3 + 300] = 0.0
    leaves[512:1024] = 0.0
    levels = [leaves]
    while levels[-1].numel() > 1:
        levels.append(levels[-1][0::2] + levels[-1][1::2])
    return torch.cat([torch.zeros(1, device=DEV)] + levels[::-1])


def st_positions(flat, total, batch, integer, gen):
    """Stratified positions over ``total``, as replay/device.tree_sample
    draws them; for integer priorities a quarter of them on boundaries of
    the flat leaves, then -1, 0, the total and the total + 3 (as many of the
    four as the batch holds)."""
    u = (torch.arange(batch, device=DEV)
         + torch.rand(batch, generator=gen, device=DEV)) / batch * total
    if integer:
        cum = torch.cumsum(flat.double(), 0)
        u = u.floor()
        k = batch // 4
        u[:k] = cum[torch.randint(0, flat.numel(), (k,), generator=gen,
                                  device=DEV)].float()
        m = min(4, batch - k)
        u[k:k + m] = torch.tensor([-1.0, 0.0, total, total + 3.0],
                                  device=DEV)[:m]
    return u.float()


def st_split(tree):
    """(leaves (n_blocks, bs), block sums) of a tree, as ops reads them."""
    size = tree.shape[0] // 2
    bs = min(512, size)
    nb = size // bs
    return tree[size:].view(nb, bs), tree[nb:2 * nb]


def st_rows(n_blocks, bs, offset, integer, gen):
    """(leaves (n_blocks, bs) viewed ``offset`` floats into their buffer,
    block sums) with a run of zero leaves and a zero block, for
    sample_blocked called directly."""
    size = n_blocks * bs
    buf = torch.zeros(size + offset, device=DEV)
    buf[offset:] = (torch.randint(0, 5, (size,), generator=gen,
                                  device=DEV).float() if integer else
                    torch.rand(size, generator=gen, device=DEV) * 2 + 0.01)
    buf[offset + size // 3: offset + size // 3 + 300] = 0.0
    if n_blocks > 2:
        buf[offset + bs:offset + 2 * bs] = 0.0
    leaves = buf[offset:].view(n_blocks, bs)
    return leaves, leaves.sum(1)


def st_faulty(leaves, bsums, u, fault, root):
    """sample_plain with one fault, for the sensitivity checks: 'lt' uses <
    for <=, 'clamp' drops both clamps, 'base' keeps the block base in the
    residual, 'root' divides by ``root`` instead of the block sums' total."""
    n_blocks, bs = leaves.shape
    cum = torch.cumsum(bsums, 0)
    cmp = (lambda a, b: a < b) if fault == "lt" else (lambda a, b: a <= b)
    blk = cmp(cum[None, :], u[:, None]).sum(1)
    if fault != "clamp":
        blk = blk.clamp(max=n_blocks - 1)
    base = torch.where(blk > 0, cum[(blk - 1).clamp(0, n_blocks - 1)],
                       torch.zeros((), device=u.device))
    off = u if fault == "base" else u - base
    rows = leaves[blk.clamp(max=n_blocks - 1)]
    inner = cmp(torch.cumsum(rows, 1), off[:, None]).sum(1)
    if fault != "clamp":
        inner = inner.clamp(max=bs - 1)
    total = root if fault == "root" else cum[-1]
    pr = torch.gather(rows, 1, inner.clamp(max=bs - 1)[:, None])[:, 0]
    return (blk * bs + inner).to(torch.int32), pr / total


def st_hold(name, idx, prob, leaves, bsums, u, integer, plain=None):
    """The kernel's (idx, prob) and sample_plain's (``plain``, else computed
    here) against the f64 oracle (exact on integer priorities, where
    kernel == plain bit for bit, the rounding rule on real ones); returns
    prob's max abs error."""
    torch.cuda.synchronize()
    flat = leaves.reshape(-1)
    batch = u.shape[0]
    pidx, pprob = sample_plain(leaves, bsums, u) if plain is None else plain
    n_terms = st_ref.rounding_terms(*leaves.shape)
    ks = st_ref.agreement(idx, prob, flat, u, n_terms=n_terms, exact=integer)
    ps = st_ref.agreement(pidx, pprob, flat, u, n_terms=n_terms,
                          exact=integer)
    same = float((idx == pidx).float().mean())
    p64 = flat.double().cpu()
    ref = p64[idx.long().cpu().clamp(0, flat.numel() - 1)] / float(p64.sum())
    err = float((prob.double().cpu() - ref).abs().max())
    print(f"  {name} x {batch}: kernel vs oracle {ks['mismatches']}/{batch} "
          f"indices differ ({ks['mismatches'] / batch:.4f}; rule violations "
          f"{ks['violations']}), plain vs oracle {ps['mismatches']}, kernel "
          f"== plain on {same:.4f}; prob max_abs_err {err:.3e}, "
          f"{ks['prob_rel_err']:.4f} of its bound; delta {ks['delta']:.4g}")
    if not (st_ref.agreement_ok(ks) and st_ref.agreement_ok(ps)):
        fail(f"sum_tree {name}: kernel {ks} / plain {ps}")
    if integer and not (torch.equal(idx, pidx) and torch.equal(prob, pprob)):
        fail(f"sum_tree {name}: kernel and plain differ")
    return err


def sum_tree_kernel_phase():
    gen = torch.Generator(device=DEV).manual_seed(SEED + 11)
    worst = 0.0
    print("kernel phase: sum_tree (tree_sample_blocked, sample_blocked) vs "
          "sample_plain and the f64 oracle (integer priorities: exact, "
          "kernel == plain bit for bit; real: an index may differ from the "
          "oracle's only within delta = (n_blocks + 2 bs + 1) 2^-24 total of "
          "the boundary; prob within (n_blocks + 2 bs + 2) 2^-24 relative)")
    keep = None
    for size, batch in ST_SHAPES:
        for integer in (True, False):
            tree = st_tree(size, integer, gen)
            u = st_positions(tree[size:], float(tree[1]), batch, integer, gen)
            n0 = st_ops.tree_sample_blocked.launches
            idx, prob = st_ops.tree_sample_blocked(tree, u)
            if st_ops.tree_sample_blocked.launches != n0 + 1:
                fail(f"sum_tree {size}: the kernel did not launch")
            leaves, bsums = st_split(tree)
            kind = "integer" if integer else "real"
            worst = max(worst, st_hold(
                f"{kind} priorities, tree of {size} leaves", idx, prob,
                leaves, bsums, u, integer))
            if integer and size == 2 ** 17:
                keep = (tree, u, leaves, bsums)
    for n_blocks, bs, batch, offset in ST_EDGES:
        for integer in (True, False):
            leaves, bsums = st_rows(n_blocks, bs, offset, integer, gen)
            u = st_positions(leaves.reshape(-1), float(bsums.double().sum()),
                             batch, integer, gen)
            idx, prob = sample_blocked(leaves, bsums, u)
            kind = "integer" if integer else "real"
            worst = max(worst, st_hold(
                f"{kind} priorities, {n_blocks} blocks of {bs} leaves"
                f"{f' {4 * offset} B off alignment' if offset else ''}",
                idx, prob, leaves, bsums, u, integer))
    tree, u, leaves, bsums = keep
    size = tree.shape[0] // 2
    n_terms = st_ref.rounding_terms(*leaves.shape)
    root = bsums.sum() * 1.5   # a stale root: 1.5 x the sum of the block sums
    for fault, what in ((None, "no fault"), ("lt", "'<' for '<='"),
                        ("clamp", "clamp dropped (u >= total)"),
                        ("base", "residual keeps the block base"),
                        ("root", "total from a stale root")):
        st = st_ref.agreement(*st_faulty(leaves, bsums, u, fault, root),
                              tree[size:], u, n_terms=n_terms, exact=True)
        ok = st_ref.agreement_ok(st)
        print(f"  sensitivity: {what} -> {st['violations']} index "
              f"violations, prob {st['prob_rel_err']:.3g} x its bound: "
              f"{'passes' if ok else 'caught'}")
        if ok != (fault is None):
            fail(f"sum_tree: the checks would not catch {what}")
    return worst, st_times()


def st_times():
    """The sampler's time at each of ST_TIMED, as device time: the calls
    (cycling through copies of the tree that together exceed L2, at least
    one call a copy) captured in one CUDA graph and replayed.  Beside it the
    eager back-to-back time (whose excess over the graph is the wrapper's
    host time), the plain version, a PyTorch yardstick of two calls
    (``cumsum`` + ``searchsorted``, index only, which the port never calls),
    the bound, and the launch floor: a replayed graph of as many
    one-element ``add_`` launches."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 13)
    floor_x = torch.zeros(1, device=DEV)
    timing = {}
    for size, batch in ST_TIMED:
        tree = st_tree(size, False, gen)
        u = st_positions(tree[size:], float(tree[1]), batch, False, gen)
        sets = [(tree.clone(), u.clone())
                for _ in range(copies_for(tree.numel() * 4))]
        iters = max(200, len(sets))
        kernel = [lambda s=s: st_ops.tree_sample_blocked(*s) for s in sets]
        ms = graph_ms(kernel, iters=iters)
        eager = time_ms(kernel, iters=iters)
        plain = graph_ms([lambda s=s: sample_plain(*st_split(s[0]), s[1])
                          for s in sets], iters=iters)
        lib = graph_ms([lambda s=s: torch.searchsorted(
            torch.cumsum(s[0][size:], 0), s[1], right=True) for s in sets],
            iters=iters)
        floor = graph_ms([lambda: floor_x.add_(1.0)], iters=iters)
        leaves, bsums = st_split(tree)
        idx, _ = st_ops.tree_sample_blocked(tree, u)
        rows = int(torch.unique(idx.long() // leaves.shape[1]).numel())
        # bytes this run's data needs: the block sums, each row a sample
        # lands in (once), u, idx and prob
        nbytes = 4 * (bsums.numel() + rows * leaves.shape[1] + 3 * batch)
        flops = batch * (2 * leaves.shape[1] + math.ceil(
            math.log2(bsums.numel() + 1))) + bsums.numel()
        bound = bound_ms(nbytes, flops, PEAK_F32_FLOPS)
        timing[(size, batch)] = dict(ms=ms, eager_ms=eager, plain_ms=plain,
                                     library_ms=lib, floor_ms=floor,
                                     bound=bound, nbytes=nbytes)
        print(f"  sum_tree [{size} leaves, {bsums.numel()} blocks of "
              f"{leaves.shape[1]}, {batch} samples, {rows} rows; graph of "
              f"{iters} calls over {len(sets)} copies]: kernel {ms:.5f} ms "
              f"a call (eager {eager:.5f} ms: host {eager - ms:.5f} ms), "
              f"bound {bound[0]:.7f} ms ({bound[1]}: {nbytes} B), launch "
              f"floor {floor:.5f} ms, plain {plain:.5f} ms, library_ms "
              f"(cumsum + searchsorted, two calls) {lib:.5f} ms")
    return timing


def st_profile():
    """The sampler's device time a launch at each of ST_TIMED, from
    torch.profiler (run last: the profiler slows every later launch)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev_us = {}
    gen = torch.Generator(device=DEV).manual_seed(SEED + 5)
    for size, batch in ST_TIMED:
        tree = st_tree(size, False, gen)
        u = st_positions(tree[size:], float(tree[1]), batch, False, gen)
        st_ops.tree_sample_blocked(tree, u)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(100):
                st_ops.tree_sample_blocked(tree, u)
            torch.cuda.synchronize()
        ks = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and "sum_tree" in e.key]
        if ks:
            dev_us[(size, batch)] = (ks[0].self_device_time_total
                                     / ks[0].count)
            print(f"  sum_tree_sample_kernel device time [{size} leaves x "
                  f"{batch}]: {dev_us[(size, batch)]:.3f} us a launch "
                  f"(profiler, {ks[0].count} launches)")
        else:
            print(f"  sum_tree_sample_kernel device time [{size} leaves x "
                  f"{batch}]: not measured (no CUDA kernel recorded)")
    return dev_us


# ---------------------------------------------------------------------------
# phase 7: prioritized DQN on Catch
# ---------------------------------------------------------------------------
def finite_rows(path, what):
    rows = [json.loads(ln) for ln in Path(path).read_text().splitlines()]
    for r in rows:
        bad = [k for k, v in r.items() if isinstance(v, float)
               and not math.isfinite(v)]
        if bad:
            fail(f"{what} step {r['step']}: non-finite {bad}")
    return rows


def rl_phase(log_dir):
    launches = {}
    rl_dir = str(Path(log_dir) / "catch")
    print(f"slice phase: prioritized DQN on Catch ({RL['variant']}, "
          f"{RL['iters']} iterations, the example's settings)")
    st_ops.tree_sample_blocked.launches = 0
    t0 = time.perf_counter()
    greedy = catch_dqn.main(["--variant", RL["variant"], "--device", "cuda",
                             "--iters", str(RL["iters"]), "--seed", str(SEED),
                             "--log-dir", rl_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["rainbow"] = st_ops.tree_sample_blocked.launches
    rows = finite_rows(Path(rl_dir) / "progress.jsonl", "rainbow")
    if len(rows) != RL["iters"] // 25:
        fail(f"rainbow logged {len(rows)} rows")
    want = 2 * RL["iters"]
    print(f"  sum_tree launches: {launches['rainbow']} (want {want}: one "
          f"per prioritized sample); {wall:.2f} s with warm-up and greedy "
          f"eval; last row samples_per_sec {rows[-1]['samples_per_sec']:.1f}, "
          f"avg_return {rows[-1]['avg_return']:.4f}, loss "
          f"{rows[-1]['loss']:.4f}; greedy {greedy}")
    if launches["rainbow"] != want:
        fail(f"rainbow: {launches['rainbow']} sum_tree launches, want {want}")

    print(f"slice phase: the learning bar of test_dqn_learns_catch (dueling "
          f"+ double + prioritized, {RL['bar_iters']} iterations, "
          f"{RL['bar_updates']} updates a collect)")
    st_ops.tree_sample_blocked.launches = 0
    sampler, runner = catch_dqn.make_runner(
        "dueling", RL["bar_iters"], updates_per_collect=RL["bar_updates"],
        log_interval=RL["bar_iters"], logger=Logger(sinks=()))
    t0 = time.perf_counter()
    ts, ss, info = runner.run(SEED, device=DEV)
    stats = catch_dqn.greedy_eval(sampler, ts.params, ss)
    wall = time.perf_counter() - t0
    launches["learning bar"] = st_ops.tree_sample_blocked.launches
    print(f"  greedy eval over 4 collects: {stats}; loss {float(info.loss):.4f}"
          f"; {launches['learning bar']} sum_tree launches; {wall:.2f} s")
    if not stats["avg_return"] > 0.0:
        fail(f"Catch learning bar: greedy avg_return {stats['avg_return']} "
             f"<= 0")

    cap = RL["big_capacity"]
    print(f"slice phase: rainbow at rlpyt's Atari replay scale (capacity "
          f"{cap}, {RL['big_iters']} iterations)")
    st_ops.tree_sample_blocked.launches = 0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    _, runner = catch_dqn.make_runner("rainbow", RL["big_iters"],
                                      replay_capacity=cap, log_interval=10,
                                      logger=Logger(sinks=()))
    ts, ss, info = runner.run(SEED, device=DEV)
    rs = runner.replay_state
    torch.cuda.synchronize()
    launches["2^20 replay"] = st_ops.tree_sample_blocked.launches
    store = sum(t.numel() * t.element_size() for t in rs.storage.values())
    print(f"  storage {store / 1e9:.3f} GB, tree {rs.tree.numel()} floats, "
          f"filled {rs.filled}; loss {float(info.loss):.4f}, grad_norm "
          f"{float(info.grad_norm):.4f}; {launches['2^20 replay']} sum_tree "
          f"launches (over {cap // 512} blocks); peak memory of the run "
          f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB "
          f"above the {base / 2**30:.2f} GiB earlier phases hold")
    if launches["2^20 replay"] != 2 * RL["big_iters"] or not all(
            math.isfinite(float(x)) for x in (info.loss, info.grad_norm)):
        fail(f"2^20 replay: {launches['2^20 replay']} launches, loss "
             f"{float(info.loss)}")
    del rs, runner, ts, ss
    torch.cuda.empty_cache()

    print(f"graph phase: {RL['variant']} fused against unfused "
          f"({RL['identity_iters']} iterations: the first log window and the "
          "target copy at update 100)")

    def rainbow(n):
        return catch_dqn.make_runner(RL["variant"], n,
                                     logger=Logger(sinks=()))[1], None

    replays = fused_identity(f"{RL['variant']} (the example's settings)",
                             lambda: rainbow(RL["identity_iters"]),
                             RL["identity_iters"])
    if len(replays) < 2:
        fail(f"rainbow: the fused run kept {len(replays)} graph(s); the "
             "target copy's branch needs its own")
    # unprofiled wall time of RL iterations for the profile phase
    return launches, iteration_walls(
        "rainbow iteration (collect 16 x 16, 2 updates)", lambda: rainbow(2),
        RL["profile_iters"])


def profile_rl(work):
    """Device busy time of RL iterations, eager and fused, against their
    unprofiled wall time, and the sum-tree kernel's own device time per
    launch."""
    profile_walls("RL iteration (rainbow, collect 16 x 16 + 2 updates)",
                  work, RL["profile_iters"])
    st_profile()


# ---------------------------------------------------------------------------
# phase 8: PPO and A2C on CartPole (the quickstart and the learning bars)
# ---------------------------------------------------------------------------
KERNEL_COUNTERS = (ops.flash_attention, ops.flash_attention_decode,
                   ssd_ops.ssd_scan, st_ops.tree_sample_blocked)


def kernel_launches():
    return {c.__name__: c.launches for c in KERNEL_COUNTERS}


def zero_kernel_counters():
    for c in KERNEL_COUNTERS:
        c.launches = 0


def profile_work(label, fn, wall, n):
    """Device busy time of ``fn`` (``n`` units of work) against its
    unprofiled wall time per unit (ms): the idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not evs:
        print(f"  profile {label}: device time not measured (the profiler "
              "recorded no CUDA kernels)")
        return None
    busy = sum(e.self_device_time_total for e in evs) / 1e3 / n
    kernels = sum(e.count for e in evs) / n
    print(f"  profile {label}: wall {wall:.3f} ms unprofiled, device busy "
          f"{busy:.3f} ms ({kernels:.0f} kernels), idle share "
          f"{max(0.0, 1 - busy / wall):.3f}")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"    {e.self_device_time_total / 1e3 / n:8.4f} ms "
              f"x{e.count / n:.0f}  {e.key[:90]}")
    return busy


def replayed_busy(label, wall, busy):
    """The other path's line: its wall beside the profiled path's device
    busy time (a graph replays the eager step's kernels, so their device
    time is the same: within 4 % where both were profiled, PERF.md)."""
    if busy is None:
        print(f"  profile {label}: wall {wall:.3f} ms unprofiled, device "
              "time not measured")
        return
    print(f"  profile {label}: wall {wall:.3f} ms unprofiled, device busy "
          f"{busy:.3f} ms (the same kernels), idle share "
          f"{max(0.0, 1 - busy / wall):.3f}")


def pg_phase(log_dir):
    t_phase = time.perf_counter()
    pg_dir = str(Path(log_dir) / "quickstart")
    print(f"slice phase: PPO on CartPole (the quickstart: {PG['iters']} "
          "iterations of 16 envs x horizon 64, EvalSampler, sentinels)")
    zero_kernel_counters()
    t0 = time.perf_counter()
    final = quickstart.main(["--device", "cuda", "--seed", str(SEED),
                             "--iters", str(PG["iters"]), "--log-dir", pg_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = kernel_launches()
    rows = finite_rows(Path(pg_dir) / "progress.jsonl", "quickstart")
    if len(rows) != PG["iters"] // PG["log_interval"]:
        fail(f"quickstart logged {len(rows)} rows")
    for r in rows:
        if "eval_avg_return" not in r or r["sent_nonfinite_params"] != 0:
            fail(f"quickstart iter {r['iter']}: eval_avg_return "
                 f"{r.get('eval_avg_return')}, sent_nonfinite_params "
                 f"{r.get('sent_nonfinite_params')}")
        print(f"  iter {r['iter']:.0f}: avg_return {r['avg_return']:.2f}, "
              f"eval_avg_return {r['eval_avg_return']:.2f} "
              f"({r['eval_episodes']:.0f} episodes), samples_per_sec "
              f"{r['samples_per_sec']:.1f}, loss {r['loss']:.4f}, "
              f"sent_update_norm {r['sent_update_norm']:.4f}")
    print(f"  {wall:.2f} s for {PG['iters']} iterations with {len(rows)} "
          f"evaluations; "
          f"final stats {final}; kernel launches {launched}")
    if any(launched.values()):
        fail(f"the PPO path launched a kernel: {launched}")

    bars = {}
    for name, bar in quickstart.BARS.items():
        t0 = time.perf_counter()
        ret = quickstart.learning_bar(name, seed=SEED, device=DEV)
        bars[name] = ret
        print(f"  learning bar {name}: {bar['iters']} iterations of 16 x "
              f"{bar['horizon']}, eval return {ret:.2f} (bar "
              f"{bar['threshold']:g}); {time.perf_counter() - t0:.2f} s")
        if not ret > bar["threshold"]:
            fail(f"CartPole {name} return {ret} <= {bar['threshold']}")

    print(f"graph phase: the quickstart fused against unfused "
          f"({PG['log_interval']} iterations: its first log window)")

    def ppo(n):
        return quickstart.make_runner(n, log_interval=PG["log_interval"],
                                      logger=Logger(sinks=()))[1], None

    fused_identity("PPO CartPole (the quickstart's settings)",
                   lambda: ppo(PG["log_interval"]), PG["log_interval"])
    # unprofiled wall time of quickstart iterations for the profile phase
    work = iteration_walls("quickstart iteration (collect 16 x 64, 16 PPO "
                           "minibatch updates, sentinels)", lambda: ppo(2),
                           PG["profile_iters"])
    print(f"  phase {time.perf_counter() - t_phase:.1f} s")
    return work


def profile_pg(work):
    """Device busy time of quickstart iterations against their unprofiled
    wall time."""
    profile_walls("PPO CartPole iteration (collect 16 x 64 + 16 updates "
                  "+ sentinels)", work, PG["profile_iters"])


# ---------------------------------------------------------------------------
# phase 9: DDPG, TD3 and SAC on Pendulum (full width, prioritized, the SAC
# bar, checkpoints on the card)
# ---------------------------------------------------------------------------
def params_finite(ts) -> bool:
    leaves = [x for x in pytree.tree_leaves(
        (ts.params, ts.extra)) if torch.is_tensor(x)]
    return bool(torch.stack([torch.isfinite(x).all() for x in leaves]).all())


def watch_td3_actor(algo, n_updates):
    """Wrap ``algo.update`` to record, for each update (update j makes step
    j + 1), the largest change of any actor param into a device buffer at
    a device index: the record is part of the update, so it holds when the
    update is replayed from a graph.  Returns (record, count), read once at
    the end."""
    update = algo.update
    record = torch.full((n_updates,), float("nan"), device=DEV)
    count = torch.zeros((1,), dtype=torch.long, device=DEV)

    def watched(ts, batch, generator=None):
        before = [p.clone() for p in
                  pytree.tree_leaves(ts.params["actor"])]
        ts, info = update(ts, batch, generator)
        moved = torch.stack([(p - b).abs().max() for p, b in zip(
            pytree.tree_leaves(ts.params["actor"]), before)]).max()
        record.index_copy_(0, torch.clamp(count, max=n_updates - 1),
                           moved[None])
        count.add_(1)
        return ts, info

    algo.update = watched
    return record, count


def qpg_run(name, log_dir, n_iterations, **kw):
    """One full-width run of ``name`` through OffPolicyRunner; fails unless
    every logged number, param and target is finite (and, for TD3, the
    actor is bit-unchanged by every odd update).  Returns (runner, train
    state, sampler state, rows, wall s)."""
    run_dir = Path(log_dir) / f"qpg_{name}"
    sampler, runner, init = pendulum_qpg.make_runner(
        name, n_iterations, logger=Logger(str(run_dir), sinks=("jsonl",)),
        **kw)
    n_up = runner.loop.k * n_iterations
    seen = watch_td3_actor(runner.algo, n_up) if name == "td3" else None
    params = init(torch.Generator(device=DEV).manual_seed(SEED))
    t0 = time.perf_counter()
    ts, ss, info = runner.run(SEED, params=params, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = finite_rows(run_dir / "progress.jsonl", f"qpg {name}")
    if len(rows) != n_iterations // 10 or not params_finite(ts):
        fail(f"qpg {name}: {len(rows)} rows, params finite "
             f"{params_finite(ts)}")
    if seen is not None:
        record, count = seen
        if int(count) != n_up:
            fail(f"td3: {int(count)} updates recorded, want {n_up}")
        moved = {j + 1: float(m) for j, m in enumerate(record.tolist())}
        odd = [s for s, m in moved.items() if s % 2 and m != 0.0]
        if odd or not any(m > 0 for s, m in moved.items() if s % 2 == 0):
            fail(f"td3: actor moved on odd steps {odd[:5]} or never on even")
        print(f"  td3: actor bit-unchanged by {len(moved) // 2} odd updates, "
              f"moved by the even ones (largest change "
              f"{max(moved.values()):.3e})")
    return runner, ts, ss, rows, wall


def qpg_phase(log_dir):
    t_phase = time.perf_counter()
    launches, work = {}, {}
    n_up = 8
    print(f"slice phase: DDPG / TD3 / SAC on Pendulum (hidden 256 x 256, "
          f"twin critics, 8 envs x 32, capacity 2^20, batch 256, "
          f"{QPG['iters']} iterations of {n_up} updates)")
    for name in QPG["algos"]:
        zero_kernel_counters()
        runner, ts, ss, rows, wall = qpg_run(name, log_dir, QPG["iters"])
        launched = kernel_launches()
        r = rows[-1]
        extra = (f", alpha {r['alpha']:.4f}, entropy {r['entropy']:.4f}"
                 if name == "sac" else "")
        print(f"  {name}: {wall:.2f} s with warm-up; last row samples_per_sec "
              f"{r['samples_per_sec']:.1f}, loss {r['loss']:.4f}, actor_loss "
              f"{r['actor_loss']:.4f}, avg_return {r['avg_return']:.2f}"
              f"{extra}; step {ts.step}; kernel launches {launched}")
        if ts.step != QPG["iters"] * n_up or any(launched.values()):
            fail(f"qpg {name}: step {ts.step}, launches {launched}")
        if name == "sac":
            alpha = float(torch.exp(ts.extra["log_alpha"]))
            if not (math.isfinite(alpha) and alpha > 0):
                fail(f"sac: alpha {alpha}")
        del runner, ts, ss
        torch.cuda.empty_cache()

    print(f"slice phase: TD3 and SAC prioritized (capacity 2^20, "
          f"{QPG['prio_iters']} iterations)")
    for name in ("td3", "sac"):
        st_ops.tree_sample_blocked.launches = 0
        runner, ts, _, rows, wall = qpg_run(
            name, str(Path(log_dir) / "prio"), QPG["prio_iters"],
            prioritized=True)
        n = st_ops.tree_sample_blocked.launches
        launches[f"{name} prioritized"] = n
        want = QPG["prio_iters"] * n_up
        leaves = runner.replay_state.tree[2 ** 20:]
        print(f"  {name}: {n} sum_tree launches (want {want}: one per "
              f"sample); {wall:.2f} s; loss {rows[-1]['loss']:.4f}; "
              f"{int(torch.unique(leaves[:runner.replay_state.filled]).numel())}"
              f" distinct priorities")
        if n != want:
            fail(f"{name} prioritized: {n} sum_tree launches, want {want}")
        del runner, ts
        torch.cuda.empty_cache()

    bar = pendulum_qpg.BAR
    print(f"slice phase: the SAC bar of test_sac_improves_pendulum (hidden "
          f"64, {bar['iters']} iterations of {bar['updates_per_collect']} "
          f"updates, batch {bar['batch_size']})")
    t0 = time.perf_counter()
    before, after = pendulum_qpg.learning_bar(SEED, device=DEV)
    bar_wall = time.perf_counter() - t0
    n_updates = bar["iters"] * bar["updates_per_collect"]
    print(f"  before {before:.2f} (bar < {bar['before_max']:g}), after "
          f"{after:.2f} (bar > before + {bar['gain']:g}); {bar_wall:.2f} s "
          f"for {n_updates} updates and {bar['iters']} collects")
    if not (before < bar["before_max"] and after > before + bar["gain"]):
        fail(f"SAC pendulum bar: {before} -> {after}")

    print(f"slice phase: SAC checkpoints on the card ({QPG['ckpt_iters'][0]} "
          f"iterations saving every {QPG['ckpt_interval']}, then restore and "
          f"run to {QPG['ckpt_iters'][1]})")
    with tempfile.TemporaryDirectory() as ckpt:
        kw = dict(ckpt_dir=ckpt, ckpt_interval=QPG["ckpt_interval"],
                  logger=Logger(sinks=()))
        _, r1, init = pendulum_qpg.make_runner("sac", QPG["ckpt_iters"][0],
                                               **kw)
        t0 = time.perf_counter()
        ts1, _, _ = r1.run(SEED, params=init(torch.Generator(
            device=DEV).manual_seed(SEED)), device=DEV)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        saved = (ts1, r1.replay_state)
        t0 = time.perf_counter()
        restored, manifest = restore_checkpoint(ckpt, saved, device=DEV)
        t_restore = time.perf_counter() - t0
        pairs = list(zip(pytree.tree_leaves(restored),
                         pytree.tree_leaves(saved)))
        tensors = [(a, b) for a, b in pairs if torch.is_tensor(b)]
        same = all(torch.equal(a, b) and a.device.type == DEV.type
                   for a, b in tensors) and \
            all(a == b for a, b in pairs if not torch.is_tensor(b))
        nbytes = sum(b.numel() * b.element_size() for _, b in tensors)
        _, r2, _ = pendulum_qpg.make_runner("sac", QPG["ckpt_iters"][1], **kw)
        ts2, _, _ = r2.run(SEED, params=init(torch.Generator(
            device=DEV).manual_seed(SEED + 9)), restore=True, device=DEV)
        want = QPG["ckpt_iters"][1] * n_up
        print(f"  run with 2 saves {t_run:.2f} s; restore of {len(pairs)} "
              f"leaves ({nbytes / 1e6:.1f} MB) onto {DEV}: {t_restore:.3f} s, "
              f"equal bit for bit: {same}; iteration "
              f"{manifest['extra']['iteration']}; resumed run ends at step "
              f"{ts2.step} (want {want})")
        if not same or manifest["extra"]["iteration"] != QPG["ckpt_iters"][0] \
                or ts2.step != want:
            fail("sac checkpoint: restore not bit-exact on the card or the "
                 f"resumed run ended at step {ts2.step}")
        del r1, r2, ts1, ts2, saved, restored
    torch.cuda.empty_cache()

    print(f"graph phase: DDPG / TD3 / SAC fused against unfused "
          f"({QPG['iters']} iterations: the first log window)")
    for name in QPG["algos"]:
        def make(name=name):
            _, runner, init = pendulum_qpg.make_runner(
                name, QPG["iters"], logger=Logger(sinks=()))
            return runner, init(torch.Generator(device=DEV).manual_seed(SEED))

        fused_identity(f"{name} (hidden 256, capacity 2^20, {n_up} updates "
                       "an iteration)", make, QPG["iters"])

    def sac(n=2):
        _, runner, init = pendulum_qpg.make_runner("sac", n,
                                                   logger=Logger(sinks=()))
        return runner, init(torch.Generator(device=DEV).manual_seed(SEED))

    work["iteration"] = iteration_walls(
        f"SAC iteration (hidden 256, collect 8 x 32, {n_up} updates)", sac,
        QPG["profile_iters"])
    # unprofiled wall time of SAC updates for the profile phase, at the
    # bar's width and at full width
    n = QPG["profile_updates"]
    for label, kw in (("hidden 64, batch 128", {k: bar[k] for k in (
            "hidden", "replay_capacity", "batch_size", "min_replay")}),
            ("hidden 256, batch 256", {})):
        _, runner, init = pendulum_qpg.make_runner(
            "sac", 1, updates_per_collect=1, logger=Logger(sinks=()), **kw)
        ts, _, _ = runner.run(SEED, params=init(torch.Generator(
            device=DEV).manual_seed(SEED)), device=DEV)
        state = {"ts": ts, "rs": runner.replay_state,
                 "gen": torch.Generator(device=DEV).manual_seed(SEED + 3)}

        def update(k=n, runner=runner, state=state):
            for _ in range(k):
                state["ts"], state["rs"], _ = runner.loop.update_step(
                    state["ts"], state["rs"], state["gen"])
            torch.cuda.synchronize()

        update(3)
        t0 = time.perf_counter()
        update()
        wall = (time.perf_counter() - t0) * 1e3 / n
        work[label] = (update, wall)
        print(f"  one SAC update ({label}: sample, three losses and "
              f"backward passes, three Adam steps, Polyak): {wall:.3f} ms "
              "unprofiled")
    print(f"  phase {time.perf_counter() - t_phase:.1f} s")
    return launches, work


def profile_qpg(work):
    """Device busy time of SAC iterations (eager and fused) and updates
    against their unprofiled wall."""
    work = dict(work)
    profile_walls("SAC iteration (hidden 256, collect 8 x 32 + 8 updates)",
                  work.pop("iteration"), QPG["profile_iters"])
    for label, (update, wall) in work.items():
        profile_work(f"SAC update ({label})", update, wall,
                     QPG["profile_updates"])


# ---------------------------------------------------------------------------
# phase 10: R2D1 (the r2d1_recurrent twin, lockstep determinism, one
# learner update at the JAX factories' full width)
# ---------------------------------------------------------------------------
def stats_finite(what, stats):
    bad = [k for k, v in stats.items() if not math.isfinite(float(v))]
    if bad:
        fail(f"{what}: non-finite stats {bad}")


def r2d1_full_width_batch(gen):
    """A sequence batch at the full-width shapes, drawn on the card: 64
    sequences of seq_len 80 + 1 frames of 84 x 84 x 4 f32 in [0, 1)."""
    B, L1, A, H = R2D1_FULL["batch"], R2D1_FULL["seq_len"] + 1, \
        R2D1_FULL["actions"], R2D1_FULL["d_lstm"]

    def ints(high):
        return torch.randint(0, high, (B, L1), generator=gen, device=DEV,
                             dtype=torch.int32)

    seq = SequenceSamples(
        observation=torch.rand((B, L1, 84, 84, 4), generator=gen, device=DEV),
        prev_action=ints(A), prev_reward=ints(3).float() - 1.0,
        action=ints(A), reward=ints(3).float() - 1.0,
        done=torch.rand((B, L1), generator=gen, device=DEV) < 0.01,
        init_state=None)
    state = tuple(0.1 * torch.randn((B, H), generator=gen, device=DEV)
                  for _ in range(2))
    w = 0.5 + 0.5 * torch.rand((B,), generator=gen, device=DEV)
    return {"sequence": seq, "init_state": state, "is_weights": w}


def r2d1_phase(log_dir):
    t_phase = time.perf_counter()
    cfg = R2D1_CFG
    run_dir = Path(log_dir) / "r2d1"
    print(f"slice phase: R2D1 on Catch (the r2d1_recurrent twin: 16 envs x "
          f"8 alternating, d_lstm 64, conv (16, 32), T_size 2048, seq_len 16, "
          f"burn-in 4, batch 32, replay ratio 2, {cfg['iters']} iterations, "
          f"threaded)")
    zero_kernel_counters()
    _, runner = r2d1_recurrent.make_runner(
        cfg["iters"], logger=Logger(str(run_dir), sinks=("jsonl",)))
    t0 = time.perf_counter()
    ts, _, info = runner.run(SEED, device=DEV)
    wall = time.perf_counter() - t0
    launched = kernel_launches()
    rows = finite_rows(run_dir / "progress.jsonl", "r2d1")
    st, buf = runner.stats, runner.buffer
    stats_finite("r2d1", st)
    filled = buf.slot_pr[:buf.filled // buf.state_interval]
    moved = int((filled != 1.0).sum())
    print(f"  {wall:.2f} s; stats {st}; {len(rows)} rows, last: loss "
          f"{rows[-1]['loss']:.4f}, avg_return {rows[-1]['avg_return']:.3f}, "
          f"samples_per_sec {rows[-1]['samples_per_sec']:.1f}, staleness "
          f"mean {rows[-1]['param_staleness_mean']:.2f} max "
          f"{rows[-1]['param_staleness_max']:.0f}; {moved} of {filled.size} "
          f"sequence priorities moved off 1.0; kernel launches {launched}")
    if not rows or st["updates"] <= 0 or \
            st["replay_ratio_actual"] > 2.0 + 1e-9 or moved == 0 or \
            any(launched.values()) or \
            not params_finite(ts) or \
            not math.isfinite(float(info.loss)):
        fail(f"r2d1: rows {len(rows)}, stats {st}, {moved} priorities "
             f"moved, launches {launched}")
    del runner, ts

    n, k = cfg["lockstep_iters"], cfg["lockstep_target_interval"]
    print(f"slice phase: R2D1 lockstep twice at seed {SEED} ({n} iterations "
          f"each, target refreshed every {k} updates, cudnn.deterministic)")
    finals = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for _ in range(2):
            _, runner = r2d1_recurrent.make_runner(
                n, threaded=False, logger=Logger(sinks=()),
                target_update_interval=k)
            ts, _, _ = runner.run(SEED, device=DEV)
            buf = runner.buffer
            finals.append((pytree.tree_leaves((ts.params, ts.extra)),
                           runner.stats,
                           buf.slot_pr[:buf.filled // buf.state_interval]))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (p1, s1, pr1), (p2, s2, pr2) = finals
    same = all(torch.equal(a, b) for a, b in zip(p1, p2)) and \
        np.array_equal(pr1, pr2)
    rel = max(float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
              for a, b in zip(p1, p2))
    refreshes = s1["updates"] // k
    print(f"  updates {s1['updates']} / {s2['updates']} ({refreshes} target "
          f"refreshes, {s1['updates'] * runner.batch_size} sequence priority "
          f"write-backs each); final params, target and stored priorities "
          f"bit-identical: {same} (largest relative difference {rel:.3e}); "
          f"one thread: a collect {s1['collect_ms']:.3f} / "
          f"{s2['collect_ms']:.3f} ms, an update {s1['update_ms']:.3f} / "
          f"{s2['update_ms']:.3f} ms of busy time")
    if s1["updates"] != s2["updates"] or refreshes == 0 or not same:
        fail(f"r2d1 lockstep: two runs at one seed differ or cross no target "
             f"refresh (updates {s1['updates']} / {s2['updates']}, relative "
             f"{rel:.3e})")
    del finals, runner, ts

    print(f"slice phase: one R2D1 learner update at the JAX factories' full "
          f"width (make_recurrent_q defaults: d_lstm 256, conv (32, 64, 64), "
          f"84 x 84 x 4, {R2D1_FULL['actions']} actions; R2D1 defaults: "
          f"burn-in 40, n_step 5, gamma 0.997; seq_len 80, batch "
          f"{R2D1_FULL['batch']})")
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = make_recurrent_q(4, R2D1_FULL["actions"], conv=True)
    algo = R2D1(model.apply, optim.adam(1e-4))
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    state = {"ts": algo.init_train_state(gen, model.init(gen)),
             "batch": r2d1_full_width_batch(gen)}
    obs_mb = state["batch"]["sequence"].observation.numel() * 4 / 1e6
    zero_kernel_counters()

    def update(k=R2D1_FULL["timed"]):
        for _ in range(k):
            state["ts"], state["info"] = algo.update(state["ts"],
                                                     state["batch"])
        torch.cuda.synchronize()

    update(R2D1_FULL["warmup"])
    t0 = time.perf_counter()
    update()
    up_wall = (time.perf_counter() - t0) * 1e3 / R2D1_FULL["timed"]
    info, launched = state["info"], kernel_launches()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    print(f"  observations {obs_mb:.1f} MB f32 on the card; one update "
          f"{up_wall:.3f} ms of wall (mean of {R2D1_FULL['timed']} after "
          f"{R2D1_FULL['warmup']} warm-up, unprofiled); loss "
          f"{float(info.loss):.5f}, grad_norm {float(info.grad_norm):.4f}, "
          f"td_abs_max shape {tuple(info.extra['td_abs_max'].shape)}; peak "
          f"memory {peak:.3f} GiB above the {base / 2**30:.2f} GiB held "
          f"before; kernel launches {launched}")
    if not (math.isfinite(float(info.loss)) and
            math.isfinite(float(info.grad_norm))) or \
            tuple(info.extra["td_abs_max"].shape) != (R2D1_FULL["batch"],) or \
            tuple(info.extra["td_abs_mean"].shape) != (R2D1_FULL["batch"],) \
            or any(launched.values()):
        fail(f"r2d1 full width: loss {float(info.loss)}, launches {launched}")
    print(f"  phase {time.perf_counter() - t_phase:.1f} s")
    return (lambda: update(R2D1_FULL["profiled"]), up_wall)


# ---------------------------------------------------------------------------
# phase 11: the asynchronous runner (the mujoco_style_sac twin, async A2C at
# staleness 0 against TrainLoop, an R2D1 checkpoint restored on the card)
# ---------------------------------------------------------------------------
def async_a2c_identity():
    """Lockstep async A2C with V-trace at staleness 0 against TrainLoop on
    one seed (the stack of tests/test_async_rl.py)."""
    n, seed = ASYNC["a2c_iters"], SEED + 7
    model = make_pg_mlp(4, 2)
    agent = make_categorical_pg_agent(model)
    algo = A2C(model.apply, optim.adam(1e-3), distribution=Categorical(2),
               gamma=0.99, gae_lambda=0.95)
    sampler = SerialSampler(make_env("cartpole"), agent, 8, 16)
    params = agent.init_params(torch.Generator(device=DEV).manual_seed(seed))
    clone = lambda: pytree.tree_map(lambda p: p.clone(), params)  # noqa: E731
    ts = algo.init_train_state(None, clone())
    ss = sampler.init(torch.Generator(device=DEV).manual_seed(seed + 1))
    ts_sync = TrainLoop(sampler, algo).run_window(
        ts, ss, None, torch.Generator(device=DEV).manual_seed(seed + 2), n)[0]
    runner = AsyncRunner(sampler, algo, n_iterations=n, log_interval=n,
                         threaded=False, logger=Logger(sinks=()))
    ts_async, _, _ = runner.run(seed, params=clone(), device=DEV)
    diff = max(float((a - b).abs().max()) for a, b in zip(
        pytree.tree_leaves(ts_sync.params),
        pytree.tree_leaves(ts_async.params)))
    moved = max(float((a - b).abs().max()) for a, b in zip(
        pytree.tree_leaves(ts_async.params), pytree.tree_leaves(params)))
    print(f"  async A2C (lockstep, V-trace, staleness 0) vs TrainLoop, {n} "
          f"iterations: largest param difference {diff:.3e} (bound 1e-4; "
          f"the params moved by up to {moved:.3e}); replay_ratio_actual "
          f"{runner.stats['replay_ratio_actual']}")
    if not diff < 1e-4 or not moved > 1e-3:
        fail(f"async A2C at staleness 0: {diff} from TrainLoop")


def r2d1_checkpoint():
    """An R2D1 checkpoint and its sidecar saved on the card, restored by a
    second runner (bit for bit, resuming at the saved iteration), then run
    on by a third."""
    n0, n1 = ASYNC["ckpt_iters"]
    with tempfile.TemporaryDirectory() as ckpt:
        kw = dict(threaded=False, ckpt_dir=ckpt,
                  ckpt_interval=ASYNC["ckpt_interval"],
                  logger=Logger(sinks=()))
        _, r1 = r2d1_recurrent.make_runner(n0, **kw)
        t0 = time.perf_counter()
        ts1, _, _ = r1.run(SEED, device=DEV)
        t_run = time.perf_counter() - t0
        saved = r1.buffer.state_dict()
        sidecar = Path(ckpt) / f"replay_{n0:08d}.npz"
        _, r2 = r2d1_recurrent.make_runner(n0, **kw)
        t0 = time.perf_counter()
        ts2, _, _ = r2.run(SEED + 9, restore=True, device=DEV)
        t_restore = time.perf_counter() - t0
        back = r2.buffer.state_dict()
        same_buf = sorted(back) == sorted(saved) and all(
            np.array_equal(back[k], saved[k]) for k in saved)
        same_ts = all(torch.equal(a, b) and a.device.type == "cuda"
                      for a, b in zip(pytree.tree_leaves(ts2),
                                      pytree.tree_leaves(ts1))
                      if torch.is_tensor(b)) and ts2.step == ts1.step
        _, r3 = r2d1_recurrent.make_runner(n1, **kw)
        r3.run(SEED + 9, restore=True, device=DEV)
        grew = r3.buffer.filled - r1.buffer.filled
        print(f"  R2D1 checkpoint: run of {n0} iterations {t_run:.2f} s; "
              f"sidecar {sidecar.stat().st_size / 1e6:.1f} MB; restore "
              f"{t_restore:.3f} s, buffer bit for bit: {same_buf}, train "
              f"state bit for bit on the card: {same_ts}, resumed at "
              f"iteration {r2._iters_done}; a run to {n1} appended {grew} "
              f"steps and ended at iteration {r3._iters_done}")
        if not (same_buf and same_ts and r2._iters_done == n0 and
                r3._iters_done == n1 and grew == (n1 - n0) * 8):
            fail("r2d1 checkpoint: not restored bit for bit or not resumed "
                 "at the saved iteration")


def async_phase(log_dir):
    t_phase = time.perf_counter()
    run_dir = Path(log_dir) / "async_sac"
    print(f"slice phase: async SAC on Pendulum (the mujoco_style_sac twin: "
          f"hidden 64, 8 envs x 32, host UniformReplayBuffer 8192 x 8 with "
          f"next obs, batch 128, replay ratio 8, warm-up 1024, "
          f"{ASYNC['sac_iters']} iterations, threaded)")
    zero_kernel_counters()
    _, runner, init = mujoco_style_sac.make_runner(
        ASYNC["sac_iters"], logger=Logger(str(run_dir), sinks=("jsonl",)))
    params = init(torch.Generator(device=DEV).manual_seed(SEED))
    t0 = time.perf_counter()
    ts, _, info = runner.run(SEED, params=params, device=DEV)
    wall = time.perf_counter() - t0
    launched = kernel_launches()
    rows = finite_rows(run_dir / "progress.jsonl", "async sac")
    st = runner.stats
    stats_finite("async sac", st)
    stale_max = max(r["param_staleness_max"] for r in rows) if rows else 0.0
    print(f"  {wall:.2f} s; samples_per_sec {st['samples_per_sec']:.1f}, "
          f"overlap_frac {st['overlap_frac']:.3f}, updates {st['updates']}, "
          f"replay_ratio_actual {st['replay_ratio_actual']:.3f}, "
          f"publish_version {st['publish_version']}; {len(rows)} rows, "
          f"staleness mean {rows[-1]['param_staleness_mean']:.2f} (last "
          f"window), max {stale_max:.0f} (all windows); last row loss "
          f"{rows[-1]['loss']:.4f}, avg_return {rows[-1]['avg_return']:.2f}"
          f", alpha {rows[-1]['alpha']:.4f}; kernel launches {launched}")
    print(f"  per thread: a collect {st['collect_ms']:.3f} ms, an update "
          f"{st['update_ms']:.3f} ms of busy time; actor put wait "
          f"{st['actor_put_wait_s']:.3f} s, learner idle "
          f"{st['learner_idle_s']:.3f} s")
    if not rows or st["updates"] <= 0 or \
            st["replay_ratio_actual"] > 8.0 + 1e-9 or \
            st["publish_version"] != st["updates"] // runner.publish_interval \
            or any(launched.values()) or not math.isfinite(float(info.loss)) \
            or not params_finite(ts):
        fail(f"async sac: stats {st}, launches {launched}")

    # unprofiled wall time of the async learner's update (host replay sample
    # -> card -> SAC update -> priorities) for the profile phase
    gen = torch.Generator(device=DEV).manual_seed(SEED + 3)

    def update(k=ASYNC["profile_updates"]):
        for _ in range(k):
            runner.update_once(gen)
        torch.cuda.synchronize()

    update(3)
    t0 = time.perf_counter()
    update()
    up_wall = (time.perf_counter() - t0) * 1e3 / ASYNC["profile_updates"]
    print(f"  one async SAC learner update (host sample of 128, upload, "
          f"update, priorities): {up_wall:.3f} ms unprofiled")

    n = ASYNC["sac_lockstep_iters"]
    # a second runner: ``update`` above keeps the threaded one
    _, lockstep, init = mujoco_style_sac.make_runner(
        n, threaded=False, logger=Logger(sinks=()))
    lockstep.run(SEED, params=init(torch.Generator(device=DEV).manual_seed(
        SEED)), device=DEV)
    lst = lockstep.stats
    stats_finite("async sac lockstep", lst)
    print(f"  the same twin in lockstep ({n} iterations, one thread): a "
          f"collect {lst['collect_ms']:.3f} ms, an update "
          f"{lst['update_ms']:.3f} ms of busy time ({lst['updates']} "
          f"updates); threaded over lockstep: "
          f"{st['collect_ms'] / lst['collect_ms']:.2f}x a collect, "
          f"{st['update_ms'] / lst['update_ms']:.2f}x an update")
    if lst["updates"] <= 0:
        fail(f"async sac lockstep: stats {lst}")

    print("slice phase: async A2C on CartPole at staleness 0")
    async_a2c_identity()
    print("slice phase: an R2D1 checkpoint with its replay sidecar on the "
          "card")
    r2d1_checkpoint()
    print(f"  phase {time.perf_counter() - t_phase:.1f} s")
    return (update, up_wall)


# ---------------------------------------------------------------------------
# phase 11b: the data-parallel mesh, two gloo ranks on the one card
# ---------------------------------------------------------------------------
def mesh_a2c(mesh, n_iters, compress=None, sentinels=False):
    """A2C on CartPole through ``ShardedSampler(8 envs x 16)``: on a rank
    through ``TrainLoop(mesh=...)``, in one process (a mesh without a group)
    through the plain TrainLoop on the same global batch; ``fuse=False``.
    Returns the params, each iteration's loss and wall, the sentinels' row
    and the EF residual's leaf shapes."""
    from repro_torch.core.tree import tree_concat
    from repro_torch.telemetry.sentinels import summarize
    from repro_torch.train.optim import CrossReplicaState
    dev = mesh.device
    model = make_pg_mlp(4, 2)
    agent = make_categorical_pg_agent(model)
    algo = A2C(model.apply, optim.adam(1e-3), distribution=Categorical(2))
    sampler = ShardedSampler(make_env("cartpole"), agent, n_envs=8,
                             horizon=16, mesh=mesh)
    loop = TrainLoop(sampler, algo, mesh=mesh if mesh.distributed else None,
                     compress=compress, sentinels=sentinels, fuse=False)
    ts = loop.algo.init_train_state(None, agent.init_params(
        torch.Generator(device=dev).manual_seed(SEED)))
    ss = sampler.init(torch.Generator(device=dev).manual_seed(SEED + 1))
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    losses, walls, sents = [], [], []
    for _ in range(n_iters):
        t0 = time.perf_counter()
        ts, ss, _, info, sent = loop.run_window(ts, ss, None, gen, 1)
        losses.append(float(info.loss))   # reads the card: the wall ends here
        walls.append((time.perf_counter() - t0) * 1e3)
        sents.append(sent)
    out = {"params": [p.cpu().numpy() for p in pytree.tree_leaves(
        ts.params)], "losses": losses, "walls": walls, "step": ts.step,
        "row": summarize(tree_concat(sents)) if sentinels else None,
        "residual": None}
    if isinstance(ts.opt_state, CrossReplicaState):
        out["residual"] = [tuple(r.shape) for r in ts.opt_state.ef.residual]
    return out, ts


def mesh_dqn_runner(mesh, variant, n_iterations, updates, ckpt_dir=None,
                    fuse=False):
    """The catch_dqn_variants example's ``variant`` at its settings (16 envs
    x horizon 16, replay 8192, batch 64, epsilon 0.2, Adam 5e-4, target copy
    every 100 updates) through ``OffPolicyRunner(mesh=...)``: 16 envs, a
    ring of 8192 and 64 samples an update over the ranks; ``fuse`` as
    given (gloo ranks sharing a card run unfused)."""
    from repro_torch.agents import make_dqn_agent
    from repro_torch.algos import DQN
    from repro_torch.models.rl_models import make_q_conv
    v = catch_dqn.VARIANTS[variant]
    model = make_q_conv(1, 3, img_hw=(10, 5), channels=(16, 32),
                        kernels=(3, 3), strides=(1, 1), d_out=128,
                        dueling=v["dueling"], n_atoms=v["n_atoms"])
    agent = make_dqn_agent(model, 3, n_atoms=v["n_atoms"], v_min=-1, v_max=1)
    algo = DQN(model.apply, optim.adam(5e-4), gamma=0.99, double=v["double"],
               n_atoms=v["n_atoms"], v_min=-1, v_max=1,
               target_update_interval=100)
    sampler = ShardedSampler(make_env("catch"), agent,
                             n_envs=catch_dqn.N_ENVS, horizon=16, mesh=mesh)
    return sampler, OffPolicyRunner(
        sampler, algo, replay_capacity=8192, batch_size=64,
        n_iterations=n_iterations, updates_per_collect=updates,
        min_replay=512, prioritized=v["prioritized"],
        log_interval=n_iterations, logger=Logger(sinks=()),
        agent_state_kwargs={"epsilon": 0.2}, mesh=mesh, fuse=fuse,
        ckpt_dir=ckpt_dir, ckpt_interval=n_iterations if ckpt_dir else 0)


def mesh_greedy(sampler, params, ss, collects=4):
    """Greedy (epsilon 0) trajectory stats of ``collects`` collects on every
    rank, summed over the ranks."""
    n = sampler.n_envs // sampler.n_shards
    ss = sampler.reset_stats(ss)._replace(agent_state={
        "epsilon": torch.zeros(n, device=ss.obs.device)})
    for _ in range(collects):
        ss, _ = sampler.local_collect(params, ss)
    return {k: float(x) for k, x in sampler.traj_stats(ss).items()}


def mesh_rank(mesh, ckpt_dir):
    """One rank of the mesh phase; returns what the parent checks."""
    torch.cuda.set_device(mesh.device)
    out = {"device": str(mesh.device)}
    # gloo on CUDA tensors: each collective the mesh uses, exactly
    g = torch.Generator(device=mesh.device).manual_seed(SEED + mesh.index)
    x = torch.randn(3, 5, generator=g, device=mesh.device)
    flag = torch.tensor([True, mesh.index == 1], device=mesh.device)
    out["collectives"] = {
        "psum": mesh.psum(x).cpu(), "pmax": mesh.pmax(x).cpu(),
        "psum_i32": mesh.psum(torch.full((2,), 3 + mesh.index,
                                         dtype=torch.int32,
                                         device=mesh.device)).cpu(),
        "gather": mesh.all_gather(x, dim=1).cpu(),
        "gather_bool": mesh.all_gather(flag).cpu(), "x": x.cpu()}
    a2c, ts = mesh_a2c(mesh, MESH["a2c_iters"])
    out["a2c"] = a2c
    # the host time of the gradient all-reduce at the A2C model's shapes
    grads = [torch.randn_like(p) for p in pytree.tree_leaves(ts.params)]
    for _ in range(3):
        mesh.pmean_all(grads)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MESH["allreduce_calls"]):
        mesh.pmean_all(grads)
    torch.cuda.synchronize()
    out["allreduce_ms"] = (time.perf_counter() - t0) * 1e3 / \
        MESH["allreduce_calls"]
    out["allreduce_bytes"] = sum(t.numel() * 4 for t in grads)
    out["a2c_int8"], _ = mesh_a2c(mesh, MESH["compress_iters"], "int8_ef",
                                  sentinels=True)

    # (c) prioritized DQN on Catch (the rainbow example), checkpointed
    st_ops.tree_sample_blocked.launches = 0
    n = MESH["dqn_iters"]
    sampler, runner = mesh_dqn_runner(mesh, "rainbow", n, 2, ckpt_dir)
    t0 = time.perf_counter()
    ts, ss, info = runner.run(SEED, device=mesh.device)
    torch.cuda.synchronize()
    out["dqn_wall_s"] = time.perf_counter() - t0
    out["dqn_launches"] = st_ops.tree_sample_blocked.launches
    rs = runner.replay_state
    out["dqn"] = {"step": ts.step, "loss": float(info.loss),
                  "grad_norm": float(info.grad_norm),
                  "td_abs": tuple(info.extra["td_abs"].shape),
                  "filled": int(rs.filled),
                  "params": [p.cpu().numpy()
                             for p in pytree.tree_leaves(ts.params)],
                  "storage": {k: v.cpu().numpy()
                              for k, v in rs.storage.items()},
                  "tree": rs.tree.cpu().numpy()}
    # the kernel on this rank's own tree at the path's shape, against the
    # plain version on the same stratified positions (the run's launches
    # are counted above)
    tree = runner.replay.local_view(rs).tree
    leaves, bsums = st_split(tree)
    u = st_positions(leaves.reshape(-1), float(tree[1]), 64 // mesh.size,
                     False, g)
    idx, prob = st_ops.tree_sample_blocked(tree, u)
    pidx, pprob = sample_plain(leaves, bsums, u)
    out["own_tree"] = {"idx": idx.cpu(), "prob": prob.cpu(),
                       "pidx": pidx.cpu(), "pprob": pprob.cpu(),
                       "leaves": leaves.cpu(), "bsums": bsums.cpu(),
                       "u": u.cpu()}
    # (d) this rank's restore of the checkpoint, bit for bit
    like = (ts, rs)
    (ts2, rs2), manifest = restore_checkpoint(
        ckpt_dir, like, shardings=runner.loop.checkpoint_specs(like))
    a = pytree.tree_leaves((ts.params, ts.opt_state, ts.extra, rs))
    b = pytree.tree_leaves((ts2.params, ts2.opt_state, ts2.extra, rs2))
    out["restore_equal"] = len(a) == len(b) and all(
        torch.equal(u, v) if isinstance(u, torch.Tensor) else u == v
        for u, v in zip(a, b))
    out["manifest_mesh"] = manifest["mesh_shape"]

    # the Catch bar on the mesh (tests/test_learning.py's configuration)
    st_ops.tree_sample_blocked.launches = 0
    sampler, runner = mesh_dqn_runner(mesh, "dueling", MESH["bar_iters"],
                                      MESH["bar_updates"])
    t0 = time.perf_counter()
    ts, ss, info = runner.run(SEED, device=mesh.device)
    out["bar"] = mesh_greedy(sampler, ts.params, ss)
    torch.cuda.synchronize()
    out["bar_wall_s"] = time.perf_counter() - t0
    out["bar_launches"] = st_ops.tree_sample_blocked.launches
    out["bar_loss"] = float(info.loss)
    return out


def mesh_phase():
    """Two gloo ranks on cuda:0 (launch.mesh.spawn_ranks): (a) A2C against
    the one-process loop on the same global batch at JAX's bounds, (b) the
    int8 error-feedback run and its sentinels, (c) prioritized DQN on Catch
    through OffPolicyRunner(mesh=) with the sum-tree kernel on each rank,
    and the Catch bar, (d) its checkpoint restored on 2 ranks and whole in
    one process, bit for bit.  Returns the sum-tree launches of (c)."""
    t_phase = time.perf_counter()
    n = MESH["ranks"]
    print(f"slice phase: the data-parallel mesh ({n} gloo ranks on "
          f"{DEV}; A2C {MESH['a2c_iters']} iterations, int8_ef "
          f"{MESH['compress_iters']}, rainbow {MESH['dqn_iters']}, the "
          f"Catch bar {MESH['bar_iters']} x {MESH['bar_updates']})")
    with tempfile.TemporaryDirectory() as d:
        ckpt = str(Path(d) / "mesh_dqn")
        t0 = time.perf_counter()
        # a rank's exception, death or deadline raises here (RuntimeError
        # with the rank's traceback), which ends the script non-zero
        ranks = spawn_ranks(mesh_rank, n, (ckpt,), device="cuda",
                            timeout=MESH["timeout"])
        spawn_wall = time.perf_counter() - t0
        # (d) on one process: the global leaves whole
        sampler, runner = mesh_dqn_runner(make_data_mesh(n, device="cuda"),
                                          "rainbow", 1, 2)
        ex = transition_example(sampler.env, device=DEV)
        ts = runner.loop.algo.init_train_state(
            None, sampler.agent.init_params(torch.Generator(device=DEV)))
        (ts_whole, rs_whole), manifest = restore_checkpoint(
            ckpt, (ts, runner.replay.init_sharded(ex, n)))
    ref, _ = mesh_a2c(make_data_mesh(n, device="cuda"), MESH["a2c_iters"])
    print(f"  {n} ranks spawned and joined in {spawn_wall:.1f} s; devices "
          f"{[r['device'] for r in ranks]}")

    # gloo on CUDA tensors
    xs = [r["collectives"]["x"] for r in ranks]
    for r in ranks:
        c = r["collectives"]
        ok = (torch.equal(c["psum"], xs[0] + xs[1])
              and torch.equal(c["pmax"], torch.maximum(xs[0], xs[1]))
              and torch.equal(c["psum_i32"], torch.tensor([7, 7],
                                                          dtype=torch.int32))
              and torch.equal(c["gather"], torch.cat(xs, dim=1))
              and torch.equal(c["gather_bool"],
                              torch.tensor([True, False, True, True])))
        if not ok:
            fail(f"gloo on CUDA tensors: {c}")
    print("  gloo on CUDA tensors: all_reduce SUM (f32, i32), MAX and the "
          "byte all_gather (f32, bool) exact on both ranks")

    # (a) the A2C identity
    atol, rtol = MESH_A2C_TOL["params"]
    worst_p, worst_l = 0.0, 0.0
    for r in ranks:
        a = r["a2c"]
        if a["step"] != MESH["a2c_iters"]:
            fail(f"mesh a2c: step {a['step']}")
        for x, y in zip(ref["params"], a["params"]):
            if not np.allclose(y, x, atol=atol, rtol=rtol):
                fail(f"mesh a2c: params differ by "
                     f"{np.abs(x - y).max()} from the global-batch loop")
            worst_p = max(worst_p, float(np.abs(x - y).max()))
        dl = np.abs(np.asarray(a["losses"]) - np.asarray(ref["losses"]))
        if not np.all(dl <= MESH_A2C_TOL["loss"] * (
                1 + np.abs(np.asarray(ref["losses"])))):
            fail(f"mesh a2c: losses differ by {dl.max()}")
        worst_l = max(worst_l, float(dl.max()))
    print(f"  (a) A2C on {n} ranks vs the one-process loop on the global "
          f"batch, {MESH['a2c_iters']} iterations: params within "
          f"{worst_p:.3g} (bound atol {atol} + rtol {rtol}), losses within "
          f"{worst_l:.3g} (bound {MESH_A2C_TOL['loss']})")

    # (b) int8 error feedback
    for r in ranks:
        b = r["a2c_int8"]
        row = b["row"]
        if not (b["step"] == MESH["compress_iters"]
                and all(np.isfinite(p).all() for p in b["params"])
                and row["sent_compress_err_norm"] > 0
                and row["sent_grad_norm_shard_max"] > 0
                and row["sent_nonfinite_params"] == 0
                and all(s[0] == 1 for s in b["residual"])):
            fail(f"mesh int8_ef: {row}, residual {b['residual']}")
    row = ranks[0]["a2c_int8"]["row"]
    print(f"  (b) int8_ef: sent_compress_err_norm "
          f"{row['sent_compress_err_norm']:.4g}, sent_grad_norm_shard_max "
          f"{row['sent_grad_norm_shard_max']:.4g}, nonfinite params 0, one "
          f"residual slice a rank ({len(ranks[0]['a2c_int8']['residual'])} "
          "leaves)")

    # (c) prioritized DQN with the sum-tree kernel on each rank
    want = 2 * MESH["dqn_iters"]
    for r in ranks:
        q = r["dqn"]
        if (r["dqn_launches"] != want or q["step"] != want
                or q["td_abs"] != (64,) or not math.isfinite(q["loss"])):
            fail(f"mesh dqn: launches {r['dqn_launches']} (want {want}), "
                 f"step {q['step']}, td_abs {q['td_abs']}, loss {q['loss']}")
    for x, y in zip(ranks[0]["dqn"]["params"], ranks[1]["dqn"]["params"]):
        if not np.array_equal(x, y):
            fail("mesh dqn: the ranks' params differ (not replicated)")
    for i, r in enumerate(ranks):
        o = r["own_tree"]
        st_hold(f"(c) rank {i}'s own tree, {o['leaves'].shape[0]} blocks "
                f"of {o['leaves'].shape[1]} leaves, on the card", o["idx"],
                o["prob"], o["leaves"], o["bsums"], o["u"], False,
                plain=(o["pidx"], o["pprob"]))
    print(f"  (c) rainbow through OffPolicyRunner(mesh=): sum_tree_sample "
          f"launches {[r['dqn_launches'] for r in ranks]} (want {want} a "
          f"rank), td_abs gathered to (64,), params replicated, loss "
          f"{ranks[0]['dqn']['loss']:.4f}, ring filled "
          f"{ranks[0]['dqn']['filled']} a rank")
    bar = ranks[0]["bar"]
    print(f"      Catch bar (dueling + double + prioritized, "
          f"{MESH['bar_iters']} x {MESH['bar_updates']}): greedy {bar}, "
          f"loss {ranks[0]['bar_loss']:.4f}, sum_tree_sample launches "
          f"{[r['bar_launches'] for r in ranks]}")
    if not bar["avg_return"] > 0.0 or any(
            r["bar_launches"] != MESH["bar_iters"] * MESH["bar_updates"]
            for r in ranks):
        fail(f"mesh Catch bar: greedy {bar}")

    # (d) the checkpoint: on each rank (above) and whole in one process
    if not all(r["restore_equal"] for r in ranks) or \
            manifest["mesh_shape"] != [n]:
        fail("mesh checkpoint: a rank's restore differs")
    for k, v in rs_whole.storage.items():
        if not np.array_equal(v.cpu().numpy(), np.concatenate(
                [r["dqn"]["storage"][k] for r in ranks])):
            fail(f"mesh checkpoint: storage {k} restored whole differs")
    if not np.array_equal(rs_whole.tree.cpu().numpy(), np.concatenate(
            [r["dqn"]["tree"] for r in ranks])):
        fail("mesh checkpoint: the trees restored whole differ")
    for x, y in zip(ranks[0]["dqn"]["params"],
                    pytree.tree_leaves(ts_whole.params)):
        if not np.array_equal(x, y.cpu().numpy()):
            fail("mesh checkpoint: params restored whole differ")
    print(f"  (d) checkpoint saved on {n} ranks (mesh_shape "
          f"{manifest['mesh_shape']}): restored on each rank bit for bit, "
          "and whole in one process (rings end to end, trees stacked) bit "
          "for bit")

    card = smi()
    for i, r in enumerate(ranks):
        w = np.asarray(r["a2c"]["walls"][1:])
        print(f"  rank {i}: A2C iteration wall median {np.median(w):.3f} "
              f"ms (min {w.min():.3f}); gradient all-reduce "
              f"{r['allreduce_ms']:.3f} ms host time for "
              f"{r['allreduce_bytes']} B; rainbow {MESH['dqn_iters']} "
              f"iterations + warm-up {r['dqn_wall_s']:.2f} s; Catch bar "
              f"run {r['bar_wall_s']:.2f} s ({card})")
    w = np.asarray(ref["walls"][1:])
    print(f"  one process on the global batch: A2C iteration wall median "
          f"{np.median(w):.3f} ms ({card})")
    print(f"  phase {time.perf_counter() - t_phase:.1f} s")
    return {"mesh rainbow": sum(r["dqn_launches"] for r in ranks),
            "mesh Catch bar": sum(r["bar_launches"] for r in ranks)}


# ---------------------------------------------------------------------------
# phase 11c: the LM mesh's data axis (train --mesh 2x1 [--compress])
# ---------------------------------------------------------------------------
def lm_mesh_argv(name):
    """``train.main``'s arguments for run ``name`` of LM_MESH."""
    run = LM_MESH[name]
    argv = ["--arch", run["arch"], "--full", "--layers", str(run["layers"]),
            "--mesh", f"{LM_MESH['ranks']}x1", "--batch", str(run["batch"]),
            "--horizon", str(run["horizon"]), "--steps", str(run["steps"]),
            "--device", "cuda", "--seed", str(SEED)]
    return argv + (["--compress"] if run["compress"] else [])


def lm_fixed_batch(cfg, T, ranks):
    """A fixed LM-PPO batch of LM_MESH_FIXED rows x T from a numpy seed: a
    random trajectory's GAE, its advantages normalised over each rank's
    slice of rows (as each rank's ``build_batch`` does), rows in rank
    order."""
    B = LM_MESH_FIXED
    r = np.random.RandomState(SEED + 21)
    traj = {"reward": r.randn(T, B).astype(np.float32),
            "value": r.randn(T, B).astype(np.float32),
            "done": r.rand(T, B) < 0.05,
            "tokens": r.randint(0, cfg.vocab, (T, B)).astype(np.int32),
            "actions": r.randint(0, cfg.vocab, (T, B)).astype(np.int32),
            "logp": (-np.abs(r.randn(T, B))).astype(np.float32)}
    v_last = r.randn(B).astype(np.float32)
    k = B // ranks
    parts = [train.build_batch(
        {key: torch.from_numpy(np.ascontiguousarray(v[:, i * k:(i + 1) * k]))
         .to(DEV) for key, v in traj.items()},
        torch.from_numpy(v_last[i * k:(i + 1) * k]).to(DEV))
        for i in range(ranks)]
    return {key: torch.cat([p[key] for p in parts]) for key in parts[0]}


def rel_dist(a, b) -> float:
    """||a - b|| / ||b|| over lists of tensors (the whole gradient)."""
    num = sum(float(optim.sum_squares([x - y])) for x, y in zip(a, b))
    return math.sqrt(num / float(optim.sum_squares(b)))


def lm_mesh_model(cfg):
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params = bb.init_lm(cfg, device=DEV, generator=gen, dtype=torch.float32,
                        requires_grad=True)
    return params, jax_leaf_groups([n for n, _ in params.named_parameters()],
                                   cfg)


def lm_gradient(cfg, params, opt, batch, n_micro=1):
    """The gradient one update of ``opt`` (sgd(0): its momentum buffer is
    the gradient it applied) takes on ``batch``, and its metrics."""
    step = make_lm_ppo_train_step(cfg, opt, entropy_coeff=0.003,
                                  n_microbatches=n_micro)
    _, state, m = step(params, opt.init(params.parameters()), batch)
    inner = state.inner if isinstance(state, optim.CrossReplicaState) \
        else state
    return inner.mu, state, m


def lm_mesh_identity(mesh):
    """(c) one uncompressed update on the ranks (each on its rows of the
    fixed batch) against the whole batch in one process, on rank 0: the
    whole batch at once and in the ranks' two halves (n_microbatches 2,
    the mesh's sums); rounding alone is what the two single-process
    updates differ by (tools/train_route_spread.py's method)."""
    run = LM_MESH["gemma2"]
    cfg = dataclasses.replace(get_config(run["arch"]), n_layers=run["layers"])
    batch = lm_fixed_batch(cfg, run["horizon"], mesh.size)
    k = LM_MESH_FIXED // mesh.size
    mine = {key: v[mesh.index * k:(mesh.index + 1) * k]
            for key, v in batch.items()}
    params, _ = lm_mesh_model(cfg)
    g_mesh, _, m = lm_gradient(cfg, params,
                               optim.cross_replica(optim.sgd(0.0), mesh),
                               mine)
    out = {"loss_mesh": float(mesh.pmean(m["loss"]))}
    if mesh.index == 0:
        g1, _, m1 = lm_gradient(cfg, params, optim.sgd(0.0), batch)
        out["mesh_vs_whole"] = rel_dist(g_mesh, g1)
        g2, _, m2 = lm_gradient(cfg, params, optim.sgd(0.0), batch, 2)
        out.update(mesh_vs_halves=rel_dist(g_mesh, g2),
                   halves_vs_whole=rel_dist(g2, g1),
                   loss_whole=float(m1["loss"]), loss_halves=float(m2["loss"]))
        del g1, g2
    del g_mesh, params
    torch.cuda.empty_cache()
    mesh.barrier()
    return out


def lm_mesh_compressed(mesh):
    """(d) one int8_ef update on the fixed batch: the gradient it applies
    against the uncompressed pmean of the ranks' gradients, each element
    as a share of the mean over ranks of the scale each rank quantised its
    leaf's group with (``LM_MESH_EF_BOUND``); returns the worst share and
    the step's compression metrics."""
    run = LM_MESH["gemma2"]
    cfg = dataclasses.replace(get_config(run["arch"]), n_layers=run["layers"])
    batch = lm_fixed_batch(cfg, run["horizon"], mesh.size)
    k = LM_MESH_FIXED // mesh.size
    mine = {key: v[mesh.index * k:(mesh.index + 1) * k]
            for key, v in batch.items()}
    params, groups = lm_mesh_model(cfg)
    copt = optim.cross_replica(optim.sgd(0.0), mesh, compress="int8_ef",
                               ef_shards=mesh.size, scale_groups=groups)
    worst = [0.0]

    def update(grads, state, p):
        scales = mesh.pmean(torch.stack([torch.amax(torch.stack(
            [torch.amax(torch.abs(grads[i])) for i in g])) for g in groups])
            / 127.0)
        want = mesh.pmean_all(grads)  # before the update reduces grads
        p, state, gnorm = copt.update(grads, state, p)
        for gi, g in enumerate(groups):
            for i in g:
                err = torch.amax(torch.abs(state.inner.mu[i] - want[i]))
                worst[0] = max(worst[0], float(err / scales[gi]))
        del want
        return p, state, gnorm

    _, state, m = lm_gradient(cfg, params, optim.Optimizer(copt.init, update),
                              mine)
    out = {"worst_share": worst[0],
           "residual_shape": tuple(state.ef.residual[0].shape),
           **{key: float(m[key]) for key in ("compress_err_norm",
                                             "grad_norm_shard_max", "loss")}}
    del state, params
    torch.cuda.empty_cache()
    return out


def lm_mesh_rank(mesh, log_dir):
    """One rank of phase 11c: (a) and (b) through ``train.main`` on the
    group spawn_ranks initialized, their launches, peak memory and rows,
    then (c) and (d)."""
    torch.cuda.set_device(mesh.device)
    out = {"device": str(mesh.device)}
    for name in ("gemma2", "mamba2"):
        d = Path(log_dir) / name
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_kernel_counters()
        t0 = time.perf_counter()
        params = train.main(lm_mesh_argv(name) + ["--log-dir", str(d)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mine = d if mesh.index == 0 else d / f"rank_{mesh.index}"
        out[name] = {
            "wall": wall, "launches": kernel_launches(),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "finite": all(bool(torch.isfinite(p).all())
                          for p in params.parameters()),
            "rows": [json.loads(ln) for ln in
                     (mine / "progress.jsonl").read_text().splitlines()]}
        del params
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["identity"] = lm_mesh_identity(mesh)
    out["compressed"] = lm_mesh_compressed(mesh)
    out["checks_s"] = time.perf_counter() - t0
    return out


def lm_mesh_phase():
    """Phase 11c: two gloo ranks on cuda:0 train full-width gemma2-2b (4
    layers, --compress) and mamba2-1.3b (24 layers) through ``train.main
    --mesh 2x1``; then (c) the identity and (d) the compressed update on a
    fixed batch.  Returns the ranks' summed launches by counter: gemma2's
    and mamba2's."""
    t_phase = time.perf_counter()
    n = LM_MESH["ranks"]
    print(f"slice phase: the LM mesh's data axis ({n} gloo ranks on {DEV}: "
          + "; ".join(" ".join(lm_mesh_argv(k)) for k in ("gemma2",
                                                           "mamba2")) + ")")
    with tempfile.TemporaryDirectory() as d:
        ranks = spawn_ranks(lm_mesh_rank, n, (d,), device="cuda",
                            timeout=LM_MESH["timeout"],
                            collective_timeout=LM_MESH["timeout"])
    card = smi()
    total = {}
    for name in ("gemma2", "mamba2"):
        run = LM_MESH[name]
        cfg = dataclasses.replace(get_config(run["arch"]),
                                  n_layers=run["layers"])
        steps, T, sites = run["steps"], run["horizon"], attn_sites(cfg)
        want = {"flash_attention": 2 * sites * steps,
                "flash_attention_decode": sites * (T + 1) * steps,
                "ssd_scan": 2 * ssd_layers(cfg) * steps}
        keys = {"avg_reward", "loss", "entropy", "samples_per_sec",
                "rollout_s", "update_s", "allreduce_s"} | (
            {"compress_err_norm", "grad_norm_shard_max"} if run["compress"]
            else set())
        for i, r in enumerate(ranks):
            o = r[name]
            got = {k: o["launches"].get(k, 0) for k in want}
            if got != want:
                fail(f"LM mesh {name} rank {i}: launches {got}, expected "
                     f"{want} (forward + recompute an attention site and a "
                     "Mamba-2 layer an update, a decode an attention site a "
                     "rollout step)")
            rows = o["rows"]
            if [row["step"] for row in rows] != list(range(1, steps + 1)) \
                    or not o["finite"] or any(
                        not keys <= set(row) or not all(
                            math.isfinite(row[k]) for k in keys)
                        for row in rows):
                fail(f"LM mesh {name} rank {i}: rows {rows}, params finite "
                     f"{o['finite']}")
            if run["compress"] and not all(row["compress_err_norm"] > 0
                                           for row in rows):
                fail(f"LM mesh {name}: compress_err_norm {rows}")
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
            for row in rows:
                print(f"  {name} rank {i} step {row['step']}: rollout_s "
                      f"{row['rollout_s']:.3f}, update_s "
                      f"{row['update_s']:.3f} (gradient all-reduce host time "
                      f"{row['allreduce_s']:.3f}), samples_per_sec "
                      f"{row['samples_per_sec']:.1f}, loss {row['loss']:.5f}"
                      + (f", compress_err_norm {row['compress_err_norm']:.4g}"
                         f", grad_norm_shard_max "
                         f"{row['grad_norm_shard_max']:.4g}"
                         if run["compress"] else ""))
            print(f"  {name} rank {i} ({r['device']}): max_memory_allocated "
                  f"{o['peak_gib']:.2f} GiB, train.main {o['wall']:.1f} s, "
                  f"launches {got} ({card})")
        if name == "mamba2":
            total["mamba2 ssd_scan"] = total.pop("ssd_scan")
    c = ranks[0]["identity"]
    loss_tol = 2 * abs(c["loss_halves"] - c["loss_whole"]) + \
        1e-6 * abs(c["loss_whole"])
    grad_tol = max(2 * c["halves_vs_whole"], 1e-6)
    print(f"  (c) identity on the fixed batch ({LM_MESH_FIXED} rows): the "
          f"ranks' gradient {c['mesh_vs_whole']:.3e} of its norm from the "
          f"whole batch's in one process, {c['mesh_vs_halves']:.3e} from its "
          f"two halves' (n_microbatches 2); rounding alone (halves vs "
          f"whole) {c['halves_vs_whole']:.3e}: bound {grad_tol:.3e} (2x); "
          f"loss {c['loss_mesh']:.7f} vs {c['loss_whole']:.7f} (bound "
          f"{loss_tol:.3e})")
    if not (c["mesh_vs_whole"] <= grad_tol
            and c["mesh_vs_halves"] <= grad_tol
            and abs(c["loss_mesh"] - c["loss_whole"]) <= loss_tol):
        fail(f"LM mesh identity: {c}")
    for i, r in enumerate(ranks):
        q = r["compressed"]
        print(f"  (d) rank {i} int8_ef update: |applied - pmean| at most "
              f"{q['worst_share']!r} of the mean scale (bound "
              f"{LM_MESH_EF_BOUND!r}), "
              f"compress_err_norm {q['compress_err_norm']:.4g}, "
              f"grad_norm_shard_max {q['grad_norm_shard_max']:.4g}, residual "
              f"slice {q['residual_shape']}; checks (c)-(d) "
              f"{r['checks_s']:.1f} s")
        if not (q["worst_share"] <= LM_MESH_EF_BOUND
                and 0 < q["compress_err_norm"] < math.inf
                and q["residual_shape"][0] == 1):
            fail(f"LM mesh compressed update, rank {i}: {q}")
    print(f"  phase {time.perf_counter() - t_phase:.1f} s ({card})")
    return total


# ---------------------------------------------------------------------------
# phase 11d: the LM mesh's 'model' axis (train --mesh DxM, M > 1)
# ---------------------------------------------------------------------------
def lm_tp_cfg(name):
    run = LM_TP[name]
    return dataclasses.replace(get_config(run["arch"]),
                               n_layers=run["layers"])


def lm_tp_argv(name):
    """``train.main``'s arguments for run ``name`` of LM_TP."""
    run = LM_TP[name]
    d, m = run["mesh"]
    argv = ["--arch", run["arch"], "--full", "--layers", str(run["layers"]),
            "--mesh", f"{d}x{m}", "--batch", str(run["batch"]),
            "--horizon", str(run["horizon"]), "--steps", str(run["steps"]),
            "--device", "cuda", "--seed", str(SEED)]
    return argv + (["--compress"] if run["compress"] else [])


def tp_local_cfg(cfg, n_model):
    """``cfg`` as one rank of a model axis of ``n_model`` computes its
    attention: its query heads and the KV heads they read
    (``layers.kv_layout``), for the kernels line's instance names."""
    heads, _, kv = tl.kv_layout(cfg, n_model)
    return dataclasses.replace(cfg, name=f"{cfg.name} (1 of {n_model})",
                               n_heads=heads, n_kv_heads=kv)


def tp_mesh(name):
    d, m = LM_TP[name]["mesh"]
    return mesh_lib.install_2d(mesh_lib.make_2d_mesh(d, m, device="cuda"))


def tp_release():
    """Return this rank's freed blocks to the card (the ranks share it):
    collect the cycles a run leaves (its closures, its optimizer state)
    first."""
    gc.collect()
    torch.cuda.empty_cache()


def tp_replicated_equal(mesh, params, cfg) -> bool:
    """Every leaf the rules replicate is equal bit for bit on the ranks of
    this rank's model group."""
    split = shd.model_split(params, cfg, mesh.model)
    same = True
    for p, sharded in zip(params.parameters(), split.sharded):
        if not sharded:   # f32 master weights, compared as their bits
            rows = mesh.model.all_gather(
                p.detach().reshape(1, -1).view(torch.int32), dim=0)
            same &= bool((rows == rows[:1]).all())
    return same


def tp_same_actions(mesh, params, cfg) -> bool:
    """One eager rollout from a seeded generator on every rank: the actions
    equal bit for bit across this rank's model group."""
    env = make_token_lm(vocab=cfg.vocab, episode_len=LM_TP_ROLLOUT["horizon"],
                        device=DEV)
    rollout = train.make_lm_rollout(cfg, env, LM_TP_ROLLOUT["batch"],
                                    LM_TP_ROLLOUT["horizon"], device=DEV,
                                    graph=False)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 31 + mesh.data.index)
    traj, _ = rollout(params, gen)
    rows = mesh.model.all_gather(traj["actions"][None], dim=0)
    return bool((rows == rows[:1]).all())


def tp_update(name, sabotage=False):
    """The update on run ``name``'s mesh on a fixed batch (its rows split
    over the data axis, advantages normalised a data rank's slice), sgd(0)
    so that its momentum buffer is the gradient it applied.  Returns this
    rank's blocks of each pass's gradient, the passes' losses, the fixed
    batch and this rank's rows:
    - "bf16", on the kernels: split-use leaves summed over the model axis,
      then the data mean.  A ``--compress`` run's update is the int8_ef
      one, and the same pass holds it: the applied gradient against the
      f32 data mean of the summed gradients (the blocks "bf16" keeps),
      each element as a share of the mean over data ranks of the scale its
      group was quantised with (the amax over the logical leaf: maxed over
      the model axis).
    - "f32" on the first data rank's model group, on the plain versions
      in f32: the gradient of its own rows, split-use leaves summed (no
      data mean, so one process's gradient of the same rows is its
      reference); with ``sabotage``, "sabotaged", again with the split-use
      leaves left partial."""
    run = LM_TP[name]
    mesh = tp_mesh(name)
    try:
        data, model = mesh.data, mesh.model
        cfg = lm_tp_cfg(name)
        batch = lm_fixed_batch(cfg, run["horizon"], data.size)
        k = LM_TP_FIXED // data.size
        mine = {key: v[data.index * k:(data.index + 1) * k]
                for key, v in batch.items()}
        gen = torch.Generator(device=DEV).manual_seed(SEED)
        params = bb.init_lm(cfg, device=DEV, generator=gen,
                            dtype=torch.float32, requires_grad=True)
        split = shd.model_split(params, cfg)
        specs = shd.param_pspecs(params, cfg)
        names = list(split.names)
        groups = jax_leaf_groups(names, cfg)
        out = {"split_use": [n for n, s in zip(names, split.split_use) if s],
               "names": names, "specs": specs, "model": model,
               "data_index": data.index, "data_size": data.size}

        def compressed():
            copt = optim.cross_replica(
                optim.sgd(0.0), data, compress="int8_ef",
                ef_shards=data.size, scale_groups=groups, model=split)

            def update(grads, state, p):
                summed = split.sum_split_(grads)
                amax = model.pmax(torch.stack([torch.amax(torch.stack(
                    [torch.amax(torch.abs(summed[i])) for i in g]))
                    for g in groups]))
                scales = data.pmean(amax / 127.0)
                # the f32 data mean a leaf at a time, kept on the host:
                # four ranks' int8 state share the card
                want = [data.pmean(t).cpu() for t in summed]
                del summed
                p, state, gnorm = copt.update(grads, state, p)
                worst = 0.0
                for gi, g in enumerate(groups):
                    for i in g:
                        err = torch.amax(torch.abs(state.inner.mu[i]
                                                   - want[i].to(DEV)))
                        worst = max(worst, float(err / scales[gi]))
                out["compressed"] = {"worst_share": worst}
                out["bf16"] = want
                return p, state, gnorm

            return optim.Optimizer(copt.init, update)

        def run_step(c, opt, rows):
            step = make_lm_ppo_train_step(c, opt, entropy_coeff=0.003,
                                          param_pspecs=specs)
            _, state, m = step(params, opt.init(params.parameters()), rows)
            return state, m

        opt = compressed() if run["compress"] else \
            optim.cross_replica(optim.sgd(0.0), data, model=split)
        state, m = run_step(cfg, opt, mine)
        if run["compress"]:
            out["compressed"].update(
                {key: float(m[key]) for key in ("compress_err_norm",
                                                "grad_norm_shard_max")})
        else:
            out["bf16"] = state.mu
        out["loss_bf16"] = float(data.pmean(m["loss"]))
        del state
        if data.index == 0:
            passes = [("f32", split)]
            if sabotage:
                passes.append(("sabotaged", dataclasses.replace(
                    split, split_use=(False,) * len(names))))
            cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
            with registry.override("ref"):
                for key, sp in passes:
                    state, m = run_step(
                        cfg32, optim.cross_replica(optim.sgd(0.0), (),
                                                   model=sp), mine)
                    out[key], out[f"loss_{key}"] = state.mu, float(m["loss"])
                    del state
        del params
        tp_release()
        return out, batch, mine
    finally:
        mesh_lib.install_2d(None)


def tp_partial_dist(out, key, full):
    """This rank's share of ``||ranks' - full||^2`` and ``||full||^2``
    between pass ``key``'s blocks (``tp_update``) and the one-process
    gradient ``full``, over the whole gradient and over the split-use
    leaves: a sharded leaf's block against the same block of ``full``, a
    replicated leaf whole, weighted 1 / M (every model rank adds it).
    Summed over a model group's ranks they give the whole distance."""
    model, specs = out["model"], out["specs"]
    sums = [0.0, 0.0, 0.0, 0.0]
    for n, a, b in zip(out["names"], out.pop(key), full):
        sharded = bool(shd.model_dims(specs[n]))
        if sharded:
            b = shd.local_slice(n, b, specs[n], model)
        w = 1.0 if sharded else 1.0 / model.size
        d = w * float(optim.sum_squares([a.to(DEV) - b]))
        r = w * float(optim.sum_squares([b]))
        sums[0] += d
        sums[1] += r
        if n in out["split_use"]:
            sums[2] += d
            sums[3] += r
    return sums


def tp_identity(name, sabotage=False):
    """(c) of phase 11d: the M-rank update against one process's on the
    same fixed batch at the same depth.  Each rank of the first data
    rank's model group, one at a time (the ranks share the card), draws
    the whole model and computes one process's gradients, and returns its
    share of each distance (``tp_partial_dist``); the report sums the
    shares.  bf16 on the kernels: the ranks' partial products round
    otherwise than one process's whole ones, so the yardstick is how far
    rounding alone moves the one-process update (bf16 against f32, on
    model rank 0).  f32 on the plain versions: within LM_TP_F32_BOUND.
    The other ranks wait at the barriers."""
    tp, batch, mine = tp_update(name, sabotage)
    world = make_data_mesh(device="cuda")
    model = tp["model"]
    out = {"split_use": tp["split_use"], "compressed": tp.get("compressed"),
           "loss_bf16": tp["loss_bf16"]}
    cfg = lm_tp_cfg(name)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    if tp["data_index"]:
        del tp["bf16"]   # the first data rank's blocks are the same
    for turn in range(model.size):
        if tp["data_index"] == 0 and model.index == turn:
            params, _ = lm_mesh_model(cfg)
            g1, _, m1 = lm_gradient(cfg, params, optim.sgd(0.0), batch)
            out["bf16"] = tp_partial_dist(tp, "bf16", g1)
            with registry.override("ref"):
                g32, _, m32 = lm_gradient(cfg32, params, optim.sgd(0.0),
                                          batch)
                # the f32 passes' rows: the whole batch on one data rank
                g32m, _, mm = (g32, None, m32) if tp["data_size"] == 1 \
                    else lm_gradient(cfg32, params, optim.sgd(0.0), mine)
            for key in ("f32", "sabotaged"):
                if key in tp:
                    out[key] = tp_partial_dist(tp, key, g32m)
            out.update(loss_f32=tp["loss_f32"], loss_whole=float(m1["loss"]),
                       loss_whole_f32=float(m32["loss"]),
                       loss_mine_f32=float(mm["loss"]))
            if model.index == 0:
                split_idx = [tp["names"].index(n) for n in tp["split_use"]]
                out["precision"] = rel_dist(g1, g32)
                out["precision_split"] = rel_dist(
                    [g1[i] for i in split_idx],
                    [g32[i] for i in split_idx]) if split_idx else 0.0
            del g1, g32, g32m, params
        tp_release()
        world.barrier()
    del tp
    tp_release()
    return out


def lm_tp_rank(world, names, log_dir):
    """One rank of a phase-11d spawn: each run of ``names`` through
    ``train.main`` on the group spawn_ranks initialized (launches, peak
    memory, rows, finite parameters), the replicated leaves and the
    actions of its model group, then (c)'s checks of the checked runs."""
    torch.cuda.set_device(world.device)
    out = {"device": str(world.device)}
    for name in names:
        d = Path(log_dir) / name
        tp_release()
        torch.cuda.reset_peak_memory_stats()
        zero_kernel_counters()
        t0 = time.perf_counter()
        params = train.main(lm_tp_argv(name) + ["--log-dir", str(d)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_launches()
        mine = d if world.index == 0 else d / f"rank_{world.index}"
        cfg = lm_tp_cfg(name)
        mesh = tp_mesh(name)
        try:
            with torch.no_grad():
                replicated = tp_replicated_equal(mesh, params, cfg)
                actions = tp_same_actions(mesh, params, cfg)
        finally:
            mesh_lib.install_2d(None)
        out[name] = {
            "wall": wall, "launches": launches,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "finite": all(bool(torch.isfinite(p).all())
                          for p in params.parameters()),
            "replicated_equal": replicated, "same_actions": actions,
            "rows": [json.loads(ln) for ln in
                     (mine / "progress.jsonl").read_text().splitlines()]}
        del params
        tp_release()
    t0 = time.perf_counter()
    for name in names:
        if name in LM_TP_CHECKED:
            t1 = time.perf_counter()
            out[name]["identity"] = tp_identity(name, sabotage=name == "mamba2")
            out[name]["check_s"] = time.perf_counter() - t1
    out["checks_s"] = time.perf_counter() - t0
    return out


def lm_tp_phase():
    """Phase 11d: the 'model' axis on gloo ranks sharing cuda:0 (LM_TP):
    two ranks train (a) qwen2-moe-a2.7b and (b) mamba2-1.3b on 1 x 2 and
    granite-34b's (128, 24) ranks; four train (c) gemma2-2b on 2 x 2 with
    --compress and granite-34b's (128, 12) ranks; then (a)-(c)'s updates
    on the fixed batch against one process's (``tp_identity``).  Returns
    the ranks' launches: the bare entry points' (gemma2-2b's dh 256) and
    the instances' by name."""
    t_phase = time.perf_counter()
    tp_release()   # this process's cached blocks, before the ranks share
    print("slice phase: the LM mesh's 'model' axis (gloo ranks on "
          f"{DEV}, this process holding "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB: "
          + "; ".join(" ".join(lm_tp_argv(k)) for k in LM_TP
                      if k != "timeout") + ")")
    bare, inst, checks_s = {}, {}, []
    with tempfile.TemporaryDirectory() as d:
        for names in LM_TP_SPAWNS:
            n = math.prod(LM_TP[names[0]]["mesh"])
            ranks = spawn_ranks(lm_tp_rank, n, (names, d), device="cuda",
                                timeout=LM_TP["timeout"],
                                collective_timeout=LM_TP["timeout"])
            checks_s += [o["checks_s"] for o in ranks]
            for name in names:
                lm_tp_report(name, [o[name] for o in ranks], bare, inst)
    print(f"  checks {max(checks_s):.1f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s ({smi()})")
    return bare, inst


def lm_tp_report(name, ranks, bare, inst):
    """Hold and print run ``name``'s ranks' results (``lm_tp_rank``); add
    its launches into ``bare`` / ``inst``."""
    card = smi()
    run = LM_TP[name]
    cfg = lm_tp_cfg(name)
    d, m = run["mesh"]
    steps, T, sites = run["steps"], run["horizon"], attn_sites(cfg)
    want = {"flash_attention": 2 * sites * steps,
            "flash_attention_decode": sites * (T + 1) * steps,
            "ssd_scan": 2 * ssd_layers(cfg) * steps}
    keys = {"avg_reward", "loss", "entropy", "samples_per_sec",
            "rollout_s", "update_s", "allreduce_s", "tp_allreduce_s"} | (
        {"compress_err_norm", "grad_norm_shard_max"} if run["compress"]
        else set())
    peak = 0.0
    for i, o in enumerate(ranks):
        got = {k: o["launches"].get(k, 0) for k in want}
        if got != want:
            fail(f"LM model axis {name} rank {i}: launches {got}, "
                 f"expected {want}")
        rows = o["rows"]
        if [row["step"] for row in rows] != list(range(1, steps + 1)) \
                or not o["finite"] or any(
                    not keys <= set(row) or not all(
                        math.isfinite(row[k]) for k in keys)
                    for row in rows):
            fail(f"LM model axis {name} rank {i}: rows {rows}, params "
                 f"finite {o['finite']}")
        if not (o["replicated_equal"] and o["same_actions"]):
            fail(f"LM model axis {name} rank {i}: replicated leaves "
                 f"equal {o['replicated_equal']}, same actions "
                 f"{o['same_actions']}")
        peak += o["peak_gib"]
        if cfg.d_head == 256:   # gemma2-2b's: the bare entry points
            for k in ("flash_attention", "flash_attention_decode"):
                bare[k] = bare.get(k, 0) + got[k]
        else:
            add_by_instance(inst, tp_local_cfg(cfg, m), got)
        for row in rows:
            print(f"  {name} {d}x{m} rank {i} step {row['step']}: "
                  f"rollout_s {row['rollout_s']:.3f}, update_s "
                  f"{row['update_s']:.3f} (data all-reduce "
                  f"{row['allreduce_s']:.3f}), model-axis collectives "
                  f"{row['tp_allreduce_s']:.3f} s, samples_per_sec "
                  f"{row['samples_per_sec']:.1f}, loss {row['loss']:.5f}")
        print(f"  {name} rank {i} ({o['launches']}): "
              f"max_memory_allocated {o['peak_gib']:.2f} GiB, "
              f"train.main {o['wall']:.1f} s, replicated leaves equal, "
              f"same actions ({card})")
    print(f"  {name}: the ranks' peaks sum to {peak:.2f} GiB (limit "
          f"{PEAK_GIB})")
    if peak > PEAK_GIB:
        fail(f"LM model axis {name}: the ranks' peaks {peak:.2f} GiB > "
             f"{PEAK_GIB}")
    if name in LM_TP_CHECKED:
        print(f"  {name} checks {ranks[0]['check_s']:.1f} s")
        lm_tp_checks(name, [o["identity"] for o in ranks])


def lm_tp_checks(name, ids):
    """Hold run ``name``'s (c) and (d): its ranks' ``tp_identity``
    results, in rank order."""
    d, m = LM_TP[name]["mesh"]
    shares = [c for c in ids if "bf16" in c]
    c = dict(shares[0])

    def dist(key):
        """Pass ``key``'s distance from one process's, over the whole
        gradient and over the split-use leaves: the ranks' shares
        summed."""
        t = [sum(sh[key][j] for sh in shares) for j in range(4)]
        return math.sqrt(t[0] / t[1]), \
            math.sqrt(t[2] / t[3]) if t[3] else 0.0

    for key in ("bf16", "f32", "sabotaged"):
        if key in c:
            c[f"{key}_vs_whole"], c[f"{key}_split_vs_whole"] = dist(key)
    grad_tol = 2 * c["precision"] + 1e-6
    split_tol = 2 * c["precision_split"] + 1e-6
    loss_tol = 2 * abs(c["loss_whole_f32"] - c["loss_whole"]) + \
        1e-6 * abs(c["loss_whole"])
    f32_loss_tol = LM_TP_F32_LOSS * abs(c["loss_mine_f32"])
    print(f"  {name} update on the fixed batch ({LM_TP_FIXED} rows, bf16 on "
          f"the kernels): the {d}x{m} gradient {c['bf16_vs_whole']:.3e} of "
          f"its norm from one process's; rounding alone (one process in "
          f"bf16 against f32) {c['precision']:.3e}: bound "
          f"{grad_tol:.3e} (2x); split-use leaves ({len(c['split_use'])}) "
          f"{c['bf16_split_vs_whole']:.3e}, bound {split_tol:.3e}; loss "
          f"{c['loss_bf16']:.7f} vs {c['loss_whole']:.7f} (f32 "
          f"{c['loss_whole_f32']:.7f}; bound {loss_tol:.3e})")
    print(f"  {name} in f32 on the plain versions ({LM_TP_FIXED // d} rows, "
          f"the first data rank's): the gradient {c['f32_vs_whole']:.3e} of "
          f"its norm from one process's, split-use leaves "
          f"{c['f32_split_vs_whole']:.3e} (bound {LM_TP_F32_BOUND:.0e}); "
          f"loss {c['loss_f32']:.7f} vs {c['loss_mine_f32']:.7f} (bound "
          f"{f32_loss_tol:.3e})")
    if not (c["bf16_vs_whole"] <= grad_tol
            and c["bf16_split_vs_whole"] <= split_tol
            and abs(c["loss_bf16"] - c["loss_whole"]) <= loss_tol):
        fail(f"LM model axis {name}: not the one-process update: {c}")
    if not (c["f32_vs_whole"] <= LM_TP_F32_BOUND
            and c["f32_split_vs_whole"] <= LM_TP_F32_BOUND
            and abs(c["loss_f32"] - c["loss_mine_f32"]) <= f32_loss_tol):
        fail(f"LM model axis {name}: not the one-process update in f32: {c}")
    if "sabotaged_vs_whole" in c:
        caught = not (c["sabotaged_vs_whole"] <= LM_TP_F32_BOUND
                      and c["sabotaged_split_vs_whole"] <= LM_TP_F32_BOUND)
        print(f"  {name} sabotage (split-use leaves left partial, f32): "
              f"{c['sabotaged_vs_whole']:.3e} of the norm, split-use "
              f"{c['sabotaged_split_vs_whole']:.3e}: caught {caught}")
        if not caught:
            fail(f"LM model axis {name}: the sabotaged split passed")
    for i, o in enumerate(ids):
        q = o["compressed"]
        if q is None:
            continue
        print(f"  {name} rank {i} int8_ef update: |applied - pmean| at most "
              f"{q['worst_share']!r} of the mean scale (bound "
              f"{LM_MESH_EF_BOUND!r}), compress_err_norm "
              f"{q['compress_err_norm']:.4g}, grad_norm_shard_max "
              f"{q['grad_norm_shard_max']:.4g}")
        if not (q["worst_share"] <= LM_MESH_EF_BOUND
                and 0 < q["compress_err_norm"] < math.inf):
            fail(f"LM model axis {name} compressed update, rank {i}: {q}")


def lm_ppo_loss(params, cfg, batch):
    """The LM-PPO step's loss (``algos/pg/ppo.py``'s ``loss_fn``, entropy
    coefficient 0.003) and the per-token ``logp`` of the actions, with no
    gradient."""
    with torch.no_grad():
        hidden, aux = bb.forward_train(params, batch["tokens"], cfg)
        logits = bb.lm_logits(params, hidden, cfg).float()
        value = bb.value_out(params, hidden)
        logp_all = F.log_softmax(logits, dim=-1)
        logp = torch.gather(logp_all, -1,
                            batch["actions"].long()[..., None])[..., 0]
        ratio = torch.exp(logp - batch["logp_old"])
        adv = batch["advantage"]
        pi = -torch.mean(torch.minimum(ratio * adv,
                                       torch.clamp(ratio, 0.8, 1.2) * adv))
        v = 0.5 * torch.mean(torch.square(value - batch["return_"]))
        ent = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
        return float(pi + 0.5 * v - 0.003 * ent + 0.01 * aux), logp


def lm_tp4_run(world, name, log_dir):
    """One run of LM_TP4 on this rank through ``train.main``: its rows,
    launches, peak memory, finite parameters; returns them and the
    rank's LM."""
    run = LM_TP4[name]
    d, m = run["mesh"]
    argv = ["--arch", run["arch"], "--full", "--layers", str(run["layers"]),
            "--mesh", f"{d}x{m}", "--batch", str(run["batch"]),
            "--horizon", str(run["horizon"]), "--steps", str(run["steps"]),
            "--device", "cuda", "--seed", str(SEED),
            "--log-dir", str(Path(log_dir) / name)]
    tp_release()
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counters()
    t0 = time.perf_counter()
    params = train.main(argv + (["--compress"] if run["compress"] else []))
    torch.cuda.synchronize()
    mine = Path(log_dir) / name
    if world.index:
        mine = mine / f"rank_{world.index}"
    return params, {
        "wall": time.perf_counter() - t0, "launches": kernel_launches(),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "finite": all(bool(torch.isfinite(p).all())
                      for p in params.parameters()),
        "rows": [json.loads(ln) for ln in
                 (mine / "progress.jsonl").read_text().splitlines()]}


def lm_tp4_rank(world, log_dir):
    """A rank of the four-card proof: qwen2-moe-a2.7b at full width and
    depth on 1 x 4, then its fixed-batch loss and logp on the ranks
    against one card's forward of the same weights (gathered leaf by leaf
    into f32 on rank 0), in bf16 and, as rounding's yardstick, in f32
    with the plain kernels; then gemma2-2b on 2 x 2 --compress."""
    torch.cuda.set_device(world.device)
    out = {"device": str(world.device), "backend": world.backend}
    params, out["qwen2"] = lm_tp4_run(world, "qwen2", log_dir)
    run = LM_TP4["qwen2"]
    cfg = dataclasses.replace(get_config(run["arch"]), n_layers=run["layers"])
    batch = lm_fixed_batch(cfg, run["horizon"], 1)
    d, m = run["mesh"]
    mesh = mesh_lib.install_2d(mesh_lib.make_2d_mesh(d, m, device="cuda"))
    try:
        specs = shd.param_pspecs(params, cfg)
        loss_tp, logp_tp = lm_ppo_loss(params, cfg, batch)
        out["qwen2"]["loss_tp"] = loss_tp
        names = [n for n, _ in params.named_parameters()]
        locals_ = [p.detach().cpu() for p in params.parameters()]
        del params
        tp_release()
    finally:
        mesh_lib.install_2d(None)
    torch.cuda.reset_peak_memory_stats()
    full = bb.LM(cfg, device=DEV, dtype=torch.float32) \
        if world.index == 0 else None
    targets = dict(full.named_parameters()) if full is not None else {}
    with torch.no_grad():
        for n, t in zip(names, locals_):
            g = shd.gather_leaf(n, t.to(DEV), specs[n], mesh.model)
            if full is not None:
                targets[n].copy_(g)
            del g
    del locals_
    tp_release()
    if full is not None:
        loss_1, logp_1 = lm_ppo_loss(full, cfg, batch)
        f32 = dataclasses.replace(cfg, compute_dtype="float32")
        with registry.override("ref"):
            loss_f32, logp_ref = lm_ppo_loss(full, f32, batch)
        out["qwen2"].update(
            loss_one=loss_1, loss_f32=loss_f32,
            logp_tp_vs_one=float(torch.mean(torch.abs(logp_tp - logp_1))),
            logp_one_vs_f32=float(torch.mean(torch.abs(logp_1 - logp_ref))),
            logp_tp_vs_f32=float(torch.mean(torch.abs(logp_tp - logp_ref))),
            logp_max_tp_vs_one=float(torch.amax(torch.abs(logp_tp - logp_1))),
            one_card_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del full, targets, logp_1, logp_ref
    del logp_tp
    tp_release()
    make_data_mesh(device="cuda").barrier()
    params, out["gemma2"] = lm_tp4_run(world, "gemma2", log_dir)
    del params
    tp_release()
    return out


def lm_tp4_phase():
    """The four-card proof of the 'model' axis (``tools/chip_phases.py
    lm_tp4``): four NCCL ranks, a card each (LM_TP4).  Raises unless the
    machine has 4 cards."""
    n = torch.cuda.device_count()
    if n < 4:
        fail(f"lm_tp4 needs 4 CUDA devices, found {n}")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        ranks = spawn_ranks(lm_tp4_rank, 4, (d,), device="cuda",
                            timeout=LM_TP4["timeout"],
                            collective_timeout=LM_TP4["timeout"])
    card = "; ".join(smi().splitlines())
    print(f"four-card proof ({card}): ranks on "
          f"{[r['device'] for r in ranks]}, collectives "
          f"{ranks[0]['backend']}")
    for name, run in LM_TP4.items():
        if name == "timeout":
            continue
        cfg = dataclasses.replace(get_config(run["arch"]),
                                  n_layers=run["layers"])
        steps, T, sites = run["steps"], run["horizon"], attn_sites(cfg)
        want = {"flash_attention": 2 * sites * steps,
                "flash_attention_decode": sites * (T + 1) * steps}
        for i, r in enumerate(ranks):
            o = r[name]
            got = {k: o["launches"].get(k, 0) for k in want}
            rows = o["rows"]
            ok = got == want and o["finite"] and \
                [row["step"] for row in rows] == list(range(1, steps + 1))
            for row in rows:
                print(f"  {name} {run['mesh'][0]}x{run['mesh'][1]} rank {i} "
                      f"step {row['step']}: rollout_s {row['rollout_s']:.3f},"
                      f" update_s {row['update_s']:.3f} (data all-reduce "
                      f"{row['allreduce_s']:.3f}), model-axis collectives "
                      f"{row['tp_allreduce_s']:.3f} s, samples_per_sec "
                      f"{row['samples_per_sec']:.1f}, loss {row['loss']:.5f}")
            print(f"  {name} rank {i}: max_memory_allocated "
                  f"{o['peak_gib']:.2f} GiB, train.main {o['wall']:.1f} s, "
                  f"launches {got} ({card})")
            if not ok:
                fail(f"four-card {name} rank {i}: launches {got} (expected "
                     f"{want}), finite {o['finite']}, rows {rows}")
            if o["peak_gib"] > PEAK_GIB:
                fail(f"four-card {name} rank {i}: peak {o['peak_gib']:.2f} "
                     f"GiB > {PEAK_GIB}")
    q = ranks[0]["qwen2"]
    bound = 2 * q["logp_one_vs_f32"] + 1e-6
    loss_bound = 2 * abs(q["loss_one"] - q["loss_f32"]) + 1e-6
    print(f"  qwen2-moe-a2.7b fixed batch ({LM_TP_FIXED} x "
          f"{LM_TP4['qwen2']['horizon']}) after training: loss on the 4 "
          f"ranks {q['loss_tp']:.6f}, one card {q['loss_one']:.6f} (bf16), "
          f"{q['loss_f32']:.6f} (f32, plain kernels): |ranks - one| "
          f"{abs(q['loss_tp'] - q['loss_one']):.3e}, bound {loss_bound:.3e} "
          f"(2x bf16 vs f32); mean |logp ranks - one| "
          f"{q['logp_tp_vs_one']:.4e} (max {q['logp_max_tp_vs_one']:.4e}), "
          f"bf16 vs f32 {q['logp_one_vs_f32']:.4e}: bound {bound:.4e}; one "
          f"card's peak {q['one_card_peak_gib']:.2f} GiB")
    if not (q["logp_tp_vs_one"] <= bound
            and abs(q["loss_tp"] - q["loss_one"]) <= loss_bound):
        fail(f"four-card qwen2: the ranks' forward is not the one card's: "
             f"{q}")
    print(f"  phase {time.perf_counter() - t_phase:.1f} s ({card})")
    return ranks


# ---------------------------------------------------------------------------
# phase 11e: NCCL collectives captured in a CUDA graph, on the one card
# ---------------------------------------------------------------------------
def capture_body(mesh, n):
    """A step over NCCL collectives called directly (``DataMesh``'s send
    nothing on a world of one): the state ``x`` and this step's input
    ``inp`` through an all-reduce and an all-gather, each inside the
    mesh's event timing (``DataMesh._timed``)."""
    import torch.distributed as dist

    world = mesh.size

    def body(x, inp):
        a = torch.sin(x) * 1.5 + inp
        with mesh._timed(mesh.device):
            dist.all_reduce(a, group=mesh.group)
        g = torch.empty(world * n, device=mesh.device)
        with mesh._timed(mesh.device):
            dist.all_gather_into_tensor(g, a, group=mesh.group)
        y = g.view(world, n).sum(0) * 0.5 + a.square()
        return (y, inp), y.sum()

    return body


def capture_rank(mesh):
    """The rank of phase 11e: a world-1 NCCL group on the card.  Its body
    captured in a ``StepGraph`` and replayed CAPTURE["replays"] times on
    inputs that change between replays, each result against an eager call
    of the same body on the same inputs (the same communicator, eager
    between the replays); the captured collectives' event time; then a
    gloo group on the same card refusing the capture."""
    import torch.distributed as dist
    from repro_torch.core.graphs import StepGraph
    from repro_torch.launch.mesh import DataMesh

    torch.cuda.set_device(mesh.device)
    dev, n = mesh.device, CAPTURE["n"]
    out = {"backend": mesh.backend, "capturable": mesh.capturable,
           "device": str(dev)}
    body = capture_body(mesh, n)
    step = StepGraph(body, device=dev, name="nccl_capture")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(n, generator=gen, device=dev)
    mismatched, walls = [], {"graph": [], "eager": []}
    with mesh_lib.time_collectives() as acc:
        for i in range(CAPTURE["replays"] + 2):   # warm-up, capture, replays
            inp = torch.randn(n, generator=gen, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (want, _), want_sum = body(x.clone(), inp.clone())
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            (x, _), got_sum = step(x, inp)
            torch.cuda.synchronize()
            if i >= 2:
                walls["eager"].append((t1 - t0) * 1e3)
                walls["graph"].append((time.perf_counter() - t1) * 1e3)
            if not (torch.equal(x, want) and torch.equal(got_sum, want_sum)):
                mismatched.append(i)
            x = x.clone()   # the next input, not the graph's own state
        eager_pairs = len(acc.events)
        total = acc.seconds()
    out.update(replays=step.replays, mismatched=mismatched,
               captured_s=acc.replayed, eager_pairs=eager_pairs,
               total_s=total, walls={k: float(np.median(v))
                                     for k, v in walls.items()})
    # gloo on the same card: the refusal comes before anything is sent, so
    # a group of this one rank, claimed two ranks wide, shows it
    gloo = DataMesh(axis="gloo", size=2, index=0, device=dev,
                    devices=(dev, dev), group=dist.new_group(
                        backend="gloo"))
    refuse = StepGraph(lambda y: ((gloo.psum(y * 2.0),), None), device=dev,
                       name="gloo_capture")
    y = torch.ones(8, device=dev)
    refuse(y)   # the eager warm-up: gloo sends from the host
    try:
        refuse(y)
    except RuntimeError as e:
        out["refused"] = str(e)
    else:
        fail("gloo on the card: the CUDA graph's capture was not refused")
    out["gloo_capturable"] = gloo.capturable
    torch.cuda.synchronize()
    return out


def capture_phase():
    """Phase 11e (see the module docstring); returns its lines' numbers."""
    t_phase = time.perf_counter()
    print(f"slice phase: NCCL collectives in a CUDA graph (one rank, a "
          f"world-1 NCCL group on {DEV}; {CAPTURE['replays']} replays of "
          f"all_reduce + all_gather_into_tensor on {CAPTURE['n']} f32)")
    (r,) = spawn_ranks(capture_rank, 1, device="cuda",
                       timeout=CAPTURE["timeout"])
    card = smi()
    if r["backend"] != "nccl" or not r["capturable"]:
        fail(f"nccl capture: backend {r['backend']}, capturable "
             f"{r['capturable']}")
    if r["mismatched"] or r["replays"] != CAPTURE["replays"] + 1:
        fail(f"nccl capture: replays {r['replays']}, calls differing from "
             f"eager {r['mismatched'][:5]}")
    if not (math.isfinite(r["captured_s"]) and r["captured_s"] > 0):
        fail(f"nccl capture: the captured collectives' event time "
             f"{r['captured_s']}")
    msg = r["refused"]
    if r["gloo_capturable"] or "NCCL" not in msg or "gloo" not in msg:
        fail(f"gloo capture not refused: {msg}")
    w = r["walls"]
    print(f"  rank on {r['device']}, backend nccl, capturable: "
          f"{CAPTURE['replays'] + 1} replays (capture_error_mode "
          "thread_local) each equal to an eager call on the same inputs, "
          "bit for bit, with eager collectives on the same communicator "
          "between them")
    print(f"  the captured collectives' event time over the replays "
          f"{r['captured_s'] * 1e3:.3f} ms ({r['captured_s'] * 1e6 / (CAPTURE['replays'] + 1):.2f} "
          f"us a replay); eager event pairs {r['eager_pairs']}, all "
          f"{r['total_s'] * 1e3:.3f} ms ({card})")
    print(f"  a step's wall {w['eager']:.3f} ms eager, {w['graph']:.3f} ms "
          f"graph (median, synchronised; {card})")
    print(f"  gloo on the same card refused the capture: {msg[:110]}...")
    print(f"  phase {time.perf_counter() - t_phase:.1f} s")
    return r


# ---------------------------------------------------------------------------
# the fused mesh's four-card proof (tools/chip_phases.py mesh4)
# ---------------------------------------------------------------------------
def dev_sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def mesh4_a2c(mesh, n):
    """A2C on CartPole through ``ShardedSampler`` (MESH4's envs x 16) and
    ``OnPolicyRunner(mesh=)`` whose loop compresses (``int8_ef``) and
    keeps sentinels; (runner, None) for ``fused_identity``."""
    from repro_torch.runners import OnPolicyRunner
    model = make_pg_mlp(4, 2)
    agent = make_categorical_pg_agent(model)
    algo = A2C(model.apply, optim.adam(1e-3), distribution=Categorical(2))
    sampler = ShardedSampler(make_env("cartpole"), agent,
                             n_envs=MESH4["envs"], horizon=16, mesh=mesh)
    runner = OnPolicyRunner(sampler, algo, n_iterations=n, log_interval=n,
                            logger=Logger(sinks=()), mesh=mesh)
    runner.loop = TrainLoop(sampler, algo, mesh=mesh, compress="int8_ef",
                            sentinels=True)
    return runner, None


def mesh4_ppo(mesh, n):
    """PPO on CartPole at the quickstart's settings (Adam 7e-4, clip 0.5,
    4 epochs x 4 minibatches of a rank's batch, 16 envs x 64, sentinels)
    through ``OnPolicyRunner(mesh=)``."""
    from repro_torch.algos import PPO
    from repro_torch.runners import OnPolicyRunner
    model = make_pg_mlp(4, 2)
    agent = make_categorical_pg_agent(model)
    algo = PPO(model.apply, optim.adam(7e-4, grad_clip=0.5),
               distribution=Categorical(2), epochs=4, minibatches=4)
    sampler = ShardedSampler(make_env("cartpole"), agent, n_envs=16,
                             horizon=64, mesh=mesh)
    return OnPolicyRunner(sampler, algo, n_iterations=n, log_interval=n,
                          logger=Logger(sinks=()), mesh=mesh,
                          sentinels=True), None


def mesh4_walls(make, n, dev):
    """Median wall (ms) of one iteration, eager (``iteration``) and fused
    (``fused_iteration``, a graph replay), each after its runner's run and
    two iterations; synchronised."""
    out = {}
    for fuse in (False, True):
        runner, params = make()
        runner.loop.fuse = fuse
        ts, ss, _ = runner.run(SEED, params=params, device=dev)
        state = [ts, ss, getattr(runner, "replay_state", None),
                 torch.Generator(device=dev).manual_seed(SEED + 3)]
        step = runner.loop.fused_iteration if fuse else runner.loop.iteration
        walls = []
        for i in range(n + 2):
            dev_sync(dev)
            t0 = time.perf_counter()
            state[0], state[1], state[2], _, _ = step(*state)
            dev_sync(dev)
            if i >= 2:
                walls.append((time.perf_counter() - t0) * 1e3)
        out["graph" if fuse else "eager"] = float(np.median(walls))
    return out


def mesh4_restore(mesh, ckpt_dir, dev):
    """Rainbow through ``OffPolicyRunner(mesh=, fuse=True)`` to
    MESH4["restore_iters"][0], checkpointed there; then the same loop on
    to the second count from that state, and a new fused loop from the
    checkpoint's train and replay states (the sampler state and generator
    as the first had them: the checkpoint holds neither) to the same
    count.  True when the two end bit for bit alike."""
    first, more = MESH4["restore_iters"]
    _, runner = mesh_dqn_runner(mesh, "rainbow", first, 2, ckpt_dir,
                                fuse=True)
    ts, ss, _ = runner.run(SEED, device=dev)
    rs = runner.replay_state
    # the fused loop's sampler state lives in its graph's memory
    ss0 = pytree.tree_map(
        lambda x: torch.Generator(device=x.device).set_state(x.get_state())
        if isinstance(x, torch.Generator) else
        x.clone() if torch.is_tensor(x) else x, ss, is_leaf=graph_leaf)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    a = runner.loop.run_window(ts, ss, rs, gen, more)[:3]
    want = snapshot(a + (gen,))
    _, fresh = mesh_dqn_runner(mesh, "rainbow", first, 2, fuse=True)
    ex = transition_example(fresh.sampler.env, device=dev)
    like = (fresh.loop.algo.init_train_state(None, fresh.sampler.agent
                                             .init_params(torch.Generator(
                                                 device=dev))),
            fresh.replay.init_sharded(ex, mesh.size, index=mesh.index))
    (ts2, rs2), manifest = restore_checkpoint(
        ckpt_dir, like, shardings=fresh.loop.checkpoint_specs(like))
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    b = fresh.loop.run_window(ts2, ss0, rs2, gen, more)[:3]
    return {"equal": same_snapshot(want, snapshot(b + (gen,))),
            "iteration": manifest["extra"]["iteration"],
            "step": b[0].step}


def mesh4_rl(mesh, ckpt_dir):
    """(a) of the four-card proof on this rank."""
    dev = mesh.device
    out = {}
    # the conv backward of Catch's Q net adds in a fixed order only so
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, make, n in (
                ("a2c", lambda: mesh4_a2c(mesh, MESH4["a2c_iters"]),
                 MESH4["a2c_iters"]),
                ("ppo", lambda: mesh4_ppo(mesh, MESH4["ppo_iters"]),
                 MESH4["ppo_iters"]),
                ("rainbow", lambda: (mesh_dqn_runner(
                    mesh, "rainbow", MESH4["dqn_iters"], 2,
                    fuse=True)[1], None), MESH4["dqn_iters"])):
            launches = {}
            replays = fused_identity(f"rank {mesh.index} {name}", make, n,
                                     launches)
            out[name] = {"replays": replays, "launches": launches,
                         "walls": mesh4_walls(make, MESH4["wall_iters"],
                                              dev)}
        out["restore"] = mesh4_restore(mesh, ckpt_dir, dev)
        sampler, runner = mesh_dqn_runner(mesh, "dueling", MESH4["bar_iters"],
                                          MESH4["bar_updates"], fuse=True)
        zero_kernel_counters()
        t0 = time.perf_counter()
        ts, ss, info = runner.run(SEED, device=dev)
        out["bar"] = mesh_greedy(sampler, ts.params, ss)
        dev_sync(dev)
        out["bar_wall_s"] = time.perf_counter() - t0
        out["bar_launches"] = kernel_launches()
        out["bar_replays"] = sum(g.replays for g in runner.loop.graphs.values())
    finally:
        torch.backends.cudnn.deterministic = was
    return out


def mesh4_lm_run(world, name, log_dir):
    """One LM run of MESH4 on this rank through ``train.main`` (its rows,
    launches, peak memory), then two rollouts of the trained LM from one
    seed on the same ranks, the step replayed from a CUDA graph and
    eager: their trajectories, walls, model-axis collectives' time and
    launches."""
    run = MESH4["lm"][name]
    d, m = run["mesh"]
    dev = world.device
    argv = ["--arch", run["arch"], "--full", "--layers", str(run["layers"]),
            "--mesh", f"{d}x{m}", "--batch", str(run["batch"]),
            "--horizon", str(run["horizon"]), "--steps", str(run["steps"]),
            "--device", dev.type, "--seed", str(SEED),
            "--log-dir", str(Path(log_dir) / name)]
    tp_release()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    zero_kernel_counters()
    t0 = time.perf_counter()
    params = train.main(argv + (["--compress"] if run["compress"] else []))
    dev_sync(dev)
    mine = Path(log_dir) / name
    if world.index:
        mine = mine / f"rank_{world.index}"
    out = {"wall": time.perf_counter() - t0, "launches": kernel_launches(),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda
           else 0.0,
           "finite": all(bool(torch.isfinite(p).all())
                         for p in params.parameters()),
           "rows": [json.loads(ln) for ln in
                    (mine / "progress.jsonl").read_text().splitlines()]}
    cfg = dataclasses.replace(get_config(run["arch"]), n_layers=run["layers"])
    mesh = mesh_lib.install_2d(mesh_lib.make_2d_mesh(d, m, device=dev.type))
    rolls = {}
    try:
        env = make_token_lm(vocab=cfg.vocab, episode_len=run["horizon"],
                            device=dev)
        for graph in (True, False):
            rollout = train.make_lm_rollout(cfg, env, run["batch"] // d,
                                            run["horizon"], device=dev,
                                            graph=graph)
            gen = torch.Generator(device=dev).manual_seed(
                fold_seed(SEED + 11, mesh.data.index))
            zero_kernel_counters()
            dev_sync(dev)
            t0 = time.perf_counter()
            with mesh_lib.time_collectives(mesh.model.axis) as wire:
                traj, v_last = rollout(params, gen)
                dev_sync(dev)
            rolls[graph] = {
                "wall": time.perf_counter() - t0, "tp_s": wire.seconds(),
                "launches": kernel_launches(),
                "snap": [traj[k].clone() for k in ("tokens", "actions",
                                                   "logp", "value")]
                + [v_last.clone()]}
            del rollout, traj, v_last
            tp_release()
    finally:
        mesh_lib.install_2d(None)
    a, b = rolls[True].pop("snap"), rolls[False].pop("snap")
    out["rollout_equal"] = all(torch.equal(x, y) for x, y in zip(a, b))
    out["rollout_diff"] = [float((x.double() - y.double()).abs().max())
                           for x, y in zip(a, b)]
    out["rollouts"] = rolls
    del params, a, b
    tp_release()
    return out


def mesh4_rank(world, log_dir):
    """One rank of the four-card proof: (a) RL fused against unfused, the
    restore, the Catch bar; (b) the LM runs of MESH4."""
    if world.device.type == "cuda":
        torch.cuda.set_device(world.device)
    out = {"device": str(world.device), "backend": world.backend,
           "capturable": world.capturable}
    out["rl"] = mesh4_rl(world, str(Path(log_dir) / "rl_ckpt"))
    for name in MESH4["lm"]:
        out[name] = mesh4_lm_run(world, name, log_dir)
        make_data_mesh(device=world.device.type).barrier()
    return out


def mesh4_phase(device="cuda"):
    """The four-card proof of the fused mesh (``tools/chip_phases.py
    mesh4``): four NCCL ranks, a card each (MESH4).  Raises unless the
    machine has 4 cards."""
    n = torch.cuda.device_count() if device == "cuda" else 4
    if n < 4:
        fail(f"mesh4 needs 4 CUDA devices, found {n}")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        ranks = spawn_ranks(mesh4_rank, 4, (d,), device=device,
                            timeout=MESH4["timeout"],
                            collective_timeout=MESH4["collective_timeout"])
    card = "; ".join(smi().splitlines()) if device == "cuda" else "the CPU"
    print(f"fused mesh, four-card proof ({card}): ranks on "
          f"{[r['device'] for r in ranks]}, collectives "
          f"{ranks[0]['backend']}, capturable {ranks[0]['capturable']}")
    bad = []
    for i, r in enumerate(ranks):
        rl = r["rl"]
        for name in ("a2c", "ppo", "rainbow"):
            o = rl[name]
            w = o["walls"]
            print(f"  rank {i} {name}: fused == unfused bit for bit, graph "
                  f"replays by branch {o['replays']}, launches fused "
                  f"{o['launches'][True]} / unfused {o['launches'][False]}; "
                  f"an iteration {w['eager']:.3f} ms eager, {w['graph']:.3f}"
                  f" ms graph ({w['eager'] / w['graph']:.2f}x)")
            if o["launches"][True] != o["launches"][False]:
                bad.append(f"rank {i} {name}: launches {o['launches']}")
        st = rl["rainbow"]["launches"][True]["tree_sample_blocked"]
        if st != 2 * MESH4["dqn_iters"]:
            bad.append(f"rank {i} rainbow: sum_tree_sample {st} launches, "
                       f"want {2 * MESH4['dqn_iters']}")
        rs = rl["restore"]
        print(f"  rank {i} restore: checkpoint of iteration "
              f"{rs['iteration']} into a new fused loop, on to step "
              f"{rs['step']}: bit for bit {rs['equal']}")
        if not rs["equal"]:
            bad.append(f"rank {i}: the restored fused loop differs")
        st_bar = rl["bar_launches"]["tree_sample_blocked"]
        print(f"  rank {i} Catch bar (dueling + double + prioritized, "
              f"{MESH4['bar_iters']} x {MESH4['bar_updates']}, fused, "
              f"{rl['bar_replays']} replays): greedy {rl['bar']}, "
              f"sum_tree_sample {st_bar}, {rl['bar_wall_s']:.1f} s")
        if not rl["bar"]["avg_return"] > 0.0 or \
                st_bar != MESH4["bar_iters"] * MESH4["bar_updates"]:
            bad.append(f"rank {i}: Catch bar {rl['bar']}, {st_bar}")
    for name, run in MESH4["lm"].items():
        cfg = dataclasses.replace(get_config(run["arch"]),
                                  n_layers=run["layers"])
        steps, T, sites = run["steps"], run["horizon"], attn_sites(cfg)
        want = {"flash_attention": 2 * sites * steps,
                "flash_attention_decode": sites * (T + 1) * steps,
                "ssd_scan": 2 * ssd_layers(cfg) * steps}
        d, m = run["mesh"]
        for i, r in enumerate(ranks):
            o = r[name]
            got = {k: o["launches"].get(k, 0) for k in want}
            for row in o["rows"]:
                print(f"  {name} {d}x{m} rank {i} step {row['step']}: "
                      f"rollout_s {row['rollout_s']:.3f}, update_s "
                      f"{row['update_s']:.3f} (data all-reduce "
                      f"{row['allreduce_s']:.3f}), model-axis collectives "
                      f"{row['tp_allreduce_s']:.3f} s, samples_per_sec "
                      f"{row['samples_per_sec']:.1f}, loss {row['loss']:.5f}")
            g, e = o["rollouts"][True], o["rollouts"][False]
            print(f"  {name} rank {i}: max_memory_allocated "
                  f"{o['peak_gib']:.2f} GiB, train.main {o['wall']:.1f} s, "
                  f"launches {got}; a rollout of the trained LM from one "
                  f"seed: graph {g['wall']:.3f} s (model-axis collectives "
                  f"{g['tp_s']:.3f} s, flash_attn_decode "
                  f"{g['launches']['flash_attention_decode']}) == eager "
                  f"{e['wall']:.3f} s ({e['tp_s']:.3f} s, "
                  f"{e['launches']['flash_attention_decode']}) bit for bit:"
                  f" {o['rollout_equal']} ({card})")
            rows = o["rows"]
            if not (got == want and o["finite"] and o["rollout_equal"]
                    and [row["step"] for row in rows]
                    == list(range(1, steps + 1))
                    and all(math.isfinite(row[k]) for row in rows
                            for k in ("loss", "rollout_s",
                                      "tp_allreduce_s"))):
                bad.append(f"{name} rank {i}: launches {got} (want {want}), "
                           f"finite {o['finite']}, rollout equal "
                           f"{o['rollout_equal']} (max |diff| "
                           f"{o['rollout_diff']}), rows {rows}")
            if o["peak_gib"] > PEAK_GIB:
                bad.append(f"{name} rank {i}: peak {o['peak_gib']:.2f} GiB")
    q = [row["rollout_s"] for r in ranks for row in r["qwen2"]["rows"]]
    e = [r["qwen2"]["rollouts"][False]["wall"] for r in ranks]
    print(f"  qwen2-moe-a2.7b 1x4 rollout_s, graphed: {min(q):.3f}-"
          f"{max(q):.3f} s (the trained LM's eager rollout on the same "
          f"ranks: {min(e):.3f}-{max(e):.3f} s; {card})")
    print(f"  phase {time.perf_counter() - t_phase:.1f} s ({card})")
    if bad:
        fail("mesh4: " + "; ".join(bad))
    return ranks


# ---------------------------------------------------------------------------
# slice 6: the attention instances of the moe family and the other dense
# configs, their serving runs and route checks, the smoke entry points
# ---------------------------------------------------------------------------
def slice6_cfg(arch):
    """The full-width config as chip_smoke serves it (DEPTH_CUT applied)."""
    cfg = get_config(arch)
    if arch in DEPTH_CUT:
        cfg = dataclasses.replace(cfg, n_layers=DEPTH_CUT[arch])
    return cfg


def instance(entry, cfg):
    """The kernels line's name of ``cfg``'s instance of ``entry``; gemma2-2b's
    (dh 256, G 2) keep the entry points' bare names."""
    G = cfg.n_heads // cfg.n_kv_heads
    if cfg.d_head == 256:
        return entry
    if entry == "flash_attn_fwd":
        return f"{entry} dh{cfg.d_head}"
    return f"{entry} dh{cfg.d_head} G{G}"


def instance_checks(cfg, run, gen, errs, sensitivity):
    """``cfg``'s two instances against attention_reference within TOL at
    its serving shape (``run``), ragged, at the continuous run's B 1 and B 8
    shapes, with the softcap reached (q x 20), and for decode at kv_len on
    every boundary of the split plan +-1 and at kv_len 1; the sensitivity
    checks when ``sensitivity``."""
    H, Hkv, dh, w = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.window
    B, T = run["batch"], run["prompt_len"]
    S = T + run["gen"] + 1
    S_cont = CONT["prompt_len"] + CONT["gen"] + 1
    fwd, dec = instance("flash_attn_fwd", cfg), instance("flash_attn_decode",
                                                         cfg)

    def record(entry, name, label, got, want):
        err, share = check(entry, f"{cfg.name} {label}", got, want)
        errs[name] = max(errs.get(name, (0.0, 0.0))[0], err), \
            max(errs.get(name, (0.0, 0.0))[1], share)

    def fwd_case(B_, T_, window, scale=1.0, softcap=None):
        q = randn(B_, T_, H, dh, gen=gen) * scale
        k, v = randn(B_, T_, Hkv, dh, gen=gen), randn(B_, T_, Hkv, dh, gen=gen)
        kw = dict(causal=True, window=window, softcap=softcap)
        want = attention_reference(q, k, v, **kw)
        record("flash_attn_fwd", fwd, f"B{B_} T{T_} window {window}"
               + (f" softcap {softcap} q x{scale:g}" if softcap else ""),
               ops.flash_attention(q, k, v, **kw), want)
        return q, k, v, kw, want

    print(f"kernel phase: {cfg.name} ({fwd}, {dec}) vs attention_reference "
          "(bf16, TOL)")
    for B_, T_ in ((B, T), (B, T - 24)):
        fwd_case(B_, T_, w)
    for T_ in [b for b in DEFAULT_BUCKETS if b <= CONT["prompt_len"]]:
        fwd_case(1, T_, w)
    q, k, v, kw, want = fwd_case(2, T - 24, w, 20.0, 50.0)
    if sensitivity:
        must_differ("flash_attn_fwd", f"{fwd} softcap skipped",
                    attention_reference(q, k, v, **{**kw, "softcap": None}),
                    want)
        q, k, v, kw, want = fwd_case(2, T, w or max(16, T // 4))
        must_differ("flash_attn_fwd", f"{fwd} causal edge one key late",
                    attention_reference(q, k, v, **{**kw, "q_offset": 1}),
                    want)
        must_differ("flash_attn_fwd", f"{fwd} window one key wider",
                    attention_reference(q, k, v,
                                        **{**kw, "window": kw["window"] + 1}),
                    want)

    ragged = torch.randint(T + 1, S + 1, (B,), generator=gen,
                           device=DEV).tolist()
    slots = [1, 9, 24, 40, 57, 64, 96, 97]
    cases = [(B, S, ragged, 1.0, None), (8, S_cont, slots, 1.0, None),
             (1, S_cont, [9], 1.0, None), (1, S_cont, [33], 1.0, None),
             (1, S_cont, [64], 1.0, None), (B, S, [1] * B, 1.0, None),
             (1, S_cont, [1], 1.0, None)]
    for B_, S_ in sorted({(B, S), (8, S_cont), (1, S_cont)}):
        n_split, chunk = decode_split_plan(B_, Hkv, S_)
        vals = sorted({i * chunk + d for i in range(1, n_split)
                       for d in (-1, 0, 1)} | {S_})
        cases += [(B_, S_, (vals[i:i + B_] + [1] * B_)[:B_], 1.0, None)
                  for i in range(0, len(vals), B_)]
    # last: the softcap cases, whose last the sensitivity checks reuse
    cases += [(B, S, ragged, 20.0, 50.0), (8, S_cont, slots, 20.0, 50.0)]
    for B_, S_, kvl, scale, cap in cases:
        q = randn(B_, 1, H, dh, gen=gen) * scale
        k, v = randn(B_, S_, Hkv, dh, gen=gen), randn(B_, S_, Hkv, dh, gen=gen)
        kv_len = torch.tensor(kvl, dtype=torch.int32, device=DEV)
        want = attention_reference(q, k, v, causal=False, softcap=cap,
                                   kv_len=kv_len)
        record("flash_attn_decode", dec, f"B{B_} S{S_} kv_len {kvl}"
               + (f" softcap {cap} q x{scale:g}" if cap else ""),
               ops.flash_attention_decode(q, k, v, kv_len, softcap=cap), want)
    if not sensitivity:
        return
    must_differ("flash_attn_decode", f"{dec} softcap skipped",
                attention_reference(q, k, v, causal=False, softcap=None,
                                    kv_len=kv_len), want)
    # one key lost: at q x 1 every key weighs about 1 / kv_len
    q = randn(8, 1, H, dh, gen=gen)
    k, v = randn(8, S_cont, Hkv, dh, gen=gen), randn(8, S_cont, Hkv, dh, gen=gen)
    kv_len = torch.tensor(slots, dtype=torch.int32, device=DEV)
    want = attention_reference(q, k, v, causal=False, kv_len=kv_len)
    record("flash_attn_decode", dec, f"B8 S{S_cont} kv_len {slots}",
           ops.flash_attention_decode(q, k, v, kv_len), want)
    must_differ("flash_attn_decode", f"{dec} last key of kv_len dropped",
                attention_reference(q, k, v, causal=False,
                                    kv_len=torch.clamp(kv_len - 1, min=1)),
                want)
    n_split, chunk = decode_split_plan(B, Hkv, S)
    q = randn(B, 1, H, dh, gen=gen)
    k, v = randn(B, S, Hkv, dh, gen=gen), randn(B, S, Hkv, dh, gen=gen)
    kv_len = torch.randint(chunk + 1, S + 1, (B,), generator=gen,
                           device=DEV).to(torch.int32)
    want = attention_reference(q, k, v, causal=False, kv_len=kv_len)
    record("flash_attn_decode", dec, f"B{B} S{S} kv_len {kv_len.tolist()}",
           ops.flash_attention_decode(q, k, v, kv_len), want)
    must_differ("flash_attn_decode", f"{dec} last non-empty split dropped",
                attention_reference(q, k, v, causal=False,
                                    kv_len=(kv_len - 1) // chunk * chunk),
                want)


def instance_phase():
    """Every attention instance of slices 6 and 7 against its plain version, then
    its times at its config's serving shape.  Returns (errs, timing): the
    largest error and tolerance share by instance name, the timing by
    (instance name, config name)."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 6)
    errs, timing = {}, {"grid": {}}
    shapes = [(slice6_cfg(a), SERVE6) for a in SLICE6] + \
        [(get_smoke_config(a), SMOKE_SERVE) for a in SMOKE6] + \
        [(slice6_cfg(a), SERVE7[a]) for a in SLICE7] + \
        [(tp_local_cfg(slice6_cfg(a), m), SERVE6) for a, m in TP_INSTANCES]
    sensitive = {"glm4-9b", "qwen2-moe-a2.7b", "mixtral-smoke"} | set(SLICE7)
    for cfg, run in shapes:
        instance_checks(cfg, run, gen, errs, cfg.name in sensitive)
    for cfg, run in shapes:
        B, T = run["batch"], run["prompt_len"]
        S = T + run["gen"] + 1
        for entry, (t, grid) in (
                ("flash_attn_fwd", fwd_timing(cfg, B, T, gen)),
                ("flash_attn_decode", decode_timing(cfg, B, S, T + 1, gen))):
            key = (instance(entry, cfg), cfg.name)
            timing[key] = t
            timing["grid"][f"{key[0]} ({cfg.name})"] = grid
    shown = {"grid": timing.pop("grid")}
    shown.update({f"{name} ({arch})": t for (name, arch), t in timing.items()})
    print_timing(shown)
    return errs, timing


def routing_masks(calls, E):
    """(chosen, kept) expert masks of each token in each moe call of a
    ``record_routing`` record: (calls, B, T, E) bool each."""
    chosen, kept = [], []
    for experts, keep in calls:
        hot = F.one_hot(experts, E).bool()  # (B, T, K, E)
        chosen.append(hot.any(2))
        kept.append((hot & keep[..., None]).any(2))
    return torch.stack(chosen), torch.stack(kept)


class attention_swapped:
    """Within the block the model's attention takes another function: the
    kernel route the kernel's plain version (``plain``), or the ref route a
    causal edge one key late (``late``: each query also sees the next
    key) -- the route check's calibration and its sensitivity."""

    def __init__(self, how):
        self.how = how

    def __enter__(self):
        self.saved = (tl.flash_attention, tl.multihead_attention)
        if self.how == "plain":
            tl.flash_attention = lambda q, k, v, **kw: attention_reference(
                q, k, v, **kw)
        else:
            mha = self.saved[1]
            tl.multihead_attention = lambda q, k, v, *, q_positions, **kw: \
                mha(q, k, v, q_positions=q_positions + 1, **kw)

    def __exit__(self, *exc):
        tl.flash_attention, tl.multihead_attention = self.saved


def moe_route_check(cfg):
    """The kernel route against --kernels ref on the same weights and the
    fixed rounds' first prompts, at ``cfg``'s (cut) depth.  The forward
    (flash_attn_fwd on the kernel route): the share of (token, layer)
    routings that agree with the ref route's at least the kernel's plain
    version's share less ROUTE_AGREE_MARGIN, a causal edge one key late
    below that bound, and the logits of every token whose chosen and kept
    experts agree in every layer, as do those of every earlier token of
    its sequence (causal attention reads them), within LOGIT_TOL.  Then one
    decode step (flash_attn_decode) on both routes from the same cache, the
    kernel route's prefill: the logits of the sequences whose step routing
    agrees in every layer within LOGIT_TOL."""
    B, T = SERVE6["batch"], SERVE6["prompt_len"]
    params = bb.init_lm(cfg, device=DEV, generator=torch.Generator(
        device=DEV).manual_seed(SEED))
    prompts = serve.make_prompts(
        cfg, B, T, torch.Generator(device=DEV).manual_seed(SEED + 1), DEV)
    prefill, _ = serve.make_phases(cfg, B, T, 1, device=DEV)
    with registry.override("cuda"):
        logits, cache = prefill(params, prompts)
    first_tok = torch.argmax(logits, -1).to(torch.int32)
    out = {}
    for spec in ("cuda", "ref"):
        with registry.override(spec), torch.inference_mode():
            with record_routing() as fwd_calls:
                hidden, _ = bb.forward_train(params, prompts, cfg)
            step_cache = {k: v.clone() for k, v in cache.items()}
            with record_routing() as step_calls:
                h, _ = bb.decode_step(params, step_cache, first_tok, cfg)
            step = bb.lm_logits(params, h, cfg)[:, 0].float()
            del step_cache
            out[spec] = (hidden, fwd_calls, step_calls, step)
        torch.cuda.synchronize()
    del cache
    routes = {}
    for name, spec in (("plain", "cuda"), ("late", "ref")):
        with registry.override(spec), torch.inference_mode(), \
                attention_swapped(name), record_routing() as calls:
            bb.forward_train(params, prompts, cfg)
        routes[name] = calls
    (hk, fk, sk, stk), (hr, fr, sr, str_) = out["cuda"], out["ref"]
    cr, kr = routing_masks(fr, cfg.n_experts)

    def agreement(calls):
        c, k = routing_masks(calls, cfg.n_experts)
        return ((c == cr) & (k == kr)).all(-1)  # (layers, B, T)

    agree = agreement(fk)
    shares = {name: float(agreement(calls).float().mean())
              for name, calls in (("kernel", fk), *routes.items())}
    bound = shares["plain"] - ROUTE_AGREE_MARGIN
    by_layer = ", ".join(f"{float(a.float().mean()):.4f}" for a in agree)
    # a token, and every earlier one of its sequence, in every layer
    tokens = torch.cumprod(agree.all(0).int(), dim=1).bool()  # (B, T)
    err, top = 0.0, 0.0
    with torch.inference_mode():
        for i, m in enumerate(tokens):  # one sequence's (T, V) at a time
            a, b = (bb.lm_logits(params, h[i:i + 1], cfg)[0].float()
                    for h in (hk, hr))
            if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                fail(f"{cfg.name} route check: non-finite logits")
            top = max(top, float(b.abs().max()))
            if m.any():
                err = max(err, float((a - b).abs()[m].max()))
    sck, skk = routing_masks(sk, cfg.n_experts)
    scr, skr = routing_masks(sr, cfg.n_experts)
    rows = ((sck == scr) & (skk == skr)).all(-1).all(0)[:, 0]  # (B,)
    step_err = float((stk - str_).abs()[rows].max()) if rows.any() else 0.0
    print(f"  {cfg.name} route check ({cfg.n_layers} layers, B{B} prompt "
          f"{T}): (token, layer) routings that agree with the ref route's: "
          f"kernel {shares['kernel']:.4f} (by layer {by_layer}), the "
          f"kernel's plain version {shares['plain']:.4f}, required >= "
          f"{bound:.4f}; sensitivity: causal edge one key late "
          f"{shares['late']:.4f} -> "
          f"{'caught' if shares['late'] < bound else 'NOT caught'}")
    print(f"    tokens compared (their own and every earlier token's "
          f"routing agree) {int(tokens.sum())} of {tokens.numel()}, "
          f"{int(tokens[:, :1].sum())} of {B} first tokens: forward logits "
          f"max abs diff {err:.4f} (|logit| max {top:.3f}, tolerance "
          f"{LOGIT_TOL}); one decode step from the same cache, "
          f"{int(rows.sum())} of {B} sequences agreeing: max abs diff "
          f"{step_err:.4f}")
    if shares["kernel"] < bound or not tokens.any() or not rows.any():
        fail(f"{cfg.name} route check: routings agree {shares}, "
             f"{int(tokens.sum())} tokens and {int(rows.sum())} sequences "
             "to compare")
    if shares["late"] >= bound:
        fail(f"{cfg.name} route check: the share would not catch a causal "
             f"edge one key late ({shares})")
    if max(err, step_err) > LOGIT_TOL:
        fail(f"{cfg.name} route check: kernel route and ref route differ by "
             f"{max(err, step_err)} on agreeing tokens")


def serve_rows(log_dir):
    return [json.loads(ln) for ln in
            (Path(log_dir) / "serve.jsonl").read_text().splitlines()]


def slice6_serve(arch, log_dir, rounds, continuous=False, run=SERVE6):
    """serve.main --full for ``arch`` (its DEPTH_CUT), ``rounds`` fixed
    rounds at ``run``, then the continuous run when asked; both entry points
    must launch, once an attention site (``attn_sites``) a prefill and a
    decode step each, and the SSD scan never (the prefill passes the cache
    state); then the route check at ROUTE_CUT (ROUTE_LAYERS) layers.
    Returns the launch counts by instance name."""
    cfg = slice6_cfg(arch)
    L, sites = cfg.n_layers, attn_sites(cfg)
    log_dir = str(Path(log_dir) / arch)
    cut = [] if arch not in DEPTH_CUT else ["--layers", str(L)]
    n_params = sum(p.numel() for p in bb.LM(cfg, device="meta",
                                             dtype=torch.bfloat16).parameters())
    print(f"slice phase: serving {arch} (full width, {L} layers"
          + (f" of {get_config(arch).n_layers}" if cut else "")
          + f", d_model {cfg.d_model}, {n_params} params in bf16) fixed rounds "
          f"(batch {run['batch']}, prompt {run['prompt_len']}, gen "
          f"{run['gen']}, {rounds} round{'s' if rounds > 1 else ''})")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counters()
    toks = serve.main(["--arch", arch, "--full", "--device", "cuda", "--batch",
                       str(run["batch"]), "--prompt-len",
                       str(run["prompt_len"]), "--gen", str(run["gen"]),
                       "--rounds", str(rounds), "--seed", str(SEED),
                       "--log-dir", log_dir] + cut)
    got = kernel_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    fixed = {"flash_attn_fwd": got["flash_attention"],
             "flash_attn_decode": got["flash_attention_decode"]}
    want = {"flash_attn_fwd": sites * rounds,
            "flash_attn_decode": sites * run["gen"] * rounds}
    print(f"  launches in the fixed rounds: {fixed} (one an attention site, "
          f"{sites} of {L} layers, a prefill and a decode step: {want}); "
          f"max_memory_allocated {peak:.2f} GiB")
    if fixed != want or any(v for k, v in got.items()
                            if k not in ("flash_attention",
                                         "flash_attention_decode")):
        fail(f"{arch} fixed rounds: launches {got}, expected {want}")
    if tuple(toks.shape) != (run["batch"], run["gen"]) or \
            int(toks.min()) < 0 or int(toks.max()) >= cfg.padded_vocab:
        fail(f"{arch} fixed rounds: bad tokens {tuple(toks.shape)}")
    for r in serve_rows(log_dir):
        if not all(math.isfinite(v) for v in r.values()
                   if isinstance(v, float)):
            fail(f"{arch} fixed rounds: non-finite metrics {r}")
        prefill_s = r["batch"] * r["prompt_len"] / r["prefill_tok_per_sec"]
        print(f"  round: prefill {prefill_s:.4f} s "
              f"({r['prefill_tok_per_sec']:.1f} tok/s), decode step "
              f"{r['decode_step_ms']:.3f} ms of wall "
              f"({r['decode_tok_per_sec']:.1f} tok/s)")
    launches = {instance(k, cfg): v for k, v in fixed.items()}
    torch.cuda.empty_cache()
    if continuous:
        print(f"slice phase: serving {arch} continuous ({CONT['requests']} "
              f"requests, {CONT['slots']} slots)")
        zero_kernel_counters()
        args = ["--arch", arch, "--full", "--device", "cuda", "--continuous",
                "--seed", str(SEED), "--log-dir", log_dir] + cut
        for key, val in CONT.items():
            args += ["--" + key.replace("_", "-"), str(val)]
        summary = serve.main(args)
        got = kernel_launches()
        cont = {"flash_attn_fwd": got["flash_attention"],
                "flash_attn_decode": got["flash_attention_decode"]}
        trace = poisson_trace(
            SEED, CONT["requests"], CONT["rate"],
            prompt_len_range=(CONT["prompt_min"], CONT["prompt_len"]),
            max_tokens_range=(CONT["gen_min"], CONT["gen"]), vocab=cfg.vocab)
        n_tok = sum(r.max_tokens for r in trace)
        print(f"  launches in the continuous run: {cont}; p50 latency "
              f"{summary['p50_latency_s']:.4f} s, p99 "
              f"{summary['p99_latency_s']:.4f} s, ttft p50 "
              f"{summary.get('ttft_p50_s', float('nan')):.4f} s, decode "
              f"{summary['decode_tok_per_sec']:.1f} tok/s")
        if min(cont.values()) == 0 or summary["n_finished"] != len(trace) \
                or summary["generated_tokens"] != n_tok:
            fail(f"{arch} continuous: launches {cont}, "
                 f"{summary['n_finished']} finished, "
                 f"{summary['generated_tokens']} tokens, expected "
                 f"{len(trace)} / {n_tok}")
        for k, v in cont.items():
            launches[instance(k, cfg)] += v
        torch.cuda.empty_cache()
    route = dataclasses.replace(cfg, n_layers=ROUTE_CUT.get(arch,
                                                            ROUTE_LAYERS))
    print(f"  route check at {route.n_layers} layers")
    if cfg.family == "moe":
        moe_route_check(route)
    else:
        params, prompts = served_weights(route, run["prompt_len"])
        kernel_vs_ref(route, params, prompts, 8)
        del params, prompts
    torch.cuda.empty_cache()
    print(f"  phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def smoke_entry_points(log_dir):
    """The entry points' smoke configs on the card, each launching its
    kernel instances exactly as often as its path runs them: once an
    attention site a prefill, a training forward (twice under remat) and a
    decode step, and the SSD scan once a Mamba-2 layer a training forward
    (the smoke mamba2 and zamba2: P 16, N 16, chunk 8); serve's default
    (smoke mamba2) serves one round and launches nothing.  ``train --arch
    whisper-medium`` is refused before any weight is drawn (its launcher
    passes no encoder frames, as JAX's, whose train fails on them).  Returns
    the launch counts by instance name."""
    print("entry points: --smoke on cuda")
    held = torch.cuda.memory_allocated()
    try:
        train.main(["--arch", "whisper-medium", "--steps", "1"])
    except ValueError as e:
        msg = str(e)
    else:
        fail("train --arch whisper-medium: trained without encoder frames")
    if "enc_frames=None" not in msg or \
            torch.cuda.memory_allocated() != held:
        fail(f"train --arch whisper-medium: not refused up front: {msg}")
    print(f"  train --arch whisper-medium: refused before any weight was "
          f"drawn: {msg}")
    launches = {}
    t_phase = time.perf_counter()
    sd = serve_decode.DEFAULTS
    default_train = train.build_parser().get_default
    runs = [  # (label, entry, arch, argv)
        ("train (default: smoke gemma2-2b)", "train", "gemma2-2b",
         ["--steps", "3"]),
        ("train --arch qwen2-moe-a2.7b", "train", "qwen2-moe-a2.7b",
         ["--arch", "qwen2-moe-a2.7b", "--steps", "3"]),
        ("train --arch mamba2-1.3b", "train", "mamba2-1.3b",
         ["--arch", "mamba2-1.3b", "--steps", "3"]),
        ("train --arch zamba2-7b", "train", "zamba2-7b",
         ["--arch", "zamba2-7b", "--steps", "3"]),
        ("serve --arch gemma2-2b", "serve", "gemma2-2b",
         ["--arch", "gemma2-2b", "--rounds", "1"]),
        ("serve_decode (default: smoke mixtral-8x7b)", "serve_decode",
         sd[sd.index("--arch") + 1], []),
        ("serve --arch granite-34b", "serve", "granite-34b",
         ["--arch", "granite-34b", "--rounds", "1"]),
        ("serve --arch zamba2-7b", "serve", "zamba2-7b",
         ["--arch", "zamba2-7b", "--rounds", "1"]),
        ("serve --arch whisper-medium", "serve", "whisper-medium",
         ["--arch", "whisper-medium", "--rounds", "1"]),
        ("serve --arch llama-3.2-vision-90b", "serve", "llama-3.2-vision-90b",
         ["--arch", "llama-3.2-vision-90b", "--rounds", "1"])]
    for label, entry, arch, argv in runs:
        cfg = get_smoke_config(arch)
        sites = attn_sites(cfg)
        zero_kernel_counters()
        run_dir = str(Path(log_dir) / f"smoke-{entry}-{arch}")
        if entry == "train":
            train.main(argv + ["--log-dir", run_dir])
            steps = int(argv[argv.index("--steps") + 1])
            horizon = default_train("horizon")
            fwd = 2 if cfg.remat else 1
            want = {"flash_attention": sites * fwd * steps,
                    "flash_attention_decode": sites * (horizon + 1) * steps,
                    "ssd_scan": ssd_layers(cfg) * fwd * steps}
            rows = [json.loads(ln) for ln in (Path(run_dir) / "progress.jsonl")
                    .read_text().splitlines()]
            ok = len(rows) == steps and all(
                math.isfinite(v) for r in rows for v in r.values()
                if isinstance(v, float))
            what = (f"{steps} PPO steps (batch {default_train('batch')}, "
                    f"horizon {horizon}), loss {rows[-1]['loss']:.5f}")
        else:
            if entry == "serve":
                toks = serve.main(argv + ["--log-dir", run_dir])
            else:  # the twin's own default argv
                toks = serve_decode.main([])
            full = serve.build_parser().parse_args(argv or sd)
            rounds, b, gen = full.rounds, full.batch, full.gen
            want = {"flash_attention": sites * rounds,
                    "flash_attention_decode": sites * gen * rounds}
            ok = tuple(toks.shape) == (b, gen)
            what = (f"{rounds} round{'s' if rounds > 1 else ''} at batch {b}, "
                    f"prompt {full.prompt_len}, gen {gen}, tokens "
                    f"{tuple(toks.shape)}")
        got = kernel_launches()
        want = {k: want.get(k, 0) for k in got}
        print(f"  {label}: {what}; launches {got}")
        if not ok or got != want:
            fail(f"{label} on cuda: launches {got}, expected {want}")
        add_by_instance(launches, cfg, got)
    zero_kernel_counters()
    toks = serve.main(["--rounds", "1"])
    got = kernel_launches()
    default = serve.build_parser().get_default
    if tuple(toks.shape) != (default("batch"), default("gen")) or \
            any(got.values()):
        fail(f"serve's default (smoke {default('arch')}) on cuda: tokens "
             f"{tuple(toks.shape)}, launches {got}")
    print(f"  serve (default: smoke {default('arch')}): one round on the "
          f"card, tokens {tuple(toks.shape)}, no kernel launched")
    print(f"  phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def ssd_instance(cfg) -> str:
    """The kernels line's name of ``cfg``'s SSD instance; mamba2-1.3b's
    keeps the bare name."""
    if (cfg.ssm_headdim, cfg.d_state) == (64, 128):
        return "ssd_scan"
    return f"ssd_scan P{cfg.ssm_headdim} N{cfg.d_state}"


def add_by_instance(total, cfg, got):
    """Add a run's launch counts by counter (``kernel_launches``) into
    ``total`` under the kernels line's instance names of ``cfg``."""
    names = {"flash_attention": lambda: instance("flash_attn_fwd", cfg),
             "flash_attention_decode":
                 lambda: instance("flash_attn_decode", cfg),
             "ssd_scan": lambda: ssd_instance(cfg)}
    for k, n in got.items():
        if n:
            key = names[k]()
            total[key] = total.get(key, 0) + n


# ---------------------------------------------------------------------------
# the captured paths (CUDA graphs, core/graphs.py) against their eager runs
# ---------------------------------------------------------------------------
# path -> (eager ms, graph ms, unit): the walls printed at the end beside
# the card's name and power limit (the busy time and the idle share of each
# are in the profile phase's lines)
GRAPH_WALLS = {}
# the checks sample at temperature 1, so the generator's draws are inside
# the graphs too (the main path's serving is greedy)
GRAPH_TEMP = 1.0


def graph_leaf(x) -> bool:
    return isinstance(x, torch.Generator)


def snapshot(tree):
    """Every leaf of ``tree`` as it is now: tensors cloned, generators by
    their state."""
    return [x.get_state() if isinstance(x, torch.Generator)
            else x.detach().clone() if torch.is_tensor(x) else x
            for x in pytree.tree_leaves(tree, is_leaf=graph_leaf)]


def same_snapshot(a, b) -> bool:
    """Bit for bit: dtype, shape and every bit of each tensor, generator
    states, plain leaves by ==."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if torch.is_tensor(x):
            if not (torch.is_tensor(y) and x.dtype == y.dtype
                    and x.shape == y.shape and torch.equal(x, y)):
                return False
        elif x != y:
            return False
    return True


def want_launches(cfg, prefills, decode_steps):
    """Exact launch counts of serving: one kernel an attention site a
    prefill and a decode step; the SSD scan never (the prefill passes the
    cache's state)."""
    sites = attn_sites(cfg)
    return {c.__name__: 0 for c in KERNEL_COUNTERS} | {
        "flash_attention": sites * prefills,
        "flash_attention_decode": sites * decode_steps}


def fixed_rounds_graph_check(cfg, params, prompts, gen_len=64, rounds=2):
    """serve's fixed rounds with each decode step replayed from its graph
    against the eager step, on the same weights, prompts and sampling
    generator: the tokens of every round bit for bit, and on both paths
    one kernel launch an attention site a prefill and a decode step
    exactly (the graph's counted once a replay).  The wall of a decode
    step is the second round's (the first warms up and captures)."""
    batch, prompt_len = prompts.shape
    toks, walls, launches = {}, {}, {}
    for graph in (False, True):
        prefill, decode = serve.make_phases(cfg, batch, prompt_len, gen_len,
                                            GRAPH_TEMP, device=DEV,
                                            graph=graph)
        gen = torch.Generator(device=DEV).manual_seed(SEED + 5)
        zero_kernel_counters()
        toks[graph] = []
        for _ in range(rounds):
            logits, cache = prefill(params, prompts)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks[graph].append(decode(params, logits, cache, gen))
            torch.cuda.synchronize()
            walls[graph] = (time.perf_counter() - t0) * 1e3 / gen_len
            del logits, cache
        launches[graph] = kernel_launches()
        replays = decode.step.replays if graph else 0
        del prefill, decode
        torch.cuda.empty_cache()
    want = want_launches(cfg, rounds, rounds * gen_len)
    same = all(torch.equal(a, b) for a, b in zip(toks[False], toks[True]))
    print(f"  {cfg.name} fixed rounds (B{batch}, prompt {prompt_len}, gen "
          f"{gen_len}, {rounds} rounds, temperature {GRAPH_TEMP}): graph "
          f"tokens == eager tokens bit for bit: {same}; decode step "
          f"{walls[False]:.3f} ms eager, {walls[True]:.3f} ms graph "
          f"({replays} replays); launches eager {launches[False]}, graph "
          f"{launches[True]}")
    if not same:
        fail(f"{cfg.name}: the replayed decode's tokens differ from eager")
    if launches[False] != want or launches[True] != want:
        fail(f"{cfg.name} fixed rounds: launches {launches}, want {want}")
    GRAPH_WALLS[f"{cfg.name} decode step (B{batch}, S "
                f"{prompt_len + gen_len + 1})"] = (walls[False], walls[True],
                                                   "a step")


def continuous_graph_check(cfg, params):
    """The engine's decode block replayed from its graph against the eager
    block on the continuous run's trace, offline (every arrival at 0, so
    both runs admit alike), sampled from the engine's seeded generator:
    every request's tokens bit for bit; each path's decode_step_ms."""
    out = {}
    for graph in (False, True):
        engine = ContinuousBatchEngine(
            cfg, params, n_slots=CONT["slots"],
            max_context=CONT["prompt_len"] + CONT["gen"] + 1, device=DEV,
            buckets=[b for b in DEFAULT_BUCKETS if b <= CONT["prompt_len"]],
            decode_block=4, temperature=GRAPH_TEMP, seed=SEED, graph=graph)
        engine.warmup()
        reqs = poisson_trace(
            SEED, CONT["requests"], CONT["rate"],
            prompt_len_range=(CONT["prompt_min"], CONT["prompt_len"]),
            max_tokens_range=(CONT["gen_min"], CONT["gen"]), vocab=cfg.vocab)
        summary = engine.run(reqs, realtime=False)
        out[graph] = ([np.asarray(r.tokens) for r in reqs], summary)
        del engine
        torch.cuda.empty_cache()
    same = all(np.array_equal(a, b) for a, b in zip(out[False][0],
                                                     out[True][0]))
    ms = {g: out[g][1]["decode_step_ms"] for g in out}
    print(f"  {cfg.name} continuous ({CONT['requests']} requests offline, "
          f"{CONT['slots']} slots, blocks of 4, temperature {GRAPH_TEMP}): "
          f"graph tokens == eager tokens bit for bit: {same}; decode step "
          f"{ms[False]:.3f} ms eager, {ms[True]:.3f} ms graph")
    if not same or out[True][1]["n_finished"] != CONT["requests"]:
        fail(f"{cfg.name} continuous: the replayed blocks' tokens differ "
             "from eager")
    GRAPH_WALLS[f"{cfg.name} continuous decode step ({CONT['slots']} "
                "slots)"] = (ms[False], ms[True], "a step")


def rollout_graph_check(cfg, run):
    """The LM rollout with its step replayed from a graph against the
    eager step, on the same f32 weights and generator seed, two rollouts
    each: every (T, B) leaf and v_last bit for bit, and one
    flash_attn_decode an attention site a step (the bootstrap's too)
    exactly under replay.  The wall of a step is the second rollout's."""
    env = make_token_lm(vocab=cfg.vocab, episode_len=run["horizon"],
                        device=DEV)
    params = bb.init_lm(cfg, device=DEV, generator=torch.Generator(
        device=DEV).manual_seed(SEED), dtype=torch.float32,
        requires_grad=True)
    T = run["horizon"]
    snaps, walls, launches = {}, {}, {}
    for graph in (False, True):
        rollout = train.make_lm_rollout(cfg, env, run["batch"], T,
                                        device=DEV, graph=graph)
        gen = torch.Generator(device=DEV).manual_seed(SEED + 6)
        zero_kernel_counters()
        snaps[graph] = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            traj, v_last = rollout(params, gen)
            torch.cuda.synchronize()
            walls[graph] = (time.perf_counter() - t0) * 1e3 / (T + 1)
            snaps[graph].append(snapshot((traj, v_last)))
        launches[graph] = kernel_launches()
        del rollout, traj, v_last
        torch.cuda.empty_cache()
    want = {c.__name__: 0 for c in KERNEL_COUNTERS} | {
        "flash_attention_decode": 2 * attn_sites(cfg) * (T + 1)}
    same = all(same_snapshot(a, b) for a, b in zip(snaps[False],
                                                    snaps[True]))
    print(f"  {cfg.name} rollout (B{run['batch']}, horizon {T}, two "
          f"rollouts, {cfg.n_layers} layers): graph trajectory == eager "
          f"bit for bit: {same}; a step {walls[False]:.3f} ms eager, "
          f"{walls[True]:.3f} ms graph; launches eager {launches[False]}, "
          f"graph {launches[True]}")
    if not same:
        fail(f"{cfg.name}: the replayed rollout differs from eager")
    if launches[False] != want or launches[True] != want:
        fail(f"{cfg.name} rollout: launches {launches}, want {want}")
    GRAPH_WALLS[f"{cfg.name} rollout step (B{run['batch']}, horizon "
                f"{T})"] = (walls[False], walls[True], "a step")
    del params, snaps
    torch.cuda.empty_cache()


def fused_identity(label, make, n, launches=None):
    """``make()``'s runner (a fresh (runner, params) pair each call) run
    from SEED twice for ``n`` iterations, fused (each iteration a graph
    replay, after each graph's eager warm-up) and unfused: after every
    iteration the train, sampler and replay states, the generators' states
    and the iteration's info and sentinels bit for bit.  Returns the fused
    loop's graph replays by branch key; ``launches`` (a dict) gets each
    mode's kernel launches by ``fuse``."""
    trail, mismatch, replays = [], [], {}
    # cuDNN's default convolution backward adds in an order that changes
    # from run to run (two eager runs of Catch's conv model differ in the
    # 1e-10s): the comparison runs its deterministic algorithms, as the
    # R2D1 lockstep check does
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for fuse in (True, False):
        runner, params = make()
        loop = runner.loop
        loop.fuse = fuse
        inner = loop.run_window
        if launches is not None:
            zero_kernel_counters()

        def run_window(ts, ss, rs, gen, k, inner=inner, fuse=fuse):
            sents = []
            for _ in range(k):
                ts, ss, rs, info, sent = inner(ts, ss, rs, gen, 1)
                sents.append(sent)
                snap = snapshot((ts, ss, rs, gen, info, sent))
                i = run_window.i
                if fuse:
                    trail.append(snap)
                elif i >= len(trail) or not same_snapshot(trail[i], snap):
                    mismatch.append(i)
                run_window.i += 1
            stacked = None if sents[0] is None else pytree.tree_map(
                lambda *x: torch.cat(x), *sents)
            return ts, ss, rs, info, stacked

        run_window.i = 0
        loop.run_window = run_window
        runner.run(SEED, params=params, device=DEV)
        if launches is not None:
            launches[fuse] = kernel_launches()
        if fuse:
            replays = {k: g.replays for k, g in loop.graphs.items()}
        del runner, loop
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = was
    print(f"  {label}: {n} iterations fused (graph replays by branch "
          f"{replays}) == unfused after every iteration, bit for bit: "
          f"{not mismatch and len(trail) == n}")
    if mismatch or len(trail) != n:
        fail(f"{label}: fused iterations {mismatch[:5]} differ from unfused "
             f"({len(trail)} of {n} recorded)")
    return replays


def iteration_walls(label, make, n):
    """Unprofiled wall of ``n`` TrainLoop iterations, eager
    (``iteration``) and fused (``fused_iteration``, a graph replay each),
    each on its own runner after two iterations of ``run``; returns {mode:
    (fn, ms)} for the profile phase."""
    work = {}
    for mode in ("eager", "graph"):
        runner, params = make()
        runner.loop.fuse = mode == "graph"
        ts, ss, _ = runner.run(SEED, params=params, device=DEV)
        runner.loop.graphs = {}
        state = [ts, ss, getattr(runner, "replay_state", None),
                 torch.Generator(device=DEV).manual_seed(SEED + 3)]
        step = runner.loop.fused_iteration if mode == "graph" else \
            runner.loop.iteration

        def iterate(k=n, state=state, step=step):
            for _ in range(k):
                state[0], state[1], state[2], _, _ = step(*state)
            torch.cuda.synchronize()

        iterate(2)
        t0 = time.perf_counter()
        iterate()
        work[mode] = (iterate, (time.perf_counter() - t0) * 1e3 / n)
    GRAPH_WALLS[label] = (work["eager"][1], work["graph"][1], "an iteration")
    print(f"  one {label}: {work['eager'][1]:.3f} ms eager, "
          f"{work['graph'][1]:.3f} ms graph (unprofiled)")
    return work


def profile_walls(label, work, n):
    """The profile phase's lines for an eager / graph pair of ``work``: the
    graph's replays profiled, the eager wall beside their busy time."""
    fn, wall = work["graph"]
    busy = profile_work(f"{label} (graph)", fn, wall, n)
    replayed_busy(f"{label} (eager)", work["eager"][1], busy)


# ---------------------------------------------------------------------------
# phase 12b: the tooling (launcher, specs, dry run)
# ---------------------------------------------------------------------------
TIMED_PYTHON = """#!/bin/bash
# the interpreter, with the job's wall written into its --log-dir (the
# last argument run_variants passes)
start=$(date +%s.%N)
"{python}" "$@"
rc=$?
echo "$start $(date +%s.%N)" > "${{@: -1}}/wall.txt"
exit $rc
"""


def launcher_check(root: Path) -> None:
    """(a) rlpyt's variant launcher queues the smoke trainer's variants on
    the card, ``capacity`` at a time: every job exits 0 and leaves its
    ``variant.json`` and one ``progress.jsonl`` row a step."""
    wrapper = root / "timed_python"
    wrapper.write_text(TIMED_PYTHON.format(python=sys.executable))
    wrapper.chmod(0o755)
    variants = launcher.make_variants(TOOLING["variants"], **TOOLING["grid"])
    keys = list(TOOLING["grid"])
    out_root = root / "runs"
    t0 = time.perf_counter()
    codes = launcher.run_variants("repro_torch.launch.train", variants, keys,
                                  capacity=TOOLING["capacity"],
                                  out_root=str(out_root),
                                  python=str(wrapper))
    queue_s = time.perf_counter() - t0
    if codes != [0] * len(variants):
        for i, c in enumerate(codes):
            if c:
                log = (out_root / f"job_{i:03d}.log").read_text()
                print(f"  job {i} exited {c}:\n{log[-3000:]}",
                      file=sys.stderr)
        fail(f"launcher: exit codes {codes}")
    walls = []
    for v in variants:
        vdir = out_root / launcher.variant_name(v, keys)
        if json.loads((vdir / "variant.json").read_text()) != v:
            fail(f"launcher: {vdir}/variant.json is not {v}")
        rows = [json.loads(ln) for ln in
                (vdir / "progress.jsonl").read_text().splitlines() if ln]
        if len(rows) != v["steps"]:
            fail(f"launcher: {vdir} logged {len(rows)} rows, --steps is "
                 f"{v['steps']}")
        start, end = map(float, (vdir / "wall.txt").read_text().split())
        walls.append(end - start)
    print(f"  launcher: {len(variants)} variants of `python -m "
          f"repro_torch.launch.train` ({TOOLING['variants']}, grid "
          f"{TOOLING['grid']}) at capacity {TOOLING['capacity']}: every job "
          f"exited 0 with variant.json and {TOOLING['variants']['steps']} "
          f"progress rows; queue wall {queue_s:.2f} s, the jobs' walls sum "
          f"to {sum(walls):.2f} s ({', '.join(f'{w:.2f}' for w in walls)})"
          f" ({smi()})")


def specs_check() -> None:
    """(b) ``specs`` give the shape and dtype of every tensor that serving
    gemma2-2b allocates at phase 4's shape (B 8, cache S 1089), and the dry
    run's ``argument_bytes`` on a 1 x 1 mesh are their bytes, exactly."""
    cfg = get_config("gemma2-2b")
    B, _, S = TOOLING["serve"]
    cell = ShapeCell("phase4_decode", S, B, "decode")
    want_params = specs.param_specs(cfg, "decode")
    want = specs.decode_specs(cfg, cell)
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    params = bb.init_lm(cfg, device=DEV, generator=torch.Generator(
        device=DEV).manual_seed(SEED))
    cache = bb.init_cache(cfg, B, S, device=DEV)
    tokens = torch.zeros((B,), dtype=torch.int32, device=DEV)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - m0
    got = dict(params.named_parameters())
    spec_params = dict(want_params.named_parameters())
    if list(got) != list(spec_params):
        fail("specs: param names differ from init_lm's")
    pairs = [(n, got[n], spec_params[n]) for n in got]
    pairs += [(f"cache/{k}", cache[k], want["cache"][k]) for k in cache]
    pairs.append(("tokens", tokens, want["tokens"]))
    if sorted(cache) != sorted(want["cache"]):
        fail(f"specs: cache leaves {sorted(cache)} vs {sorted(want['cache'])}")
    for name, t, spec in pairs:
        if t.shape != spec.shape or t.dtype != spec.dtype or not spec.is_meta:
            fail(f"specs: {name} allocated {tuple(t.shape)} {t.dtype}, spec "
                 f"{tuple(spec.shape)} {spec.dtype} on {spec.device}")
    nbytes = sum(t.numel() * t.element_size() for _, t, _ in pairs)
    r = dryrun.run_cell("gemma2-2b", cell, cfg=cfg, verbose=False,
                        mesh=AbstractMesh((1, 1), ("data", "model")))
    if r["memory"]["argument_bytes"] != nbytes:
        fail(f"specs: dry run argument_bytes {r['memory']['argument_bytes']}"
             f" != {nbytes} allocated")
    print(f"  specs: {len(pairs)} tensors of serving gemma2-2b (B{B}, cache "
          f"S{S}) match their meta specs in shape and dtype; dry-run "
          f"argument_bytes on a 1x1 mesh {r['memory']['argument_bytes']} = "
          f"their bytes {nbytes}; memory_allocated grew {grown} B")
    del params, cache, tokens
    torch.cuda.empty_cache()


def counts_beside_walls(prefill_ms: float, update_ms: float) -> None:
    """(c) the dry run's counts of gemma2-2b's prefill at phase 4's shape
    (B 8, T 1024 into a cache of S 1089, as timed) and of one PPO update at
    phase 6a's, each over the wall its phase measured: TFLOP/s and the
    share of the card's peak, counted (the reference route's work) and
    ``model_flops`` (which counts the lm_head at every prefill position),
    with ``useful_flops_ratio`` = model_flops / counted."""
    cfg = get_config("gemma2-2b")
    B, T, S = TOOLING["serve"]
    Bt, Tt = TOOLING["train"]
    card = smi()
    for what, cell, wall_ms in (
            (f"prefill (phase 4's B{B} x {T}, cache S{S}, its profile-phase "
             "wall)", ShapeCell("phase4_prefill", T, B, "prefill"),
             prefill_ms),
            (f"PPO update (phase 6a's B{Bt} x {Tt}, its unprofiled wall)",
             ShapeCell("phase6a_train", Tt, Bt, "train"), update_ms)):
        step = dryrun.build_step(cfg, "gemma2_2b", cell, 1)
        if cell.kind == "prefill":
            step.args = (step.args[0], specs.cache_specs(cfg, B, S),
                         *step.args[2:])
        cost, _, _ = dryrun.count_step(step)
        counted = cost["flops"]
        if not (counted > 0 and math.isfinite(counted)):
            fail(f"counts: {what} counted {counted} FLOPs")
        model = dryrun.cell_model_flops(cfg, cell)
        rates = {k: f / (wall_ms / 1e3) / 1e12 for k, f in
                 (("counted", counted), ("model_flops", model))}
        print(f"  counts: gemma2-2b {what}: {counted:.6g} FLOPs counted, "
              f"{model:.6g} model_flops (useful_flops_ratio "
              f"{model / counted:.3f}), wall {wall_ms:.3f} ms: "
              + ", ".join(f"{k} {v:.2f} TFLOP/s ({v * 1e12 / PEAK_FLOPS_BF16:.3f}"
                          " of 989)" for k, v in rates.items())
              + f" ({card})")


def dryrun_cli_check(root: Path) -> None:
    """(d) the dry run's CLI on one cell, as a user runs it."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "gemma2-2b", "--shape", "decode_32k", "--out", str(root / "dr")]
    r = subprocess.run(cmd, capture_output=True, text=True,
                       timeout=TOOLING["timeout"], cwd=REPO)
    ok = [ln for ln in r.stdout.splitlines()
          if ln.startswith("[OK] gemma2_2b") and "decode_32k" in ln]
    if r.returncode != 0 or len(ok) != 1:
        fail(f"dry run CLI: rc {r.returncode}\n{r.stdout[-2000:]}\n"
             f"{r.stderr[-2000:]}")
    print(f"  dry run CLI: {ok[0]}")


def tooling_phase(prefill_ms: float, update_ms: float) -> None:
    """Phase 12b, after the phases whose walls it reads."""
    print("tooling phase: the variant launcher, specs against allocations, "
          "the dry run's counts and CLI")
    t0 = time.perf_counter()
    path = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = str(REPO / "src") + (
        os.pathsep + path if path else "")
    try:
        with tempfile.TemporaryDirectory() as root:
            launcher_check(Path(root))
            specs_check()
            counts_beside_walls(prefill_ms, update_ms)
            dryrun_cli_check(Path(root))
    finally:
        if path is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = path
    print(f"  phase {time.perf_counter() - t0:.1f} s")


def main() -> None:
    laps, mark = {}, [time.perf_counter()]
    t_start = mark[0]

    def lap(name):
        """Charge the wall time since the last lap to phase ``name``."""
        now = time.perf_counter()
        laps[name] = laps.get(name, 0.0) + now - mark[0]
        mark[0] = now

    card = smi()
    print(card)
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        fail(f"compute capability {cap}, the kernels are built for sm_90a")
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    built = build.build()
    print(f"build: {len(built)} librar{'y' if len(built) == 1 else 'ies'} in "
          f"{time.perf_counter() - t0:.1f} s wall")
    for b in built.values():
        print(f"  {b.name}: {b.seconds:.1f} s nvcc; ptxas per entry point:")
        for ln in b.log.splitlines():
            if "Compiling entry function" in ln or "registers" in ln or \
                    "spill" in ln:
                print("   ", ln.replace("ptxas info    : ", "").strip()[:150])
    lap("2 build")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions in
    torch.backends.cudnn.allow_tf32 = False         # full f32
    cfg = get_config("gemma2-2b")
    errs, used, timing = kernel_phase(cfg)
    lap("3 attention")
    ssd_errs, ssd_timing = ssd_kernel_phase()
    lap("3 ssd")
    st_worst, st_timing = sum_tree_kernel_phase()
    lap("3 sum tree")
    inst_errs, inst_timing = instance_phase()
    lap("3b instances")

    with tempfile.TemporaryDirectory() as log_dir:
        inst_launches = smoke_entry_points(log_dir)
        torch.cuda.empty_cache()
        lap("3c smoke entry points")
        print("slice phase: fixed rounds (full-width gemma2-2b, bf16)")
        ops.flash_attention.launches = 0
        ops.flash_attention_decode.launches = 0
        toks = serve.main(["--arch", "gemma2-2b", "--full", "--device",
                           "cuda", "--batch", "8", "--prompt-len", "1024",
                           "--gen", "64", "--rounds", "2", "--seed",
                           str(SEED), "--log-dir", log_dir])
        fixed = {"flash_attn_fwd": ops.flash_attention.launches,
                 "flash_attn_decode": ops.flash_attention_decode.launches}
        print(f"  launches in the fixed rounds: {fixed}")
        if min(fixed.values()) == 0:
            fail(f"a kernel never launched on the fixed rounds: {fixed}")
        if tuple(toks.shape) != (8, 64) or int(toks.min()) < 0 or \
                int(toks.max()) >= cfg.padded_vocab:
            fail(f"fixed rounds: bad tokens {tuple(toks.shape)}")
        torch.cuda.empty_cache()
        params, prompts = served_weights(cfg)
        kernel_vs_ref(cfg, params, prompts, 64)
        print("graph phase: gemma2-2b serving replayed from CUDA graphs "
              "against eager, on the same weights")
        fixed_rounds_graph_check(cfg, params, prompts)
        continuous_graph_check(cfg, params)
        del params, prompts  # drawn again for the profile phase
        torch.cuda.empty_cache()

        print(f"slice phase: continuous batching ({CONT['requests']} "
              f"requests, {CONT['slots']} slots)")
        args = ["--arch", "gemma2-2b", "--full", "--device", "cuda",
                "--continuous", "--seed", str(SEED), "--log-dir", log_dir]
        for key, val in CONT.items():
            args += ["--" + key.replace("_", "-"), str(val)]
        ops.flash_attention.launches = 0
        ops.flash_attention_decode.launches = 0
        summary = serve.main(args)
        cont = {"flash_attn_fwd": ops.flash_attention.launches,
                "flash_attn_decode": ops.flash_attention_decode.launches}
        print(f"  launches in the continuous run: {cont}")
        if min(cont.values()) == 0:
            fail(f"a kernel never launched on the continuous run: {cont}")
        n = CONT["requests"]
        trace = poisson_trace(
            SEED, n, CONT["rate"],
            prompt_len_range=(CONT["prompt_min"], CONT["prompt_len"]),
            max_tokens_range=(CONT["gen_min"], CONT["gen"]), vocab=cfg.vocab)
        want = sum(r.max_tokens for r in trace)
        if summary["n_finished"] != n or summary["generated_tokens"] != want:
            fail(f"continuous: {summary['n_finished']} finished, "
                 f"{summary['generated_tokens']} tokens, expected {n} / {want}")
        print(f"  p50 latency {summary['p50_latency_s']:.4f} s, p99 latency "
              f"{summary['p99_latency_s']:.4f} s, decode "
              f"{summary['decode_tok_per_sec']:.1f} tok/s, every request got "
              "its max_tokens")
        torch.cuda.empty_cache()
        lap("4-5 gemma2 serving")
        for arch in SLICE6:  # the slice's main path first, then the others
            main_path = arch == SLICE6[0]
            for k, v in slice6_serve(arch, log_dir, 2 if main_path else 1,
                                     continuous=main_path).items():
                inst_launches[k] = inst_launches.get(k, 0) + v
        lap("5b slice-6 serving")
        for arch in SLICE7:  # the slice's main path first, then the others
            main_path = arch == SLICE7[0]
            for k, v in slice6_serve(arch, log_dir, 2 if main_path else 1,
                                     continuous=main_path,
                                     run=SERVE7[arch]).items():
                inst_launches[k] = inst_launches.get(k, 0) + v
        lap("5c slice-7 serving")
        got, zamba_training = lm_train_phase("zamba2-7b", TRAIN7, TRAIN7_TOL,
                                             log_dir)
        add_by_instance(inst_launches, get_config("zamba2-7b"), got)
        torch.cuda.empty_cache()
        lap("6b zamba2 training")
        gemma_launches, gemma_training = lm_train_phase(
            "gemma2-2b", GEMMA_TRAIN, GEMMA_TRAIN_TOL, log_dir)
        torch.cuda.empty_cache()
        lap("6a gemma2 training")
        ssm_serve_phase(log_dir)
        torch.cuda.empty_cache()
        lap("5a mamba2 serving")
        got, training = lm_train_phase("mamba2-1.3b", TRAIN, TRAIN_TOL,
                                       log_dir)
        add_by_instance(inst_launches, get_config("mamba2-1.3b"), got)
        torch.cuda.empty_cache()
        lap("6 mamba2 training")
        rl_launches, rl_work = rl_phase(log_dir)
        torch.cuda.empty_cache()
        lap("7 rl")
        pg_work = pg_phase(log_dir)
        torch.cuda.empty_cache()
        lap("8 pg")
        qpg_launches, qpg_work = qpg_phase(log_dir)
        torch.cuda.empty_cache()
        lap("9 qpg")
        r2d1_work = r2d1_phase(log_dir)
        torch.cuda.empty_cache()
        lap("10 r2d1")
        async_work = async_phase(log_dir)
        lap("11 async")
        mesh_launches = mesh_phase()
        torch.cuda.empty_cache()
        lap("11b mesh")
        lm_mesh_launches = lm_mesh_phase()
        add_by_instance(inst_launches, get_config("mamba2-1.3b"),
                        {"ssd_scan": lm_mesh_launches.pop("mamba2 ssd_scan")})
        lap("11c lm mesh")
        tp_launches, tp_inst = lm_tp_phase()
        for k, v in tp_inst.items():
            inst_launches[k] = inst_launches.get(k, 0) + v
        torch.cuda.empty_cache()
        lap("11d lm model axis")
        capture_phase()
        lap("11e nccl capture")

    # last, because the profiler slows every later launch of the process
    print("profile: where the time goes (not the main path's counts)")
    params, prompts = served_weights(cfg)
    serve_walls = profile_phase(cfg, params, prompts)
    del params, prompts
    torch.cuda.empty_cache()
    for arch in (SLICE6[0], SLICE7[0]):
        slice_cfg = slice6_cfg(arch)
        params, prompts = served_weights(slice_cfg)
        profile_phase(slice_cfg, params, prompts)
        del params, prompts
        torch.cuda.empty_cache()
    lap("12 profile serving")
    for spec in (gemma_training, training, zamba_training):
        profile_training(spec)
    profile_ssd()
    profile_rl(rl_work)
    profile_pg(pg_work)
    profile_qpg(qpg_work)
    fn, wall = r2d1_work
    profile_work(f"R2D1 update at full width (batch {R2D1_FULL['batch']} x "
                 f"{R2D1_FULL['seq_len'] + 1}, burn-in 40)", fn, wall,
                 R2D1_FULL["profiled"])
    fn, wall = async_work
    profile_work("async SAC learner update (hidden 64, batch 128)", fn, wall,
                 ASYNC["profile_updates"])
    lap("12 profile training and RL")
    tooling_phase(serve_walls["prefill"], gemma_training[4]["update"])
    lap("12b tooling")
    # the main path is the fixed rounds, the continuous run and the gemma2
    # training run (attention) and the mamba2 training run (ssd_scan); the
    # kernel-vs-ref comparisons between them do not count
    launches = {
        "flash_attn_fwd": fixed["flash_attn_fwd"] + cont["flash_attn_fwd"]
        + gemma_launches["flash_attention"]
        + lm_mesh_launches["flash_attention"]
        + tp_launches["flash_attention"],
        "flash_attn_decode": fixed["flash_attn_decode"]
        + cont["flash_attn_decode"] + gemma_launches["flash_attention_decode"]
        + lm_mesh_launches["flash_attention_decode"]
        + tp_launches["flash_attention_decode"]}
    print(f"attention launches on the main path: {launches} (fixed rounds "
          f"{fixed}, continuous {cont}, gemma2 training {gemma_launches}, "
          f"the LM mesh's ranks {lm_mesh_launches}, the model axis' ranks "
          f"{tp_launches})")
    kernels = []
    for name in ("flash_attn_fwd", "flash_attn_decode"):
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": TPU_KERNEL, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"]})
    # slice 6's instances, each timed at the first config that runs it
    # (instance_phase's order: the slice's main path first)
    print(f"instance launches on the main path: {inst_launches} (smoke "
          "entry points, slice-6 and slice-7 serving, zamba2-7b and "
          "mamba2-1.3b training, the model axis' ranks)")
    primary = {}
    for (name, arch), t in inst_timing.items():
        primary.setdefault(name, (arch, t))
    for name, (arch, t) in sorted(primary.items(), key=lambda kv: (
            kv[0].split()[0], int(kv[0].split()[1][2:]),
            int(kv[0].split()[2][1:]) if len(kv[0].split()) > 2 else 0)):
        if not inst_launches.get(name):
            fail(f"{name} never launched on the main path: {inst_launches}")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": TPU_KERNEL, "launches": inst_launches[name],
            "max_abs_err": inst_errs[name][0], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"]})
        print(f"  {name}: timed at {arch} [{t['shape']}], tolerance used "
              f"{inst_errs[name][1]:.3f}")
    # the SSD instances, launched by the mamba2-1.3b, zamba2-7b and smoke
    # trainings
    for name, t in ssd_timing.items():
        if not inst_launches.get(name):
            fail(f"{name} never launched on the main path: {inst_launches}")
        kernels.append({
            "name": name, "route": "cuda", "source": SSD_SOURCE,
            "replaces": SSD_TPU_KERNEL, "launches": inst_launches[name],
            "max_abs_err": ssd_errs[name][0], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": None})
        print(f"  {name}: {inst_launches[name]} launches, tolerance used "
              f"{ssd_errs[name][1]:.3f}")
    # the main path's shape: the rainbow example's tree (8192 leaves, 64)
    t = st_timing[(8192, 64)]
    rl_launches.update(qpg_launches)
    rl_launches.update(mesh_launches)   # both ranks' launches
    print(f"sum_tree launches on the RL paths: {rl_launches}")
    kernels.append({
        "name": "sum_tree_sample", "route": "cuda", "source": ST_SOURCE,
        "replaces": ST_TPU_KERNEL, "launches": sum(rl_launches.values()),
        "max_abs_err": st_worst, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
        "library_ms": t["library_ms"]})
    print(f"graph walls, eager beside the CUDA graph's replay ({card}; the "
          "busy time and idle share of each are in the profile lines):")
    for path, (eager, graph, unit) in GRAPH_WALLS.items():
        print(f"  {path}: {eager:.3f} ms eager, {graph:.3f} ms graph {unit} "
              f"({eager / graph:.2f}x)")
    print("phase walls: " + ", ".join(f"{k} {v:.1f} s" for k, v in
                                      laps.items())
          + f"; total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
