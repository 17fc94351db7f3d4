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
   PyTorch call computes the scan: library_ms null).  Then the
   sum-tree sampler (``tree_sample_blocked``, csrc/sum_tree.cu) against its
   plain version (``sample_plain``) and the f64 flat oracle on sum trees at
   the rainbow example's shape (8192 leaves, batch 64), the replay bench's
   (2^14, 2^17, 2^20 leaves x 256) and the edges of the kernel's layout
   (``ST_SHAPES``: one block, 2048 and 8192 blocks, batches 1, 5 and 33),
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
   S 449),
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
   phases 4-7, 6a and 9, the largest error of phase 3, times at the
   serving shape; phases 5a, 8, 10 and 11 launch none; one entry an
   instance of phase 3b, its launches from phases 3c, 5b, 5c and 6b, timed
   at the first config that runs it; one entry an SSD instance, its
   launches from phases 3c, 6b and 6), then ``{"ok": true, "device":
   {...}}`` last.
"""
import json
import math
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
# one block, 2048 blocks at the rainbow batch, 8192 blocks, and batches that
# leave a block of four samples part-empty
ST_SHAPES = [(8192, 64), (2 ** 14, 256), (2 ** 17, 256), (2 ** 20, 256),
             (512, 5), (2 ** 20, 64), (2 ** 22, 33), (8192, 1), (8192, 33)]
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
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
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
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import backbones as bb  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.layers import record_routing  # noqa: E402
from repro_torch.models.rl_models import make_pg_mlp, make_recurrent_q  # noqa: E402
from repro_torch.replay.host import SequenceSamples  # noqa: E402
from repro_torch.runners import AsyncRunner, TrainLoop  # noqa: E402
from repro_torch.samplers import SerialSampler  # noqa: E402
from repro_torch.serving import (ContinuousBatchEngine,  # noqa: E402
                                 DEFAULT_BUCKETS, poisson_trace)
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.utils.logger import Logger  # noqa: E402

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


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_BF16_FLOPS):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak
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


def ssd_faulty(x, dt, A, Bm, Cm, chunk, fault=None):
    """ssd_chunked's math (G = 1, T a multiple of chunk) with one fault, for
    the sensitivity checks: 'carry' drops y_off, 'causal' drops the
    diagonal of the mask (q > k), 'dt' leaves dt out of M, 'decay' does not
    decay the state by exp(cum_last)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    S = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device),
                     diagonal=-1 if fault == "causal" else 0)[None, :, :, None]
    ys = []
    for c in range(T // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        xq, dtq = x[:, sl].float(), dt[:, sl]
        Bq, Cq = Bm[:, sl, 0].float(), Cm[:, sl, 0].float()
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
        ys.append(y.to(x.dtype))
    return torch.cat(ys, dim=1), S


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


def st_hold(name, idx, prob, leaves, bsums, u, integer):
    """The kernel's (idx, prob) and sample_plain's against the f64 oracle
    (exact on integer priorities, where kernel == plain bit for bit, the
    rounding rule on real ones); returns prob's max abs error."""
    torch.cuda.synchronize()
    flat = leaves.reshape(-1)
    batch = u.shape[0]
    pidx, pprob = sample_plain(leaves, bsums, u)
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
        [(slice6_cfg(a), SERVE7[a]) for a in SLICE7]
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


def fused_identity(label, make, n):
    """``make()``'s runner (a fresh (runner, params) pair each call) run
    from SEED twice for ``n`` iterations, fused (each iteration a graph
    replay, after each graph's eager warm-up) and unfused: after every
    iteration the train, sampler and replay states, the generators' states
    and the iteration's info bit for bit.  Returns the fused loop's graph
    replays by branch key."""
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

        def run_window(ts, ss, rs, gen, k, inner=inner, fuse=fuse):
            sents = []
            for _ in range(k):
                ts, ss, rs, info, sent = inner(ts, ss, rs, gen, 1)
                sents.append(sent)
                snap = snapshot((ts, ss, rs, gen, info))
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

    # last, because the profiler slows every later launch of the process
    print("profile: where the time goes (not the main path's counts)")
    params, prompts = served_weights(cfg)
    profile_phase(cfg, params, prompts)
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
    # the main path is the fixed rounds, the continuous run and the gemma2
    # training run (attention) and the mamba2 training run (ssd_scan); the
    # kernel-vs-ref comparisons between them do not count
    launches = {
        "flash_attn_fwd": fixed["flash_attn_fwd"] + cont["flash_attn_fwd"]
        + gemma_launches["flash_attention"],
        "flash_attn_decode": fixed["flash_attn_decode"]
        + cont["flash_attn_decode"] + gemma_launches["flash_attention_decode"]}
    print(f"attention launches on the main path: {launches} (fixed rounds "
          f"{fixed}, continuous {cont}, gemma2 training {gemma_launches})")
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
          "mamba2-1.3b training)")
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
