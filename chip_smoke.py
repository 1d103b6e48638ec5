#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py

1. Prints torch, CUDA and driver versions and the card's name and power
   limit (``nvidia-smi --query-gpu=name,power.limit``).
2. Builds every kernel from ``src/repro_torch/kernels/*/csrc`` with
   ``nvcc`` (one process per source, all at once) and prints the seconds.
   Beside them it builds and times a probe, one thread's chain of 2**20
   dependent float32 adds (``ADD_CHAIN_SRC``): its ns per add (CUDA
   events; cycles by ``clock64`` and the SM clock printed beside) price
   the chain bound of K2, K3 and K4.
3. Serving (slice 1). Holds ``lda_gibbs`` and ``lda_l2r`` against their
   plain torch versions (``lda_l2r``: every per-position score [L, B]
   within rtol 1e-5 / atol 1e-6, and the sums over L), and times both
   (median of CUDA-event timings after warm-up), at the paper's node
   shape (K=5, V=1,000, L=32) and at
   every shape the serving path launches at K=100, V=50,000: the G-OEM
   E-step (B=256, L=64, 30 sweeps, Poisson(10) lengths), each bucket's
   mixture slab (B=64, L=16/32/64, 8 sweeps) and "ll" slab (B=64, P=10),
   with each bucket's request lengths. Then runs
   ``repro_torch.launch.serve_topics.main`` at K=100, V=50,000, L=64
   (request lengths uniform in [2, 64], as ``benchmarks/serve_bench.py``
   draws them) twice, the launch counters set to 0 before each and read
   after: closed loop (G-OEM 20 steps at batch 256, then 2,048 requests at
   once, a quarter of them mixtures: the node's capacity), then open loop
   from the saved statistic at 70% of that capacity for p50/p99. Checks,
   from the wrappers' counts by shape, that both kernels launched only
   at held shapes, once per G-OEM step and per slab of each queue, every
   "ll" is finite, mixtures sum to 1 and served "ll" answers equal
   ``evaluate_heldout`` at the bucket length.
4. DELEDA (slice 2, paper §4). Holds every kernel against its plain
   version at every shape the DELEDA phases launch, with the lengths
   those shapes receive (Poisson(10) documents): ``gossip_mix`` exactly
   (max error 0) at [n=50, K=5, V=100] with one pair and at [50, 100,
   50,000] with 25 pairs and one pair; ``lda_gibbs`` at the fused E-steps
   (B = 20 G-OEM, 40 async, 1,000 sync; 30 sweeps) and ``lda_l2r`` (per
   position, as in step 3) at the held-out sets (B = 100, and 3 probe
   nodes x 100 in the loop; P=10), both at the paper's K=5, V=100, L=32
   and at K=100, V=50,000, L=64.
   Then, each with the launch counters set to 0 just before and read just
   after. The wrappers count launches by shape; every launch must fall on
   a held shape, and each shape's count must equal the rule (one
   ``lda_gibbs`` launch per round in which a node updates, one
   ``gossip_mix`` launch per round with a live pair, the ``lda_l2r``
   launches of the eval schedule):
   - the paper's experiment, ``launch.deleda_experiment.run_experiment``
     at ``PAPER`` (n=50, K=5, V=100, 400 steps, G-OEM and {async, sync} x
     {complete, WS}) for seed 0 (``FIG1_SEEDS``): the Fig. 1a/1b
     trajectories, the share of records inside the eq. (3) envelope,
     rounds/s per run, claims C1-C3 per seed and their mean and spread
     over the seeds; each seed's LP* against the LP* of the same seed's
     corpus on the CPU (rel 1e-4: a corpus is drawn on the CPU on every
     device);
   - the scenario sweep (slice 9), ``launch.scenario_bench.main`` at
     ``SCENARIO_PAPER`` (n=50, K=5, V=100, 300 rounds, 10 sweeps) for
     seed 0 (``SCEN_SEEDS``): the six regimes of
     ``core.scenario.SCENARIO_NAMES`` as async matchings on WS, the
     reference's gates (rewiring and drop10 within 10% of static's LP,
     the cold join's tail inside the eq. (3) envelope) and both kill
     drills bit for bit. Before it, every shape is computed on the host
     from the compiled scenarios (the updating nodes m of each round, as
     ``deleda._plan_segment`` plans them) and held: ``lda_gibbs`` at B =
     10 m, ``gossip_mix`` at m/2 pairs of [50, 5, 100], ``lda_l2r`` at
     the evaluator's B=50, P=5. Its launches by shape must equal one K1
     and one K2 per round with a live pair of every run and drill, and 19
     K3 a seed (LP* and three probe nodes a regime). Prints each regime's
     mean and spread over the seeds;
   - full width, ``core.deleda.run_deleda`` at K=100, V=50,000, L=64,
     n=50, batch 20: 40 rounds of sync matchings on the complete graph
     and 40 async edge events on WS, held-out LP every 20 rounds (3 probe
     nodes, 100 documents, P=10). The initial state is built and timed
     apart; a cold run from it is timed, then a counted run repeats it
     bit for bit: rounds/s, peak memory and each kernel's share of that
     run's wall. Then 10 sync rounds from a built state, timed, then
     again under ``torch.profiler``: the card's idle share over that one
     window, kernels per round, the entries with the most device time
     and the host's waits on the card. One scenario at full width
     (``SCEN_FULL``): 40 async edge events on a WS graph rewired every
     10 rounds (per-step degrees), 10% drops, 20% churn, node 49's cold
     join at round 20 and node 7's leave at round 30, LP every 20
     rounds, a record every 10: K1 and K2 once per live event at the
     async run's held shapes, each node's step counter equal to its live
     events, and every node down or not a member through a record's ten
     rounds keeping its row bit for bit; rounds/s, peak memory and
     events by kind.
   - a trajectory check at the golden test's shapes (K=3, V=20, L=8,
     N=8, T=20): the CUDA path against the CPU plain path from the same
     inputs (steps equal, mass rtol 1e-4, probe rtol 3e-3, LP rtol 1e-5),
     in both corpus layouts, and with one compiled scenario (a rewiring,
     drops, churn, a join and a leave) in each schedule kind;
   - the lifecycle (slice 8) at full width: 40 sync matching rounds on
     the complete graph with forgetting (decay (5, 0.8)) on a streamed
     corpus refreshed every 20 rounds, LP every 20, saved every 20
     rounds; the kill (step 40 deleted, an uncommitted step-40 directory
     with only its sidecar left); the run resumed from step 20, which
     must equal the uninterrupted one bit for bit (stats, steps, the last
     record, consensus and LP) and launch what its 20 rounds and one eval
     imply; ``serve_topics --restore-train`` serving node 3 of the
     resumed run's checkpoint (512 requests, closed loop), its statistic
     equal to the run's node 3 and its answers checked as in step 3; and
     at the golden shapes a CPU checkpoint at T/2 resumed on the card,
     against the CPU's uninterrupted run at the trajectory check's
     tolerances. One ``lifecycle`` line: checkpoint bytes, save and
     restore seconds, the stream's segment draw, the resumed rounds/s
     and peak memory, the served req/s and the card.
5. The unique-token (CSR) layout (slice 3). ``lda_sparse`` on counts in
   {0, 1} must give ``lda_gibbs``'s bits. Then the full width at L=256 on
   a Zipf corpus (``launch/sparse_bench``'s: Zipf(2.2) words,
   lognormal(4.4, 0.4) lengths; n=50 x 20 documents, the unique view's
   counts summing to the mask's, U its realized maximum): every shape it
   launches is held first with the documents it receives (``lda_gibbs``
   at the dense fans, ``lda_sparse`` at the unique ones, with 0 tie flips
   allowed, ``lda_l2r`` at the in-loop batch, dense and count-weighted at
   U = L), then ``run_deleda`` runs the 40 rounds of step 4 in each
   layout (rounds/s, the E-step kernel's ms a round, peak memory). Then
   ``launch.sparse_bench.main`` on the card, all three regimes with their
   asserts, every shape it launches held first and its launches checked
   against its calls. The trajectory check of step 4 also runs the unique
   layout (edge events, and matchings with the count-weighted in-loop
   LP).
5a. The Scale layer (slice 10). ``run_deleda`` at the full width (sync
   matchings on the complete graph, 40 rounds, LP every 20) with
   ``vocab_shards=4`` from the state of the same run at ``vocab_shards=1``:
   equal to it bit for bit (stats, LP, consensus), its launches at the
   full-width held shapes, rounds/s and peak memory; then saved every 20
   rounds, killed (step 40 deleted, an uncommitted step-40 directory
   left) and resumed bit for bit. Then ``launch.gossip_sim.run_mesh_deleda``
   in ranks spawned by ``gossip_sim.launch`` (the kernels built by this
   script first; each rank runs 2 warm-up rounds of its mesh, then the
   counted run): at the full width over NCCL with one rank per card (the
   most ranks of ``torch.cuda.device_count()`` that divide n; on one card
   one rank, so no pass crosses ranks), 40 rounds, LP every 20; and over
   gloo, 4 ranks on the one card as a 2 x 2 node x vocab grid, 10 rounds,
   against a flat (2, 1) mesh of 2 ranks (stats within 1e-5, consensus
   rtol 1e-4, the reference's bounds), with each round's exchange, whole
   gossip step and update step timed (card drained around each); the
   grid's trajectory on the card against the CPU at the test shapes (K=3,
   V=24, n=8, 12 rounds, LP every 6). Every shape the ranks launch is
   computed on the host from the matchings (``_route_matching``: K1 at
   each node-device's count of intra-rank pairs) and held first; the
   ranks' launches by shape, summed, must equal it. Prints rounds/s, the
   wire bytes a round (``MeshComm.bytes_per_round``) and peak memory a
   rank. The full-width runs go through ``analysis.collectives.Recorder``
   (their timed windows include its wrappers), and their calls are
   audited (step 6c).
6. The LM slice (the port's fourth): gemma2-2b at full width (d=2304,
   vocab 256,000, random bf16 weights from seed 0), its 26 layers cut
   to 8 (``LM``). ``flash_attention``
   (K5) is held against its plain version at every shape the phase
   launches (bf16 within 3e-2, float32 within 2e-5; and each output
   row's error within ``ROW_TOL`` of that row's size, a limit shown to
   catch a dropped key split or tile, or inputs rounded to bf16, by a
   control at the long shapes) and timed beside its
   bound and a library call (the yardstick, ``_library_kind``: a
   compiled ``flex_attention`` where there is a softcap, as at every
   gemma2 shape, ``scaled_dot_product_attention`` elsewhere; "none"
   with its error if it does not run): serving's decode against
   the cache (B=4, Sq=1, S_max=192) at q_offset 0, 95 and 190, the
   float32 check's forward [4, 128] and decode (S_max=128), the bf16
   prefill at S=8192, the bf16 decode against an S=8192 cache at its
   last 8 positions; each local (window 4096) and global. Each shape
   prints the kernel variant it takes ("wgmma" for the bf16 prefill,
   "decode" for every Sq=1 launch, "fma" for the float32 forward), and
   every counted run below checks the launches by variant too. Then, with
   the counters set to 0 before each and read after:
   ``launch.serve.main`` (``--arch gemma2_2b --full --batch 4
   --prompt-len 128 --gen 64 --layers 8``): 8 x 191 K5 launches, half
   local and
   half global, every one at a held shape; prefill s, decode s, tok/s
   and peak memory. The float32 forward over a [4, 128] prompt against
   the same prompt teacher-forced through ``decode_step`` (rel max error
   of the logits < 2e-3, ``tests/test_decode_consistency.py``'s bound).
   ``forward`` once at B=1, S=8192 in bf16 (8 launches): seconds and
   peak memory, then once more under ``torch.profiler`` (device time by
   kernel). 8 bf16 decode steps against an S=8192 cache of random
   keys and values (8 x 8 launches, the keys split over blocks). Then 8
   decode steps under ``torch.profiler``.
   Then gemma2-9b (d=3584, GQA 16/8, head_dim 256; its 42 layers cut
   to 4; random bf16 weights drawn on the CPU): K5
   held at its decode shapes (B=4, S_max=160, with the compiled
   yardstick) and its float32 check's (``flex_attention`` not compiled
   its yardstick: a compile took minutes), ``launch.serve.main`` at
   B=4, prompt 128, 32 new tokens (4 x 159 K5 launches a kind), and
   the float32 forward against teacher-forced decode at a
   [4, 64] prompt (rel < 2e-3); tok/s, prefill s, peak memory and the
   weight draw's seconds.
6b. The other LM families, each at full width through
   ``launch.serve.generate`` at B=4, prompt 128, 32 new tokens, its bf16
   weights drawn on the card from a seeded CUDA generator (``FAM``,
   ``FAMILY_RUNS``): kimi-k2 at 2 of 61 layers (the dense first layer
   and one MoE layer: 384 experts, top-8, capacity dispatch, a shared
   expert), arctic at 1 of 35 (a dense residual beside 128-expert
   top-2), zamba2-2.7b at 18 of 54 Mamba2 layers (3 of its 9
   shared-attention stages, head_dim 80), xlstm-125m whole, pixtral-12b at 10 of 40 (and
   its forward with 256 image tokens), whisper-small whole (the encoder
   at 1,500 stub frames, non-causal, and 12 cross-attention decodes a
   step against it). K5 is held first at every new shape (non-causal,
   D=80, GQA groups 7, 8, 4) with its bound and library call; each run
   is counted by shape and by variant; tok/s, prefill s, peak memory,
   the weights' draw s and K5's ms are printed. Then each family but
   kimi (whose float32 weights do not fit) checks its float32 forward
   against the same prompt teacher-forced through the cached step at
   full width (rel < 2e-3; arctic with ragged dispatch).
6a. The training slice (PR 23), gemma2-2b at full width:
   a. ``gossip_mix`` (K1) in bfloat16 held exactly against its plain
      version (and the bf16 ``0.5 * (a + b)``) at every [4, ...] leaf
      shape of the stacked 4-node parameter tree with 2 pairs, and on
      the one-value path at [20, 5, 51]; float32 K1 stays held above.
   b. K5 at the training shapes (B=4 and B=2, S=512, H=8/4, D=256,
      bf16 "wgmma", local and global; the trajectory's float32 [2, 64]
      "fma") as every K5 shape, and its gradient (``ref.attention_bwd``,
      torch ops) against ``torch.autograd.grad`` of the plain version
      (``BWD_TOL``), the forward and the backward timed apart.
   c. ``launch.train.main --arch gemma2_2b --full --mode standard``
      (26 layers, AdamW, remat "full", B=4, S=512, 10 steps), counted:
      26 x 2 K5 launches a step by shape and variant, every loss and
      grad norm finite, the loss falling; s/step, tokens/s, peak
      memory; one more step under ``torch.profiler`` (device time in
      K5, the attention backward, the optimizer, other matmuls; the
      card's idle share).
   c2. The sharding slice (slice 16, ``_drive_sharding``), on a
      one-card ``DeviceMesh`` (a one-rank NCCL world): the same train
      step through ``launch.steps.build`` for 3 steps from the state c
      leaves, each loss and grad norm against ``make_train_step`` on a
      copy of that state (bit for bit), K5's
      launches counted by shape as in c; s/step beside c's; one more
      step under ``roofline.StepCounter`` (K5's FLOPs and bytes from its
      launches) and ``roofline.analyze``'s H100 compute and memory
      seconds, a model from datasheet figures, printed beside the
      measured s/step. Then gemma2-2b's decode step through ``build``
      at the serve phase's 8 of 26 layers, B=4, S_max=192, 8 steps,
      its logits against ``make_decode_step``'s (each on its own
      caches; bit for bit), 64 K5 "decode" launches. Beside both, in a process of
      its own on the CPU: ``python -m repro_torch.launch.dryrun --arch
      gemma2_2b --shape train_4k`` (16 x 16 on a fake world of 512),
      its report lines and seconds.
   d. ``train_decentralized`` at full width, depth cut to 2 layers, 4
      gloo ranks sharing the card (one node a rank), H = 2, 3 steps, B=2,
      once each with allreduce and gossip-ring[1]:
      spread 0 after the exact syncs and > 0 after ring[1], the loss
      finite and falling, K5 counted on every rank and no K1 launched
      (no pair inside a rank); s/step, a sync's seconds and bytes beside
      ``collective_bytes_per_sync``, peak memory a rank. The same ranks
      then train xlstm-125m whole (the default arch; exact hypercube,
      B=2, S=256, H=1, 2 steps, ``FDEC``): the loss finite, spread 0,
      no K1 or K5 launched. Then ``sync_tree_sim`` (exact hypercube)
      over a stacked 4-node copy of gemma2's tree on the card: K1's
      launches by shape equal leaves x rounds, and every node ends equal
      bit for bit.
   e. The granite smoke variant in float32, 3 AdamW and 3 Adafactor
      steps on the card and on the CPU from the same params: losses
      rtol 1e-5, params within the CPU tests' AdamW bound; TF32 off.
   f. Every other family the reference trains (``FAMILY_TRAIN``), bf16
      at full width: K5 and its gradient held first at each new shape
      (zamba2's D=80 "fma", whisper's non-causal encoder at 1,500 frames
      and cross-attention against it, its decoder, pixtral's GQA 4 over
      256 image and 256 text tokens, arctic's GQA 7), each with SDPA's
      forward and backward beside it. Then
      zamba2-2.7b whole (AdamW, remat "full", B=4, S=512, 5 steps),
      xlstm-125m whole through ``launch.train.main`` with no ``--arch``
      (the default; 2 steps), whisper-small whole (1,500 stub frames, decoder
      S=256), pixtral at 10 of 40 layers (B=2, 256 stub image tokens
      and S=256) and arctic at 1 of 35 (Adafactor in pieces, B=1,
      S=256, 3 steps), the last four through ``steps.make_train_step``
      on weights drawn on the card; each counted by shape and variant,
      every loss and grad norm finite; s/step, tokens/s, peak memory,
      first and last loss. One more zamba2 step under ``torch.profiler``
      (K5, the attention backward, the Mamba2 blocks' forward and
      recompute, the optimizer, the rest; the idle share). K1 held at
      the stacked 4-node xlstm tree's leaf shapes and dtypes (both
      blocks' of a layer; the sLSTM's are float32) and
      ``sync_tree_sim`` over it. Phase e's trajectory for the xlstm and
      whisper smoke variants (3 AdamW steps) and arctic's (one
      Adafactor step, on the card in pieces of one expert matrix):
      losses rtol 1e-5, the parameters within the CPU tests' split
      bound (``_gate_params``), K5 at whisper's smoke shapes held with
      SDPA's forward and backward beside it.
6c. The analysis layer (slice 15, ``repro_torch.analysis``): the
   single-process rows of ``trace_audit.ENTRY_POINTS`` at the
   reference's audit sizes with the kernels on (K1 and K2 in the DELEDA
   segments, K3 in ``eval_chunk`` and ``serve_slab_ll``, K2 in
   ``serve_slab_mixture``, each checked launched), their temp bytes read
   by the caching allocator's peak against the reference's budgets, and a
   planted dense [K, V] beta that must fail ``temp-budget``; the mesh
   rows (and a planted doc-shaped all_gather that must fail the
   allow-list and the privacy rule) recorded in the 2 x 2 grid's gloo
   ranks of step 5a, where the full-width runs' calls are audited too
   (``_audit_mesh``: no doc-shaped integer payload; the grid's update
   step all-reduces only over the rank's vocab line, two a round, the
   flat mesh's none; the NCCL run has one rank, so no payload collective
   crosses ranks); every inventory against the
   reference's ``tests/golden_collectives.json``; the PRNG checks
   (``analysis.audit.prng_checks``: no key reuse, one batch split in a
   training segment, the eval chunk and both serving slabs bit-equal whole
   and in two chunks) on the card; and a ``CompileCounter`` spanning the
   script (``kernels.common``'s ``ctypes.CDLL`` and ``nvcc`` calls): each
   kernel library loaded once, at most one ``nvcc`` run each. One
   ``analysis`` line, with the phase's seconds.
7. Prints one ``{"kernels": [...]}`` line (each kernel at the shape most
   main-path launches have, and every shape under ``per_shape`` with its
   counted launches; K2's, K3's and K4's shapes also carry ``chain_ms``,
   the bound of their designs, which make a document's draws (K3: a
   particle's steps) one after another: K2 and K4, S x the longest
   document's active positions x K dependent adds; K3, the most K-add
   chains a document's particle makes, E(E+1)/2 for E active positions
   (``_l2r_chain_ms``); each at this run's t_add, beside the bytes and
   operations bound), one line each of serving, DELEDA, unique-layout,
   LM-serving, families, lifecycle, scenario, Scale, training (with the
   sharding phase's numbers under "sharding"), the
   families' training and the analysis numbers with the card, and the
   script's seconds
   (each phase's end is printed as it comes). K5's compiled
   ``flex_attention`` yardstick (the softcap shapes, about 8.5 s of
   compile each) is compiled ahead by one spawned process at the lowest
   priority, from the start and in the LM phases' order
   (``_warm_library``); a hold reads its inductor and Triton caches, and
   compiles itself a shape the process has not reached.
8. Prints the card's name and power limit, then ``{"ok": true, ...}``.

Any failed phase raises and the script exits non-zero. Without a CUDA
device, or without ``src/repro_torch`` beside it (the script copied
alone), it exits 1 before printing any result.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
# int32 ops of one threefry-2x32 block: 20 rounds of add, two shifts, or
# and xor, 17 key-injection adds, 2 xors. They are counted at the float32
# rate: the peak table has no int32 rate (Hopper issues int32 at half
# the float32 lanes, so this part of the bound is optimistic by up to 2x)
CIPHER_OPS = 119
TIE = 1e-6
# The probe that measures t_add, one dependent float32 add, for K2's and
# K4's chain bound: one thread, CHAIN_ADDS adds, its cycles by clock64.
CHAIN_ADDS = 1 << 20
ADD_CHAIN_SRC = r"""
#include <cuda_runtime.h>
__global__ void add_chain(float* out, long long* cycles, int n, float x,
                          float y) {
  float c = out[0];
  const long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < n; i += 2) {
    c = c + x;
    c = c + y;
  }
  const long long t1 = clock64();
  out[0] = c;
  cycles[0] = t1 - t0;
}
extern "C" int run_chain(float* out, long long* cycles, int n, float x,
                         float y, void* stream) {
  add_chain<<<1, 1, 0, (cudaStream_t)stream>>>(out, cycles, n, x, y);
  return (int)cudaGetLastError();
}
"""
SLICE = dict(k=100, v=50_000, l=64)
NODE = dict(k=5, v=1_000, l=32)
TRAIN_STEPS, TRAIN_BATCH = 20, 256
TRAIN_SWEEPS, TRAIN_BURNIN = 30, 15    # the LDAConfig serve_topics builds
MIX_SWEEPS, MIX_BURNIN = 8, 4          # TopicServer's mixture sweeps
PARTICLES = 10
LOAD = 0.7                             # open-loop share of capacity
SERVE_ARGS = ["--topics", "100", "--vocab", "50000", "--doc-len", "64",
              "--train-steps", str(TRAIN_STEPS),
              "--train-batch", str(TRAIN_BATCH), "--requests", "2048",
              "--mixture-frac", "0.25", "--particles", str(PARTICLES),
              "--request-len", "uniform", "--device", "cuda"]
GIBBS_SRC = "src/repro_torch/kernels/lda_gibbs/csrc/lda_gibbs.cu"
L2R_SRC = "src/repro_torch/kernels/lda_l2r/csrc/lda_l2r.cu"
GIBBS_TPU = "src/repro/kernels/lda_gibbs/lda_gibbs.py:47"
L2R_TPU = "src/repro/kernels/lda_l2r/lda_l2r.py:47"
MIX_SRC = "src/repro_torch/kernels/gossip_mix/csrc/gossip_mix.cu"
MIX_TPU = "src/repro/kernels/gossip_mix/gossip_mix.py:26"
# DELEDA at full width: the serving slice's model (K=100, V=50,000, L=64)
# on n=50 nodes of 20 documents, batch 20: 1 GB of statistics
FULL = dict(k=100, v=50_000, l=64, n=50, docs=20, batch=20, rounds=40,
            every=20, n_test=100, probes=3)
FULL_RUNS = (("sync", "matching", "complete"),
             ("async", "edge", "watts_strogatz"))
# the unique-token full width: the same model and network at L=256 on the
# Zipf corpus of launch/sparse_bench, in the dense and the unique layouts
ZFULL = dict(FULL, l=256)
SPARSE_SRC = "src/repro_torch/kernels/lda_sparse/csrc/lda_sparse.cu"
SPARSE_TPU = "src/repro/kernels/lda_sparse/lda_sparse.py:53"
GOLDEN = dict(k=3, v=20, l=8, n=8, t=20)   # tests/test_golden.py's run
# the §4 experiment's seeds, and below the scenario sweep's: one each
# since the Scale phases were added (the script's time; the spread over
# seeds comes from launch.deleda_experiment --seeds and
# launch.scenario_bench --seeds run on their own)
FIG1_SEEDS = (0,)
# the scenario slice: launch/scenario_bench's sweep over these seeds, and
# one scenario at full width (FULL's model and network, async edges) with
# a rewiring WS graph, drops, churn, a cold join and a leave
SCEN_SEEDS = (0,)
SCEN_FULL = dict(segments=4, drop=0.1, churn=0.2, join=(49, 20),
                 leave=(7, 30), record=10)
# the lifecycle phase: FULL's sync run with forgetting (the reference
# tests' decay), a stream refreshed every FULL["every"] rounds, and the
# requests --restore-train serves from node 3
LIFE_DECAY = (5.0, 0.8)
LIFE_REQUESTS = 512
# the LM slice: gemma2-2b at full width served through launch/serve, its
# depth cut from 26 to 8 layers (whole until the script outgrew its time
# limit: the CPU draw of 2.6 B weights alone took 21-26 s), and one
# prefill at S=8192 (the catalog's prefill_32k cut: its [32, 32768,
# 256000] logits alone would be 537 GB in bf16)
LM = dict(arch="gemma2_2b", batch=4, prompt=128, gen=64, seed=0, layers=8)
LM_ARGS = ["--arch", LM["arch"], "--full", "--batch", str(LM["batch"]),
           "--prompt-len", str(LM["prompt"]), "--gen", str(LM["gen"]),
           "--seed", str(LM["seed"]), "--layers", str(LM["layers"]),
           "--device", "cuda"]
PREFILL_S = 8192
LONG_STEPS = 8                 # decode steps against an S=8192 cache
# gemma2-9b served at full width, its depth cut from 42 to 4 layers (the
# training phases need the time), bf16 weights drawn on the CPU, and its
# float32 forward/decode consistency at a short prompt, whose library
# yardstick is flex_attention not compiled (its float32 D=256 compile
# took over 600 s on the H100's host, and its time swung 50x between
# compiles); gemma2-2b's is compiled
LM9 = dict(arch="gemma2_9b", batch=4, prompt=128, gen=32, seed=0,
           f32_prompt=64, layers=4, f32_library="flex_eager")
LM9_ARGS = ["--arch", LM9["arch"], "--full", "--batch", str(LM9["batch"]),
            "--prompt-len", str(LM9["prompt"]), "--gen", str(LM9["gen"]),
            "--seed", str(LM9["seed"]), "--layers", str(LM9["layers"]),
            "--device", "cuda"]
# the families slice: each family served at full width through
# launch.serve.generate at B=4, prompt 128, 32 new tokens, its bf16
# weights drawn on the card from a seeded CUDA generator; depth cut where
# memory forces it (kimi 2 of 61 layers, the dense first one and one MoE
# layer; arctic 1 of 35) or time (pixtral 10 of 40, as gemma2-9b; zamba2
# 18 of 54, 3 whole stages, since it outgrew the time limit: zamba2
# trains whole in phase f); the
# float32 forward against the teacher-forced step over the prompt (arctic
# with ragged dispatch: a forward over B x S tokens drops tokens under
# capacity where a one-token step does not; kimi's float32 weights, 75
# GB, do not fit beside the card's other work and share arctic's code)
FAM = dict(batch=4, prompt=128, gen=32, seed=0, f32_prompt=128)
FAMILY_RUNS = (
    dict(tag="kimi", arch="kimi_k2_1t_a32b", layers=2, f32=None),
    dict(tag="arctic", arch="arctic_480b", layers=1,
         f32=dict(moe_impl="ragged")),
    dict(tag="zamba2", arch="zamba2_2p7b", layers=18, f32={}),
    dict(tag="xlstm", arch="xlstm_125m", layers=None, f32={}),
    dict(tag="pixtral", arch="pixtral_12b", layers=10, f32={}),
    dict(tag="whisper", arch="whisper_small", layers=None, f32={}),
)
# the Scale layer: FULL's sync run with vocab_shards=4 (saved at round
# 20, killed, resumed); run_mesh_deleda at FULL's width over NCCL (one
# rank per card), and over gloo as a 2 x 2 node x vocab grid of ranks on
# one card against a flat (2, 1) mesh of the same seed; each mesh run
# after MESH_WARMUP rounds of the same mesh in the same ranks (a rank's
# first rounds load every CUDA module it uses)
SCALE_SHARDS = 4
MESH_GRID_ROUNDS = 10
MESH_WARMUP = 2
MESH_TIMEOUT_S = 300           # a spawned mesh phase that hangs fails
MESH_TRAJ = dict(k=3, v=24, l=8, n=8, docs=4, batch=2, rounds=12, every=6)
# the analysis layer's mesh rows (repro_torch.analysis.trace_audit), run
# in the 2 x 2 grid's 4 gloo ranks, and the planted doc gather they must
# catch there
ANALYSIS_MESH = ("mesh_local_1d", "mesh_pass_1d", "mesh_pass_2d",
                 "update_step_1d", "grid_estep_2d", "planted_doc_gather")
# the kernels each single-process row must launch on the card
ANALYSIS_KERNELS = {"deleda_scan": ("gossip_mix", "lda_gibbs"),
                    "deleda_scan_sharded": ("gossip_mix", "lda_gibbs"),
                    "eval_chunk": ("lda_l2r",),
                    "serve_slab_ll": ("lda_l2r",),
                    "serve_slab_mixture": ("lda_gibbs",)}
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 dense tensor cores
# K5's library yardstick is SDPA where there is no softcap, and one
# compiled flex_attention a gemma2 (softcap) shape (8.5-15 s of the host's
# compile each): a spawned process at the lowest priority compiles those
# in the LM phases' order from the start, into the inductor and Triton
# caches that the holds then read; nothing waits for it (a hold compiles
# a shape it has not reached yet)
# K5's row check: the RMS over D of the error of one output row (batch,
# query, head) over the RMS of that row of the plain version. A bf16 row
# carries two roundings of its values (under 4e-3); a 512-key split or a
# 64-key tile dropped from 8,192 keys moves some row by over a fifth
ROW_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# the training slice: gemma2-2b at full width and depth in standard mode
# (the cosine schedule warms up over 100 steps: 1e-4 .. 1e-3 here); the
# decentralized run at full width, depth cut to 2 layers (4 until the
# families' training took the time; the 590M embedding sets a node's
# size), 4 gloo ranks on the one card at batch 2 a node, 3 steps (5
# until the script outgrew its time limit: a sync spec's run costs a
# consensus all-reduce and two spreads besides its steps); the float32
# trajectory at the granite smoke width
TRAIN = dict(arch="gemma2_2b", batch=4, seq=512, steps=10)
TRAIN_LR = 1e-2
# gemma2-2b's exact gossip-hypercube run was cut to keep the script in
# its time limit: the same ranks run xlstm-125m's exact hypercube (FDEC)
DEC = dict(layers=2, nodes=4, local_steps=2, steps=3, batch=2,
           syncs=("allreduce", "gossip-ring[1]"))
DEC_TIMEOUT_S = 600
TRAJ = dict(arch="granite_3_8b", batch=2, seq=64, steps=3)
TRAJ_LR = 1e-2
# the families' training: each family the reference trains, at
# full width in bf16, its weights drawn on the card from a seeded CUDA
# generator (xlstm-125m, the reference's default arch, through
# launch.train.main, whose CPU draw is a second at 125M parameters; the
# rest through launch.steps.make_train_step, as train_standard steps it);
# zamba2, xlstm and whisper whole, pixtral at 10 of 40 layers (as it
# serves), arctic at 1 of 35 (27.9 GB of weights and as much of
# gradients: kimi's 2 layers, 37.8 GB of weights, do not fit with their
# gradients); S a multiple of ssd_chunk and xlstm_chunk (256); whisper's
# 1,500 stub frames, pixtral's 256 stub image tokens before its text
FTRAIN_LR = 1e-2
FAMILY_TRAIN = (
    dict(tag="zamba2", arch="zamba2_2p7b", layers=None, batch=4, seq=512,
         steps=5),
    dict(tag="xlstm", arch="xlstm_125m", layers=None, batch=4, seq=512,
         steps=2),
    dict(tag="whisper", arch="whisper_small", layers=None, batch=4,
         seq=256, steps=5),
    dict(tag="pixtral", arch="pixtral_12b", layers=10, batch=2, seq=256,
         steps=5),
    dict(tag="arctic", arch="arctic_480b", layers=1, batch=1, seq=256,
         steps=3),
)
# xlstm-125m decentralized, in phase d's ranks after gemma2-2b's runs:
# exact hypercube, B=2 a node at S=256, H=1, 2 steps (its sLSTM is a loop
# over time on the host: 5.5-8.1 s a step at B=4, S=512 in one process on
# the H100, and the ranks share the host's 8 cores; xlstm trains 2 steps
# in phase f too, both cut from 5 to keep the script in its time limit)
FDEC = dict(nodes=4, local_steps=1, steps=2, batch=2, seq=256,
            sync="gossip-hypercube")
# phase e's float32 trajectory also trains these smoke variants (whisper
# at 48 stub frames, so its encoder and cross-attention shapes differ;
# arctic one Adafactor step, on the card with CHUNK cut below one expert
# matrix, so each expert leaf is updated a matrix at a time in two
# passes, against the CPU's one piece a leaf)
TRAJ_FAMILIES = (dict(arch="xlstm_125m", frames=None, steps=TRAJ["steps"]),
                 dict(arch="whisper_small", frames=48, steps=TRAJ["steps"]),
                 dict(arch="arctic_480b", frames=None, steps=1, chunk=1000))
# a gradient element is resolved where it is at least this share of its
# leaf's max |g| on the CPU (``tests/test_torch_train_families.py``)
GRAD_REL = 1e-4
# the attention backward against autograd of the plain version, of each
# tensor's max (``_hold_train_attention``)
BWD_TOL = {torch.bfloat16: 1e-2, torch.float32: 2e-5}
FLASH_SRC = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_TPU = "src/repro/kernels/flash_attention/flash_attention.py:90"


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def _inputs(rt, dev, case, k, v, seed):
    """Likelihood rows of the case's words under a random statistic.

    ``case["docs"]`` = (words, weights) are the documents a phase gives
    the kernel (a 0/1 mask, or the unique layout's counts). Otherwise the
    words are random and the lengths follow ``case["lengths"]``:
    ("poisson", lo, hi) is Poisson(10) clipped to [lo, hi] (the training
    corpus), ("uniform", lo, hi) uniform in [lo, hi] (the requests a
    bucket admits); ``full_first`` makes the first document ``hi`` long.
    """
    b, l, s = case["b"], case["l"], case.get("s", 1)
    g = torch.Generator(device=dev).manual_seed(seed)
    stats = torch.rand((k, v), generator=g, device=dev)
    if "docs" in case:
        words, mask = case["docs"]
        if tuple(words.shape) != (b, l):
            raise AssertionError(f"held documents {tuple(words.shape)} are "
                                 f"not the case's [{b}, {l}]")
    else:
        kind, lo, hi = case["lengths"]
        words = torch.randint(0, v, (b, l), generator=g, device=dev)
        if kind == "poisson":
            lengths = torch.clamp(torch.poisson(
                torch.full((b,), 10.0, device=dev), generator=g), lo, hi)
        else:
            lengths = torch.randint(lo, hi + 1, (b,), generator=g,
                                    device=dev)
        if case.get("full_first"):
            lengths[0] = hi
        mask = torch.arange(l, device=dev)[None, :] < lengths[:, None]
    beta_w = rt.estep.beta_w_from_stats(stats, words, 1e-2)
    uniforms = torch.rand((s, b, l), generator=g, device=dev)
    z0 = torch.randint(0, k, (b, l), generator=g, device=dev)
    return words, beta_w, mask.float(), uniforms, z0


def _time_ms(fn, reps: int, warmup: int = 1, device_only: bool = False):
    """Median CUDA-event milliseconds of ``fn`` and its last output.

    ``device_only`` (a kernel's one launch): the card first spins for
    about 2.5 ms (``torch.cuda._sleep``) while the host enqueues the start
    event, the wrapper's launch and the stop event, so the interval is the
    kernel's device time without the wrapper's host work (argument checks
    and the ctypes call, tens of microseconds). A plain version, thousands
    of launches issued by the host, is timed as it runs.
    """
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(5_000_000)
        start.record()
        out = fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times), out


def _bound(bytes_moved: float, ops: float,
           ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _chain_ms(rt, s, longest, k):
    """The chain bound of K2 / K4, whose design makes a document's draws
    one after another: ``s`` draws of each of the longest document's
    ``longest`` active positions (or slots), each ``k`` dependent float32
    adds in the plain version's association, at this run's t_add. A
    design that began a draw's running sum before the draw ahead of it
    ended could go below it."""
    return s * longest * k * rt.t_add_ns * 1e-6


def _l2r_chain_ms(rt, weights, k):
    """The chain bound of K3, whose design makes a particle's steps one
    after another, each ``k`` dependent float32 adds in the plain
    version's association, at this run's t_add. A document makes, at every
    position n up to its last weighted one, one chain for each weighted
    position before n (its resample) and, where n is weighted, one more
    (the draw of z_n; the score's p_w sum runs beside it). A weight-0 slot
    is never resampled and draws nothing, but the positions before it
    still resample there, as in the plain version. Without such a slot
    inside the document, E weighted positions make E(E+1)/2 chains. The
    bound is the largest count over the documents (``weights`` [B, L])."""
    act = (weights > 0).long()
    before = torch.cumsum(act, -1) - act          # weighted i < n
    n = torch.arange(act.shape[-1], device=act.device)
    last = torch.where(act > 0, n, -1).max(-1).values   # -1: none
    steps = (before * (n <= last[:, None])).sum(-1) + act.sum(-1)
    return float(steps.max()) * k * rt.t_add_ns * 1e-6


def _start_add_chain(rt):
    """Starts nvcc on the t_add probe; returns the process and library."""
    out = rt.common.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "add_chain.cu", out / f"add_chain.{os.getpid()}.so"
    src.write_text(ADD_CHAIN_SRC)
    proc = subprocess.Popen(
        [rt.common._nvcc(), *rt.common.NVCC_FLAGS, "-o", str(lib),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return proc, lib


def _time_add(rt, dev, proc, lib_path):
    """ns (CUDA events) and cycles (clock64) of one dependent float32 add,
    the SM clock read before and after; sets ``rt.t_add_ns``."""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the add-chain probe:\n{log}")
    lib = ctypes.CDLL(str(lib_path))
    out = torch.ones(1, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)

    def run():
        err = lib.run_chain(
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(cycles.data_ptr()), ctypes.c_int(CHAIN_ADDS),
            ctypes.c_float(1e-7), ctypes.c_float(-1e-7),
            ctypes.c_void_p(rt.common.stream_ptr()))
        rt.common.check(err, "add_chain")

    before = _smi("clocks.sm,clocks.max.sm")
    ms, _ = _time_ms(run, reps=7, warmup=2, device_only=True)
    after = _smi("clocks.sm,clocks.max.sm")
    lib_path.unlink()
    cyc = int(cycles.item()) / CHAIN_ADDS
    rt.t_add_ns = ms * 1e6 / CHAIN_ADDS
    if not 0.5 < rt.t_add_ns < 20:
        raise AssertionError(f"t_add {rt.t_add_ns} ns is not a float32 add")
    print(f"t_add, one dependent float32 add ({CHAIN_ADDS} in one thread): "
          f"{rt.t_add_ns:.4f} ns (CUDA events), {cyc:.3f} cycles (clock64) "
          f"= {cyc / rt.t_add_ns:.3f} GHz; SM clock before [{before}] "
          f"after [{after}] | {rt.card}", flush=True)


def _gibbs_bound(b, l, k, s, burnin, active):
    """Bytes and operations the sweeps need for ``active`` tokens.

    Reads beta_w rows and uniforms of active positions only (a masked
    position is skipped), the mask and z0 in full; writes per_pos, z and
    ndk_mean in full. Per active draw: probs (2K), total (K), running sum
    and compare (2K); kept sweeps add the Rao-Blackwell divide, multiply
    and add (3K); the final scaling of per_pos 2K per active position,
    the kept n_dk sums K per document and kept sweep.
    """
    n_keep = s - burnin
    bytes_moved = 4 * (active * k + s * active + 2 * b * l     # in
                       + b * l * k + b * l + b * k)            # out
    ops = (active * (s * 5 * k + n_keep * 3 * k + 2 * k)
           + b * k * (n_keep + 1))
    return _bound(bytes_moved, ops)


def _l2r_bound(b, l, k, p, lens):
    """Bytes and operations the left-to-right estimator needs.

    Reads the two key words per document, beta_w rows of active
    positions and the mask; writes the [L, B] scores. Per particle: each
    of the sum(n(n-1)/2) resample steps is probs (2K), total (K),
    running sum and compare (2K) and one cipher; each active position
    scores (5K) and draws z_n (5K, one cipher). Per document and active
    position: fold_in and split (3 ciphers), the particle mean and log.
    """
    active = float(lens.sum())
    steps = float((lens * (lens - 1) / 2).sum())
    bytes_moved = 8 * b + 4 * (active * k + b * l + l * b)
    ops = (p * (steps * (5 * k + CIPHER_OPS) + active * (10 * k + CIPHER_OPS))
           + active * (3 * CIPHER_OPS + p + 1))
    return _bound(bytes_moved, ops)


def _hold_gibbs(rt, dev, case, k, v, seed):
    """The kernel against its plain version at one shape, and their times."""
    b, l, s, burnin = case["b"], case["l"], case["s"], case["burnin"]
    _w, bw, mf, u, z0 = _inputs(rt, dev, case, k, v, seed)
    kw = dict(alpha=0.5, n_sweeps=s, burnin=burnin)
    plain_ms, want = _time_ms(
        lambda: rt.estep.gibbs_sweeps_dense(bw, mf, u, z0, **kw),
        reps=1, warmup=0)
    ms, got = _time_ms(lambda: rt.gibbs_ops.gibbs_sweeps(bw, mf, u, z0, **kw),
                       reps=7, device_only=True)
    bad = torch.zeros(b, dtype=torch.bool, device=dev)
    for g, w in zip(got, want):
        close = torch.isclose(g.double(), w.double(), rtol=1e-5, atol=1e-6)
        bad |= ~close.reshape(b, -1).all(-1)
    flips = int(bad.sum())
    active = int(mf.sum())
    chain = _chain_ms(rt, s, int((mf != 0).sum(-1).max()), k)
    if flips:
        margins = rt.estep.gibbs_tie_margins(
            bw[bad], mf[bad], u[:, bad], z0[bad], alpha=0.5, n_sweeps=s)
        if flips * 10_000 > active * s or bool((margins > TIE).any()):
            raise AssertionError(
                f"lda_gibbs disagrees with its plain version beyond ties at "
                f"K={k} {case}: {flips} documents, margins "
                f"{margins.tolist()}")
    err = max(float((g.double() - w.double())[~bad].abs().max())
              for g, w in zip(got, want))
    bound, by = _gibbs_bound(b, l, k, s, burnin, active)
    shape = f"B={b} L={l} K={k} S={s}"
    print(f"lda_gibbs vs plain at {shape}: max_abs_err {err:.3g}, tie flips "
          f"{flips} in {active * s} draws; {ms:.4f} ms (plain "
          f"{plain_ms:.3f} ms, bound {bound:.5f} ms by {by}, chain "
          f"{chain:.4f} ms) | {rt.card}", flush=True)
    return dict(name="lda_gibbs", key=(b, l, k, s), shape=shape, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                chain_ms=chain, active_tokens=active, max_abs_err=err,
                tie_flips=flips, launches=0)


def _hold_l2r(rt, dev, case, k, v, seed):
    """The kernel against its plain version at one shape, and their times.

    Every per-position score [L, B] within rtol 1e-5 / atol 1e-6 (a flipped
    draw moves every later score of its particle), and the sums over L
    within rtol 1e-5. ``case["cw"]``: the count-weighted mode (weights are
    counts)."""
    b, l, p, cw = case["b"], case["l"], case["p"], case.get("cw", False)
    _w, bw, mf, _u, _z = _inputs(rt, dev, case, k, v, seed)
    kd = rt.tf3.fold_in_data(rt.tf3.key(seed, dev),
                             torch.arange(b, device=dev))
    plain_ms, want = _time_ms(
        lambda: rt.evaluation.l2r_position_scores(kd, bw, mf, 0.5, p, cw),
        reps=1, warmup=0)
    ms, got = _time_ms(
        lambda: rt.l2r_ops.l2r_scores(kd, bw, mf, 0.5, n_particles=p,
                                      count_weighted=cw),
        reps=7, device_only=True)
    shape = f"B={b} L={l} K={k} P={p}" + (" count-weighted" if cw else "")
    close = torch.isclose(got.double(), want.double(), rtol=1e-5, atol=1e-6)
    bad = torch.nonzero(~close.all(0)).flatten()
    if len(bad):
        raise AssertionError(
            f"lda_l2r disagrees with its plain version per position at "
            f"{shape}: {len(bad)} documents, first {bad[:8].tolist()}, max "
            f"abs err {float((got - want).abs().max()):.3g}")
    torch.testing.assert_close(rt.evaluation._sum_positions(got),
                               rt.evaluation._sum_positions(want),
                               rtol=1e-5, atol=0)
    err = float((got - want).abs().max())
    lens = (mf > 0).sum(-1).double()
    bound, by = _l2r_bound(b, l, k, p, lens)
    chain = _l2r_chain_ms(rt, mf, k)
    print(f"lda_l2r vs plain at {shape}: per-position max_abs_err "
          f"{err:.3g}; {ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
          f"{bound:.5f} ms by {by}, chain {chain:.4f} ms) | {rt.card}",
          flush=True)
    return dict(name="lda_l2r", key=(b, l, k, p, cw), shape=shape, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                chain_ms=chain, active_tokens=int(lens.sum()),
                max_abs_err=err, launches=0)


def _sparse_bound(b, u, k, s, burnin, active):
    """Bytes and operations the count-weighted sweeps need for ``active``
    slots (count > 0; a padding slot is skipped).

    Reads beta_w rows and uniforms of active slots, the counts and z0 in
    full; writes per_unique, m and ndk_mean. Per active draw, as
    ``_gibbs_bound``: 5K, and 3K more in kept sweeps; the final scaling
    of per_unique 2K per active slot, the kept n_dk sums K per document
    and kept sweep.
    """
    n_keep = s - burnin
    bytes_moved = 4 * (active * k + s * active + 2 * b * u      # in
                       + 2 * b * u * k + b * k)                 # out
    ops = (active * (s * 5 * k + n_keep * 3 * k + 2 * k)
           + b * k * (n_keep + 1))
    return _bound(bytes_moved, ops)


def _hold_sparse(rt, dev, case, k, v, seed):
    """K4 against its plain version at one shape, with the phase's own
    documents (``case["docs"]``: slot ids and counts), and their times.
    Every draw must agree: the two share one association (0 tie flips)."""
    b, u, s, burnin = case["b"], case["l"], case["s"], case["burnin"]
    _w, bw, cf, un, z0 = _inputs(rt, dev, case, k, v, seed)
    kw = dict(alpha=0.5, n_sweeps=s, burnin=burnin)
    plain_ms, want = _time_ms(
        lambda: rt.estep.gibbs_sweeps_sparse(bw, cf, un, z0, **kw),
        reps=1, warmup=0)
    ms, got = _time_ms(lambda: rt.sparse_ops.sparse_sweeps(bw, cf, un, z0,
                                                           **kw),
                       reps=7, device_only=True)
    flips = int((got[1] != want[1]).reshape(b, -1).any(-1).sum())
    active = int((cf > 0).sum())
    chain = _chain_ms(rt, s, int((cf != 0).sum(-1).max()), k)
    if flips:
        raise AssertionError(f"lda_sparse draws differ from its plain "
                             f"version in {flips} documents at {case}")
    for g, w in (got[0], want[0]), (got[2], want[2]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    err = max(float((g.double() - w.double()).abs().max())
              for g, w in zip(got, want))
    bound, by = _sparse_bound(b, u, k, s, burnin, active)
    shape = f"B={b} U={u} K={k} S={s}"
    print(f"lda_sparse vs plain at {shape}: max_abs_err {err:.3g}, tie "
          f"flips {flips} in {active * s} draws; {ms:.4f} ms (plain "
          f"{plain_ms:.3f} ms, bound {bound:.5f} ms by {by}, chain "
          f"{chain:.4f} ms) | {rt.card}", flush=True)
    return dict(name="lda_sparse", key=(b, u, k, s), shape=shape, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                chain_ms=chain, active_tokens=active, max_abs_err=err,
                tie_flips=flips, launches=0)


def _main_path_cases(rt):
    """Every kernel shape the main path launches, keyed for its counts.

    ``queue`` is the TopicServer queue a slab shape serves, or "train"
    for the G-OEM E-step.
    """
    k, l = SLICE["k"], SLICE["l"]
    cases = [("lda_gibbs", dict(queue="train", b=TRAIN_BATCH, l=l,
                                s=TRAIN_SWEEPS, burnin=TRAIN_BURNIN,
                                lengths=("poisson", 2, l)))]
    lo = 2
    for lb in rt.serving.make_buckets(l, 3):
        c = min(64, rt.evaluation.auto_chunk_docs(10 ** 9, lb, PARTICLES, k))
        cases.append(("lda_gibbs", dict(queue=(lb, "mixture"), b=c, l=lb,
                                        s=MIX_SWEEPS, burnin=MIX_BURNIN,
                                        lengths=("uniform", lo, lb))))
        cases.append(("lda_l2r", dict(queue=(lb, "ll"), b=c, l=lb,
                                      p=PARTICLES,
                                      lengths=("uniform", lo, lb))))
        lo = lb + 1
    return cases


def _check_served(rt, summary, dev):
    results = summary["results"]
    lls = [r for r in results if r.kind == "ll"]
    mixes = [r for r in results if r.kind == "mixture"]
    if not lls or not mixes:
        raise AssertionError("the request stream lacked a query kind")
    if not all(np.isfinite(r.value) for r in lls):
        raise AssertionError("a served ll is not finite")
    for r in mixes:
        if abs(float(np.sum(r.value)) - 1.0) > 1e-5:
            raise AssertionError(f"mixture of doc {r.doc_id} sums to "
                                 f"{np.sum(r.value)}")
    server, sstate = summary["server"], summary["serving_state"]
    corpus, cfg = summary["corpus"], summary["config"]
    sample = {}
    for r in lls:
        sample.setdefault((r.bucket, r.doc_id), r)
    sample = list(sample.values())[:48]
    test_words = corpus.test_words.cpu().numpy()
    test_lens = corpus.test_mask.cpu().numpy().sum(-1)
    for lb in server.buckets:
        rows = [r for r in sample if r.bucket == lb]
        if not rows:
            continue
        n = max(r.doc_id for r in rows) + 1
        words = np.zeros((n, lb), np.int64)
        mask = np.zeros((n, lb), bool)
        for r in rows:
            m = int(test_lens[r.doc_id])
            words[r.doc_id, :m] = test_words[r.doc_id, :m]
            mask[r.doc_id, :m] = True
        want = rt.evaluation.evaluate_heldout(
            server.key, torch.from_numpy(words).to(dev),
            torch.from_numpy(mask).to(dev), beta=sstate.beta(),
            alpha=cfg.alpha, n_particles=server.n_particles,
            chunk_docs=server.slab_docs[lb]).cpu().numpy()
        for r in rows:
            if r.value != float(want[r.doc_id]):
                raise AssertionError(
                    f"served ll of doc {r.doc_id} ({r.value}) != "
                    f"evaluate_heldout ({want[r.doc_id]}) at L={lb}")
    print(f"served answers checked: {len(lls)} ll finite, {len(mixes)} "
          f"mixtures sum to 1, {len(sample)} ll == evaluate_heldout",
          flush=True)


def _tally(rt, rows, where):
    """Adds one run's launches, as the wrappers counted them by shape, to
    the held rows of that shape; fails on a launch at a shape no row
    holds. Returns this run's launches per row phase."""
    by_key = {(r["name"], r["key"]): r for r in rows}
    if len(by_key) != len(rows):
        raise AssertionError(f"{where}: two held rows share a shape")
    got = {}
    for (name, key), n in rt.by_shape().items():
        row = by_key.get((name, key))
        if row is None:
            raise AssertionError(f"{where}: {name} launched {n} times at "
                                 f"{key}, a shape no row holds")
        row["launches"] += n
        got[row["phase"]] = n
    return got


def _check_phases(where, got, want):
    """The measured launches per held shape against the rule-derived."""
    want = {ph: n for ph, n in want.items() if n}
    if got != want:
        raise AssertionError(f"{where}: launches by shape {got}, the "
                             f"rounds and the eval schedule say {want}")
    print(f"{where}: launches by shape {got}, as the rounds and evals "
          f"imply", flush=True)


def _drive(rt, dev, argv, cases, rows, trained):
    """One main-path run with the launch counters set to 0 just before.

    Adds its launches by shape to ``rows`` and checks them against the
    G-OEM steps and the slabs per queue. Returns its summary.
    """
    rt.zero_counts()
    summary = rt.serve_topics.main(argv)
    torch.cuda.synchronize()
    launches = rt.counts()
    if launches.pop("gossip_mix") != 0 or launches.pop("lda_sparse") != 0:
        raise AssertionError("serving launched gossip_mix or lda_sparse")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel did not run on the main path: "
                             f"{launches}")
    got = _tally(rt, rows, "serving")
    server = summary["server"]
    want = {}
    for (_name, case), row in zip(cases, rows):
        if case["queue"] == "train":
            want[row["phase"]] = TRAIN_STEPS if trained else 0
            continue
        lb = case["queue"][0]
        if server.slab_docs[lb] != case["b"]:
            raise AssertionError(f"slab of bucket {lb} holds "
                                 f"{server.slab_docs[lb]} documents, the "
                                 f"measured shape {case['b']}")
        want[row["phase"]] = server.slabs_by_queue[case["queue"]]
    _check_phases("serving" + (" (trained)" if trained else ""), got, want)
    _check_served(rt, summary, dev)
    return summary


class _Port:
    """The port's modules, imported once the checkout is on the path."""

    def __init__(self):
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch import checkpoint
        from repro_torch.core import comm, deleda, estep, evaluation, graph
        from repro_torch.core import scenario, serving
        from repro_torch.core import lda
        from repro_torch.core import threefry as tf3
        from repro_torch.data import lda_synthetic
        from repro_torch.kernels import common
        from repro_torch.kernels.gossip_mix import ops as mix_ops
        from repro_torch.kernels.gossip_mix import ref as mix_ref
        from repro_torch.kernels.lda_gibbs import ops as gibbs_ops
        from repro_torch.kernels.lda_l2r import ops as l2r_ops
        from repro_torch.kernels.lda_sparse import ops as sparse_ops
        from repro_torch.launch import (deleda_experiment, scenario_bench,
                                        serve_topics, sparse_bench)
        from repro_torch.configs import get_config
        from repro_torch.kernels.flash_attention import ops as flash_ops
        from repro_torch.kernels.flash_attention import ref as flash_ref
        from repro_torch.launch import serve as lm_serve
        from repro_torch.models import encdec, frontends
        from repro_torch.models import transformer as lm
        from repro_torch import convert
        from repro_torch.configs import smoke_variant
        from repro_torch.core import decentralized
        from repro_torch.data.lm_pipeline import TokenPipeline
        from repro_torch.launch import mesh, steps, train
        from repro_torch.optim import make_lr_schedule
        from repro_torch.analysis import audit as analysis_audit
        from repro_torch.analysis import collectives, trace_audit
        from repro_torch import roofline
        from repro_torch.configs import InputShape
        self.estep, self.evaluation, self.tf3 = estep, evaluation, tf3
        self.serving, self.deleda, self.graph, self.lda = (serving, deleda,
                                                           graph, lda)
        self.data, self.comm, self.checkpoint = lda_synthetic, comm, checkpoint
        self.common, self.gibbs_ops, self.l2r_ops = common, gibbs_ops, l2r_ops
        self.mix_ops, self.mix_ref = mix_ops, mix_ref
        self.sparse_ops, self.sparse_bench = sparse_ops, sparse_bench
        self.serve_topics, self.experiment = serve_topics, deleda_experiment
        self.scenario, self.scenario_bench = scenario, scenario_bench
        self.ops = {"gossip_mix": mix_ops, "lda_gibbs": gibbs_ops,
                    "lda_l2r": l2r_ops, "lda_sparse": sparse_ops}
        # the LM slice's kernel, counted apart from the LDA paths' four
        self.flash_ops, self.flash_ref = flash_ops, flash_ref
        self.lm, self.lm_serve, self.get_config = lm, lm_serve, get_config
        self.encdec, self.frontends = encdec, frontends   # the families
        self.flex = None      # compiled flex_attention, the K5 yardstick
        # the training slice
        self.train, self.steps, self.dec, self.mesh = (train, steps,
                                                       decentralized, mesh)
        self.convert, self.smoke, self.pipeline = (convert, smoke_variant,
                                                   TokenPipeline)
        self.schedule = make_lr_schedule
        # the analysis layer (slice 15)
        self.audit, self.trace_audit = analysis_audit, trace_audit
        self.collectives = collectives
        # the sharding slice (slice 16)
        self.roofline, self.input_shape = roofline, InputShape

        self.card = ""        # the card's name and power limit, for prints
        self.t_add_ns = 0.0   # one dependent float32 add (the chain bound)

    def zero_counts(self) -> None:
        for op in (*self.ops.values(), self.flash_ops):
            op.launches = 0
            op.launches_by_shape.clear()
        self.flash_ops.launches_by_variant.clear()

    def counts(self) -> dict:
        return {name: op.launches for name, op in self.ops.items()}

    def by_shape(self) -> dict:
        return {(name, key): n for name, op in self.ops.items()
                for key, n in op.launches_by_shape.items()}


def _mix_partners(n, pairs, seed):
    """An involution of n nodes with ``pairs`` random matched pairs."""
    order = np.random.default_rng(seed).permutation(n)
    p = np.arange(n)
    p[order[0:2 * pairs:2]] = order[1:2 * pairs:2]
    p[order[1:2 * pairs:2]] = order[0:2 * pairs:2]
    return p


def _hold_mix(rt, dev, case, seed):
    """gossip_mix against its plain version (exact), and their times.

    Bound: two rows read and two written per pair, 4 * pairs * K * V
    floats at 3.35 TB/s (one add and one multiply per element pair at the
    float32 rate is far below it).
    """
    n, k, v, pairs = case["n"], case["k"], case["v"], case["pairs"]
    g = torch.Generator(device=dev).manual_seed(seed)
    stats = torch.rand((n, k, v), generator=g, device=dev)
    partners = _mix_partners(n, pairs, seed)
    plan = rt.mix_ops.pairs_of(partners)
    plain_ms, want = _time_ms(
        lambda: rt.mix_ref.mix_matching_ref(stats, partners), reps=5)
    got = rt.mix_ops.mix_pairs_(stats.clone(), plan)
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"gossip_mix differs from its plain version "
                             f"at {case}: max error {err}")
    del got, want
    work = stats.clone()
    ms, _ = _time_ms(lambda: rt.mix_ops.mix_pairs_(work, plan), reps=20,
                     warmup=2, device_only=True)
    bound, by = _bound(4 * pairs * k * v * 4, 2 * pairs * k * v)
    shape = f"n={n} K={k} V={v} pairs={pairs}"
    print(f"gossip_mix vs plain at {shape}: max_abs_err {err:.3g}; "
          f"{ms:.4f} ms (plain {plain_ms:.4f} ms, bound {bound:.5f} ms by "
          f"{by}) | {rt.card}", flush=True)
    return dict(name="gossip_mix", key=(n, k, v, pairs), shape=shape, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                max_abs_err=err, launches=0)


def _check_mix_scalar(rt, dev):
    """The kernel's one-float path (a row not a multiple of 4 floats),
    which no main-path shape takes: exact against the plain version."""
    g = torch.Generator(device=dev).manual_seed(5)
    stats = torch.rand((20, 5, 51), generator=g, device=dev)
    partners = _mix_partners(20, 7, 5)
    want = rt.mix_ref.mix_matching_ref(stats, partners)
    got = rt.mix_ops.mix_pairs_(stats.clone(), rt.mix_ops.pairs_of(partners))
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"gossip_mix (one-float path) differs from its "
                             f"plain version: max error {err}")
    print("gossip_mix one-float path (n=20 K=5 V=51, 7 pairs): equal to "
          "plain", flush=True)
    return err


def _deleda_cases(rt):
    """Every kernel shape the DELEDA phases launch, named by the phase
    that launches it (its launches are the wrappers' counts at its shape,
    added by ``_tally`` after each run)."""
    p = rt.experiment.PAPER
    pk, pv, pl = p.lda.n_topics, p.lda.vocab_size, p.lda.doc_len_max
    n, b, s = p.corpus.n_nodes, p.batch_size, p.lda.n_gibbs
    burn, parts = p.lda.n_gibbs_burnin, p.n_particles
    f = FULL
    paper_len, full_len = ("poisson", 2, pl), ("poisson", 2, f["l"])
    return [
        ("gossip_mix", "paper_mix", dict(n=n, k=pk, v=pv, pairs=1)),
        ("gossip_mix", "full_sync_mix", dict(n=f["n"], k=f["k"], v=f["v"],
                                             pairs=f["n"] // 2)),
        ("gossip_mix", "full_async_mix", dict(n=f["n"], k=f["k"], v=f["v"],
                                              pairs=1)),
        ("lda_gibbs", "paper_goem", dict(b=b, l=pl, s=s, burnin=burn,
                                         lengths=paper_len, k=pk, v=pv)),
        ("lda_gibbs", "paper_sync", dict(b=n * b, l=pl, s=s, burnin=burn,
                                         lengths=paper_len, k=pk, v=pv)),
        ("lda_gibbs", "paper_async", dict(b=2 * b, l=pl, s=s, burnin=burn,
                                          lengths=paper_len, k=pk, v=pv)),
        ("lda_gibbs", "full_sync", dict(b=f["n"] * f["batch"], l=f["l"],
                                        s=30, burnin=15, lengths=full_len,
                                        k=f["k"], v=f["v"])),
        ("lda_gibbs", "full_async", dict(b=2 * f["batch"], l=f["l"], s=30,
                                         burnin=15, lengths=full_len,
                                         k=f["k"], v=f["v"])),
        ("lda_l2r", "paper_eval", dict(b=p.corpus.n_test, l=pl, p=parts,
                                       lengths=paper_len, k=pk, v=pv)),
        ("lda_l2r", "paper_inloop", dict(b=p.probe_nodes * p.corpus.n_test,
                                         l=pl, p=parts, lengths=paper_len,
                                         k=pk, v=pv)),
        ("lda_l2r", "full_inloop", dict(b=f["probes"] * f["n_test"],
                                        l=f["l"], p=10, lengths=full_len,
                                        k=f["k"], v=f["v"])),
    ]


def _hold_deleda(rt, dev, cases, seed=20):
    """Each (kernel, phase, case) held against its plain version."""
    hold = {"lda_gibbs": _hold_gibbs, "lda_l2r": _hold_l2r,
            "lda_sparse": _hold_sparse}
    rows = []
    for i, (name, phase, case) in enumerate(cases):
        if name == "gossip_mix":
            row = _hold_mix(rt, dev, case, seed + i)
        else:
            row = hold[name](rt, dev, case, case["k"], case["v"], seed + i)
        row["phase"] = phase
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def _expected(mode, sched, eval_every):
    """Launches a run must make: lda_gibbs once per round in which a node
    updates, gossip_mix once per round with a live pair, lda_l2r once per
    in-loop evaluation (all probe nodes in one launch)."""
    data = sched.data
    if sched.kind == "edge":
        live = data[:, 0] != data[:, 1]
    else:
        live = (data != np.arange(sched.n_nodes)).any(1)
    n_live = int(live.sum())
    return {"gossip_mix": n_live,
            "lda_gibbs": sched.n_rounds if mode == "sync" else n_live,
            "lda_l2r": sched.n_rounds // eval_every if eval_every else 0}


def _drive_paper(rt, dev, rows):
    """The §4 experiment through its entry point over ``FIG1_SEEDS``,
    counters zeroed; its launches by shape go to ``rows`` and are checked
    against the rules. Each seed's LP* against the CPU's; the claims'
    mean and spread over the seeds."""
    p = rt.experiment.PAPER
    n, graph = p.corpus.n_nodes, rt.graph
    # the same seed's corpus and LP* on the CPU (the plain path): a corpus
    # is drawn on the CPU on every device, so the two LP* agree
    cpu = torch.device("cpu")
    lp_cpu = {}
    for seed in FIG1_SEEDS:
        corpus_cpu = rt.data.make_corpus(p.lda, rt.tf3.key(seed, cpu),
                                         p.corpus)
        _, lp_cpu[seed] = rt.experiment.make_beta_evaluator(p, corpus_cpu,
                                                            seed)
    rt.zero_counts()
    over = rt.experiment.run_experiment(p, device=dev, seeds=FIG1_SEEDS)
    torch.cuda.synchronize()
    for seed, res in over["per_seed"].items():
        lp_rel = abs(res["lp_star"] - lp_cpu[seed]) / abs(lp_cpu[seed])
        print(f"paper-scale LP* of seed {seed}: {res['lp_star']:.6f} on the "
              f"card, {lp_cpu[seed]:.6f} on the CPU from the same seed (rel "
              f"{lp_rel:.3g}, limit 1e-4; seed 0 gave 35.686 on the CPU "
              f"before) | {rt.card}", flush=True)
        if not lp_rel < 1e-4:
            raise AssertionError(f"paper-scale LP* of seed {seed} differs "
                                 f"between the card and the CPU: rel "
                                 f"{lp_rel}")
    got = _tally(rt, rows, "paper")
    n_rec = p.n_steps // p.record_every
    seeds = len(FIG1_SEEDS)
    want = {"paper_goem": seeds * p.n_steps, "paper_eval": seeds * (1 + n_rec),
            "paper_sync": 0, "paper_async": 0, "paper_mix": 0,
            "paper_inloop": 0}
    for seed in FIG1_SEEDS:
        for gobj in (graph.complete_graph(n),
                     graph.watts_strogatz_graph(n, p.ws_k, 0.3, seed=seed)):
            sched, _degs = rt.deleda.make_run_inputs(gobj, p.n_steps,
                                                     seed=seed)
            for mode in ("async", "sync"):
                e = _expected(mode, sched, p.record_every)
                want[f"paper_{mode}"] += e["lda_gibbs"]
                want["paper_mix"] += e["gossip_mix"]
                want["paper_inloop"] += e["lda_l2r"]
    _check_phases("paper", got, want)
    for seed, res in over["per_seed"].items():
        print(f"\nFig. 1, seed {seed}:")
        rt.experiment.print_report(res)
        for name, run in res["runs"].items():
            vals = run["rel_perplexity"] + run["beta_distance"]
            if not np.all(np.isfinite(vals)):
                raise AssertionError(f"paper run {name} of seed {seed}: a "
                                     f"metric is not finite")
    claims = over["claims_over_seeds"]
    print(f"\nFig. 1 claims over seeds {list(FIG1_SEEDS)}, mean [min, max] "
          f"| {rt.card}")
    for name, c in claims["C1"].items():
        print(f"  C1 {name:>22s}: gap to G-OEM {c['mean']:+.4f} "
              f"[{c['min']:+.4f}, {c['max']:+.4f}], within "
              f"{claims['c1_tol']} at {c['holds']} of {c['seeds']} seeds")
    for key in ("C2_ws_minus_complete", "C3_sync_minus_async"):
        for name, c in claims[key].items():
            print(f"  {key} {name}: {c['mean']:+.4f} [{c['min']:+.4f}, "
                  f"{c['max']:+.4f}]")
    print(f"(paper scale on {rt.card})", flush=True)
    res = over["per_seed"][FIG1_SEEDS[0]]
    summary = {k: res[k] for k in ("lp_star", "lambda2", "iterations",
                                   "claims")}
    summary["lp_star_cpu"] = lp_cpu[FIG1_SEEDS[0]]
    summary["runs"] = {
        name: {k: run[k] for k in ("rel_perplexity", "beta_distance",
                                   "rounds_per_s", "wall_sec",
                                   "within_envelope_frac") if k in run}
        for name, run in res["runs"].items()}
    summary["seeds"] = {
        seed: {"lp_star": r["lp_star"], "lp_star_cpu": lp_cpu[seed],
               "claims": r["claims"],
               "final_rel_perplexity": {
                   name: run["rel_perplexity"][-1]
                   for name, run in r["runs"].items()},
               "within_envelope_frac": {
                   name: run["within_envelope_frac"]
                   for name, run in r["runs"].items()
                   if "within_envelope_frac" in run}}
        for seed, r in over["per_seed"].items()}
    summary["claims_over_seeds"] = claims
    summary["launches"] = rt.counts()
    return summary


def _full_width_inputs(rt, dev):
    """The full-width model and its node-sharded corpus, on the card."""
    f = FULL
    cfg_lda = rt.lda.LDAConfig(n_topics=f["k"], vocab_size=f["v"],
                               alpha=0.5, doc_len_max=f["l"], n_gibbs=30,
                               n_gibbs_burnin=15)
    corpus = rt.data.make_corpus(
        cfg_lda, rt.tf3.key(0, dev),
        rt.data.CorpusSpec(n_nodes=f["n"], docs_per_node=f["docs"],
                           n_test=f["n_test"]))
    return cfg_lda, corpus


def _seconds(fn):
    """Wall seconds of ``fn`` with the card drained on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _drive_full(rt, dev, rows, cfg_lda, corpus, layout="dense",
                max_unique=0, prefix="full"):
    """run_deleda at K=100, V=50,000 for each (mode, kind, graph), in one
    corpus layout.

    The initial state is built and timed on its own. Each run starts from
    it twice: the first (cold) run is timed but not counted; the second,
    with the counters zeroed, gives the launches, rounds/s, peak memory,
    the E-step kernel's ms a round and kernel shares, and must repeat the
    first bit for bit. The E-step launches are held under the phase
    ``{prefix}_{mode}``, the evals under ``{prefix}_inloop`` and the
    gossip under ``full_{mode}_mix``.
    """
    f = FULL
    spec = rt.evaluation.EvalSpec(words=corpus.test_words,
                                  mask=corpus.test_mask,
                                  key=rt.tf3.key(1, dev), n_particles=10,
                                  probe_nodes=f["probes"], layout=layout)
    estep_kernel = "lda_sparse" if layout == "unique" else "lda_gibbs"
    out = {}
    for mode, kind, gname in FULL_RUNS:
        gobj = (rt.graph.complete_graph(f["n"]) if gname == "complete"
                else rt.graph.watts_strogatz_graph(f["n"], 4, 0.3, seed=0))
        sched, degs = rt.deleda.make_run_inputs(gobj, f["rounds"], seed=0,
                                                kind=kind)
        if kind == "matching" and not (
                (sched.data != np.arange(f["n"])).sum(1) == f["n"]).all():
            raise AssertionError("a matching of the complete graph is not "
                                 "perfect: the held shape is wrong")
        cfg = rt.deleda.DeledaConfig(lda=cfg_lda, mode=mode,
                                     batch_size=f["batch"],
                                     eval_every=f["every"],
                                     corpus_layout=layout,
                                     max_unique=max_unique)
        tag = f"{prefix}_{mode}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        init_s, state = _seconds(
            lambda: rt.deleda.init_state(cfg, rt.tf3.key(3, dev), f["n"]))
        init_peak = torch.cuda.max_memory_allocated()

        def run():
            return rt.deleda.run_deleda(cfg, state.key, corpus.words,
                                        corpus.mask, sched, degs,
                                        f["rounds"], record_every=f["every"],
                                        eval_spec=spec, init=state)

        cold_wall, cold = _seconds(run)
        cold_stats, cold_lp = cold.stats.cpu(), cold.eval_lp.cpu()
        del cold
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rt.zero_counts()
        wall, trace = _seconds(run)
        peak = torch.cuda.max_memory_allocated()
        where = (f"{prefix} {mode} {kind} {gname} (L={cfg_lda.doc_len_max}, "
                 f"{layout} layout)")
        got = _tally(rt, rows, where)
        e = _expected(mode, sched, f["every"])
        _check_phases(where, got, {f"full_{mode}_mix": e["gossip_mix"],
                                   tag: e["lda_gibbs"],
                                   f"{prefix}_inloop": e["lda_l2r"]})
        lp = trace.eval_lp
        if (lp.shape != (f["rounds"] // f["every"], f["probes"])
                or not bool(torch.isfinite(lp).all())
                or not bool(torch.isfinite(trace.stats).all())):
            raise AssertionError(f"{where}: non-finite or misshapen "
                                 f"output, eval_lp {lp}")
        if not (torch.equal(trace.stats.cpu(), cold_stats)
                and torch.equal(lp.cpu(), cold_lp)):
            raise AssertionError(f"{where}: two runs from one state differ")
        del cold_stats, cold_lp
        kernel_ms = {name: sum(got.get(r["phase"], 0) * r["ms"]
                               for r in rows if r["name"] == name)
                     for name in rt.ops}
        run_out = {"mode": mode, "kind": kind, "graph": gname,
                   "layout": layout, "doc_len_max": cfg_lda.doc_len_max,
                   "max_unique": max_unique,
                   "rounds": f["rounds"], "init_s": init_s,
                   "init_peak_mem_gb": init_peak / 1e9,
                   "cold_wall_s": cold_wall, "wall_s": wall,
                   "rounds_per_s": f["rounds"] / wall,
                   "peak_mem_gb": peak / 1e9, "launches": rt.counts(),
                   "estep_kernel": estep_kernel,
                   "estep_kernel_ms_per_round":
                       kernel_ms[estep_kernel] / f["rounds"],
                   "kernel_share_of_wall": {k: v / 1e3 / wall
                                            for k, v in kernel_ms.items()},
                   "eval_lp": lp.tolist(),
                   "consensus": trace.consensus.tolist()}
        out[f"{mode}_{kind}_{gname}"] = run_out
        print(f"{where}: init {init_s:.3f} s, cold run {cold_wall:.3f} s, "
              f"run {wall:.3f} s = {run_out['rounds_per_s']:.2f} rounds/s "
              f"(from the built state, repeated bit for bit), {estep_kernel}"
              f" {run_out['estep_kernel_ms_per_round']:.3f} ms a round, peak "
              f"{run_out['peak_mem_gb']:.2f} GB, kernel share "
              f"{run_out['kernel_share_of_wall']} | {rt.card}", flush=True)
        del trace, state
    return out


def _zipf_inputs(rt, dev):
    """The unique-token full width: the full-width model at L=256 on the
    Zipf corpus of ``launch/sparse_bench`` (Zipf 2.2 words,
    lognormal(4.4, 0.4) lengths), and U = the training shards' realized
    maximum of distinct words (nothing is dropped)."""
    f = ZFULL
    cfg_lda = rt.lda.LDAConfig(n_topics=f["k"], vocab_size=f["v"],
                               alpha=0.5, doc_len_max=f["l"], n_gibbs=30,
                               n_gibbs_burnin=15)
    corpus = rt.data.make_corpus(
        cfg_lda, rt.tf3.key(0, dev),
        rt.data.CorpusSpec(n_nodes=f["n"], docs_per_node=f["docs"],
                           n_test=f["n_test"], **rt.sparse_bench.ZIPF))
    uw, counts = corpus.unique_view()
    if not torch.equal(counts.sum(-1), corpus.mask.sum(-1)):
        raise AssertionError("the unique view's counts do not sum to the "
                             "mask's")
    return cfg_lda, corpus, uw.shape[-1]


def _zipf_cases(rt, corpus, u_max):
    """Every E-step and estimator shape of the unique-token full width,
    with the documents it gives them: the sync fan is every training
    document, the async fan 40 of them, the in-loop batch the held-out set
    once per probe node (dense, and as counts at U = L)."""
    f = ZFULL
    words, mask = corpus.flat_words, corpus.flat_mask
    uw, counts = rt.estep.dense_to_unique(words, mask, u_max)
    tw = corpus.test_words.repeat(f["probes"], 1)
    tm = corpus.test_mask.repeat(f["probes"], 1)
    tuw, tc = rt.estep.dense_to_unique(tw, tm)
    kv = dict(k=f["k"], v=f["v"])
    gib = dict(kv, s=30, burnin=15)
    cases = []
    for mode, b in (("sync", f["n"] * f["batch"]), ("async", 2 * f["batch"])):
        cases.append(("lda_gibbs", f"zipf_dense_{mode}",
                      dict(gib, b=b, l=f["l"],
                           docs=(words[:b], mask[:b]))))
        cases.append(("lda_sparse", f"zipf_unique_{mode}",
                      dict(gib, b=b, l=u_max,
                           docs=(uw[:b], counts[:b]))))
    cases.append(("lda_l2r", "zipf_dense_inloop",
                  dict(kv, b=tw.shape[0], l=f["l"], p=10, docs=(tw, tm))))
    cases.append(("lda_l2r", "zipf_unique_inloop",
                  dict(kv, b=tw.shape[0], l=f["l"], p=10, cw=True,
                       docs=(tuw, tc))))
    return cases


def _timed(fn, out: list):
    """``fn`` wrapped to append its wall seconds (the card drained on both
    sides) to ``out``."""
    def wrapper(*args, **kw):
        secs, res = _seconds(lambda: fn(*args, **kw))
        out.append(secs)
        return res
    return wrapper


def _resume_across_devices(rt, dev):
    """At the golden test's shapes: the CPU runs T/2 rounds and saves, the
    card resumes from that checkpoint; the result against the CPU's
    uninterrupted run at ``_trajectory_check``'s tolerances."""
    gsz = GOLDEN
    cfg_lda = rt.lda.LDAConfig(n_topics=gsz["k"], vocab_size=gsz["v"],
                               alpha=0.5, doc_len_max=gsz["l"], n_gibbs=4,
                               n_gibbs_burnin=2)
    corpus = rt.data.make_corpus(cfg_lda, rt.tf3.key(0),
                                 rt.data.CorpusSpec(n_nodes=gsz["n"],
                                                    docs_per_node=4,
                                                    n_test=4))
    sched, degs = rt.deleda.make_run_inputs(
        rt.graph.watts_strogatz_graph(gsz["n"], 4, 0.3, seed=0), gsz["t"],
        seed=0, kind="matching")
    cfg = rt.deleda.DeledaConfig(lda=cfg_lda, mode="sync", batch_size=2,
                                 eval_every=10, decay=(5.0, 0.8))

    def run(d, **kw):
        spec = rt.evaluation.EvalSpec(
            words=corpus.test_words.to(d), mask=corpus.test_mask.to(d),
            key=rt.tf3.key(7, d), n_particles=4, probe_nodes=2)
        return rt.deleda.run_deleda(
            cfg, rt.tf3.key(1, d), corpus.words.to(d), corpus.mask.to(d),
            sched, degs, gsz["t"], record_every=10, eval_spec=spec, **kw)

    cpu = torch.device("cpu")
    with tempfile.TemporaryDirectory() as d:
        full = run(cpu, save_every=gsz["t"] // 2, checkpoint_dir=d)
        _kill_step(d, gsz["t"])
        resumed = run(dev, restore_from=d)
    where = "lifecycle: CPU checkpoint at T/2 resumed on the card"
    if resumed.stats.device.type != dev.type:
        raise AssertionError(f"{where}: the resumed run left the card")
    sa, sb = full.stats.double(), resumed.stats.double().cpu()
    mass = abs(float(sb.sum()) / float(sa.sum()) - 1.0)
    pa, pb = sa[::3, 1, ::7], sb[::3, 1, ::7]
    la, lb = full.eval_lp[-1].double(), resumed.eval_lp[-1].double().cpu()
    if (full.steps.tolist() != resumed.steps.cpu().tolist() or mass > 1e-4
            or not torch.allclose(pb, pa, rtol=3e-3, atol=1e-5)
            or not torch.allclose(lb, la, rtol=1e-5, atol=0)):
        raise AssertionError(f"{where}: steps {full.steps.tolist()} / "
                             f"{resumed.steps.tolist()}, mass rel diff "
                             f"{mass}, probe {pa} / {pb}, LP {la} / {lb}")
    out = {"mass_rel_diff": mass,
           "probe_max_abs_diff": float((pb - pa).abs().max()),
           "eval_lp_max_rel_diff": float(((lb - la) / la).abs().max())}
    print(f"{where}: {out}", flush=True)
    return out


def _kill_step(directory, step):
    """The kill: delete step ``step``'s checkpoint and leave in its place
    an uncommitted directory holding only a sidecar (a save cut between
    its meta.json and its state.npz)."""
    path = os.path.join(directory, f"step_{step:08d}")
    shutil.rmtree(path)
    os.makedirs(path)
    with open(os.path.join(path, "meta.json"), "w") as f:
        f.write("{}")


def _drive_lifecycle(rt, dev, full_rows, cases, serve_rows):
    """The lifecycle phase (slice 8) at full width: 40 sync rounds of
    matchings on the complete graph with forgetting, on a streamed corpus
    that refreshes every 20 rounds, saved every 20 rounds; the kill; the
    resumed run (which saves step 40 again), which must equal the
    uninterrupted one bit for bit and launch what its 20 rounds and one
    eval imply; node 3 of that checkpoint served by ``serve_topics
    --restore-train``; a CPU checkpoint resumed on the card. Launches go
    to the held rows of their shapes. The resumed rounds/s leaves out
    its restore and its save, which are timed apart."""
    f = FULL
    cfg_lda = rt.lda.LDAConfig(n_topics=f["k"], vocab_size=f["v"],
                               alpha=0.5, doc_len_max=f["l"], n_gibbs=30,
                               n_gibbs_burnin=15)
    stream = rt.data.make_corpus_stream(
        cfg_lda, rt.tf3.key(0, dev),
        rt.data.CorpusSpec(n_nodes=f["n"], docs_per_node=f["docs"],
                           n_test=f["n_test"], refresh_every=f["every"]))
    draw_s, _ = _seconds(lambda: stream.segment(1))
    spec = rt.evaluation.EvalSpec(words=stream.base.test_words,
                                  mask=stream.base.test_mask,
                                  key=rt.tf3.key(1, dev), n_particles=10,
                                  probe_nodes=f["probes"])
    sched, degs = rt.deleda.make_run_inputs(
        rt.graph.complete_graph(f["n"]), f["rounds"], seed=0,
        kind="matching")
    cfg = rt.deleda.DeledaConfig(lda=cfg_lda, mode="sync",
                                 batch_size=f["batch"],
                                 eval_every=f["every"], decay=LIFE_DECAY)
    half = f["rounds"] // 2
    saves, restores = [], []
    real_save, real_restore = rt.deleda.save_state, rt.deleda.restore_state
    rt.deleda.save_state = _timed(real_save, saves)
    rt.deleda.restore_state = _timed(real_restore, restores)
    out = {}
    try:
        with tempfile.TemporaryDirectory() as d:
            def run(**kw):
                return rt.deleda.run_deleda(
                    cfg, rt.tf3.key(3, dev), None, None, sched, degs,
                    f["rounds"], record_every=f["every"], eval_spec=spec,
                    stream=stream, **kw)

            rt.zero_counts()
            wall, full = _seconds(lambda: run(save_every=half,
                                              checkpoint_dir=d))
            got = _tally(rt, full_rows, "lifecycle uninterrupted")
            e = _expected("sync", sched, f["every"])
            _check_phases("lifecycle uninterrupted", got,
                          {"full_sync_mix": e["gossip_mix"],
                           "full_sync": e["lda_gibbs"],
                           "full_inloop": e["lda_l2r"]})
            ckpt_bytes = os.path.getsize(os.path.join(
                d, f"step_{f['rounds']:08d}", "state.npz"))
            _kill_step(d, f["rounds"])
            if rt.checkpoint.latest_step(d) != half:
                raise AssertionError("lifecycle: the uncommitted directory "
                                     "was taken for a checkpoint")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()   # the uninterrupted trace
            rt.zero_counts()
            r_wall, resumed = _seconds(lambda: run(
                restore_from=d, save_every=half, checkpoint_dir=d))
            peak = torch.cuda.max_memory_allocated()
            got = _tally(rt, full_rows, "lifecycle resumed")
            e = _expected("sync", rt.comm.GossipSchedule(
                sched.kind, sched.data[half:], f["n"]), f["every"])
            _check_phases("lifecycle resumed", got,
                          {"full_sync_mix": e["gossip_mix"],
                           "full_sync": e["lda_gibbs"],
                           "full_inloop": e["lda_l2r"]})
            same = {
                "stats": torch.equal(full.stats, resumed.stats),
                "steps": torch.equal(full.steps, resumed.steps),
                "history": torch.equal(full.history[-1],
                                       resumed.history[-1]),
                "consensus": torch.equal(full.consensus[-1],
                                         resumed.consensus[-1]),
                "eval_lp": torch.equal(full.eval_lp[-1],
                                       resumed.eval_lp[-1])}
            if not all(same.values()) or resumed.state.cursor != 1:
                raise AssertionError(f"lifecycle: the resumed run differs "
                                     f"from the uninterrupted one: {same}, "
                                     f"cursor {resumed.state.cursor}")
            lp = resumed.eval_lp
            if not (bool(torch.isfinite(lp).all())
                    and bool(torch.isfinite(resumed.stats).all())):
                raise AssertionError(f"lifecycle: non-finite output {lp}")
            node3 = full.stats[3].clone()
            del full, resumed
            torch.cuda.empty_cache()
            argv = ["--restore-train", d, "--restore-node", "3",
                    "--restore-nodes", str(f["n"]), "--topics",
                    str(f["k"]), "--vocab", str(f["v"]), "--doc-len",
                    str(f["l"]), "--requests", str(LIFE_REQUESTS),
                    "--mixture-frac", "0.25", "--particles",
                    str(PARTICLES), "--request-len", "uniform",
                    "--closed-loop", "--device", "cuda"]
            served = _drive(rt, dev, argv, cases, serve_rows,
                            trained=False)
            if not torch.equal(served["serving_state"].stats, node3):
                raise AssertionError("lifecycle: --restore-train served "
                                     "another row than node 3's")
    finally:
        rt.deleda.save_state, rt.deleda.restore_state = (real_save,
                                                         real_restore)
    # restores[0] is the resumed run's (on the card), restores[1] the
    # --restore-train one (on the host, before node 3's row moves)
    restore_s = restores[0]
    out = {"rounds": f["rounds"], "resumed_rounds": half,
           "decay": list(LIFE_DECAY), "refresh_every": f["every"],
           "checkpoint_bytes": ckpt_bytes, "save_s": saves,
           "restore_s": restore_s, "serve_restore_s": restores[1],
           "segment_draw_s": draw_s,
           "uninterrupted_wall_s": wall, "resumed_wall_s": r_wall,
           "resumed_rounds_per_s": half / (r_wall - restore_s
                                           - saves[-1]),
           "resumed_peak_mem_gb": peak / 1e9,
           "held_before_resume_gb": held / 1e9,
           "served_req_per_s": served["req_per_s"],
           "served_requests": len(served["results"]),
           "cross_device": _resume_across_devices(rt, dev),
           "card": rt.card}
    print(f"lifecycle: {json.dumps(out)}", flush=True)
    return out


def _drive_zipf(rt, dev, mix_rows):
    """The unique-token full width in both layouts, every shape held
    first. Returns (rows, per-layout results)."""
    cfg_lda, corpus, u_max = _zipf_inputs(rt, dev)
    rows = _hold_deleda(rt, dev, _zipf_cases(rt, corpus, u_max), seed=60)
    lens = corpus.mask.sum(-1).double()
    uniq = (corpus.unique_view()[1] > 0).sum(-1).double()
    out = {"u_max": u_max, "mean_len": float(lens.mean()),
           "max_len": float(lens.max()), "mean_unique": float(uniq.mean()),
           "truncation_frac": corpus.length_truncation_frac}
    print(f"unique-token full width: K={ZFULL['k']} V={ZFULL['v']} "
          f"L={ZFULL['l']}, {out}", flush=True)
    for layout in ("dense", "unique"):
        out[layout] = _drive_full(
            rt, dev, [r for r in rows if r["phase"].startswith(
                f"zipf_{layout}")] + mix_rows, cfg_lda, corpus, layout,
            u_max if layout == "unique" else 0, prefix=f"zipf_{layout}")
        torch.cuda.empty_cache()
    return rows, out


def _bench_cases(rt, dev):
    """Every kernel shape ``launch/sparse_bench`` launches, with the
    documents it gives them: each regime's fan in both layouts, and (the
    paper regime) the trajectory runs' sync E-steps at batch 4 and their
    matchings' pair counts."""
    sb = rt.sparse_bench
    cases = []
    for name, rg in sb.REGIMES.items():
        cfg = sb.regime_config(rg)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            corpus = sb.regime_corpus(cfg, rg, dev)
        kv = dict(k=rg["k"], v=rg["v"], s=rg["n_gibbs"], burnin=rg["burnin"])
        words, mask = sb.tiled_batch(corpus, rg["n"], rg["b"])
        words, mask = words.flatten(0, 1), mask.flatten(0, 1)
        uw, counts = rt.estep.unique_view(words, mask)
        b, l, u = words.shape[0], words.shape[1], uw.shape[1]
        cases.append(("lda_gibbs", f"bench_{name}",
                      dict(kv, b=b, l=l, docs=(words, mask))))
        cases.append(("lda_sparse", f"bench_{name}_unique",
                      dict(kv, b=b, l=u, docs=(uw, counts))))
        if not rg["steps"]:
            continue
        words, mask = sb.tiled_batch(corpus, rg["n"], 4)
        words, mask = words.flatten(0, 1), mask.flatten(0, 1)
        tuw, tc = rt.estep.dense_to_unique(words, mask, u)
        cases.append(("lda_gibbs", f"bench_{name}_traj",
                      dict(kv, b=words.shape[0], l=l, docs=(words, mask))))
        cases.append(("lda_sparse", f"bench_{name}_traj_unique",
                      dict(kv, b=words.shape[0], l=u, docs=(tuw, tc))))
        sched, _degs = sb.trajectory_schedule(rg)
        pairs = (sched.data != np.arange(rg["n"])).sum(1) // 2
        for npairs in sorted(set(pairs.tolist()) - {0}):
            cases.append(("gossip_mix", f"bench_{name}_mix_{npairs}",
                          dict(n=rg["n"], k=rg["k"], v=rg["v"],
                               pairs=npairs)))
    return cases


def _drive_sparse_bench(rt, dev):
    """``launch/sparse_bench`` on the card, every regime with its asserts
    (word-marginal mass, bitwise stats path, trajectory band and mass),
    counters zeroed just before; its launches by shape are checked
    against the calls it makes. Returns (held rows, its rows)."""
    sb = rt.sparse_bench
    rows = _hold_deleda(rt, dev, _bench_cases(rt, dev), seed=80)
    rt.zero_counts()
    bench = sb.main(["--device", "cuda"])
    torch.cuda.synchronize()
    got = _tally(rt, rows, "sparse_bench")
    want = {}
    for name, rg in sb.REGIMES.items():
        calls = 2 * (1 + rg["iters"])          # E-step and sweeps alone
        want[f"bench_{name}"] = want[f"bench_{name}_unique"] = calls
        if not rg["steps"]:
            continue
        runs = sb.TRAJ_SEEDS                     # sync runs per layout
        want[f"bench_{name}_traj"] = runs * rg["steps"]
        want[f"bench_{name}_traj_unique"] = runs * rg["steps"]
        sched, _degs = sb.trajectory_schedule(rg)
        pairs = (sched.data != np.arange(rg["n"])).sum(1) // 2
        for npairs in set(pairs.tolist()) - {0}:
            want[f"bench_{name}_mix_{npairs}"] = 2 * runs * int(
                (pairs == npairs).sum())
    _check_phases("sparse_bench", got, want)
    for row in bench:
        print(f"sparse_bench {row['regime']}: speedup {row['speedup']:.3f}x,"
              f" sweeps {row['sweeps_speedup']:.3f}x (the JAX bench's "
              f"{sb.MIN_SPEEDUP}x on {row['gate']}: {row['gate_met']}) | "
              f"{rt.card}", flush=True)
    return rows, bench


def _check_sparse_binary(rt, dev):
    """Counts in {0, 1} on sorted documents without repeats: K4 gives
    K2's bits (per-position means, n_dk means, and m = onehot(z))."""
    b, l, k, s = 256, 64, 100, 30
    g = torch.Generator(device=dev).manual_seed(7)
    words = torch.argsort(torch.rand((b, 50_000), generator=g, device=dev),
                          -1)[:, :l].sort(-1).values
    lengths = torch.clamp(torch.poisson(torch.full((b,), 20.0, device=dev),
                                        generator=g), 1, l)
    mf = (torch.arange(l, device=dev)[None, :] < lengths[:, None]).float()
    words = torch.where(mf > 0, words, torch.zeros_like(words))
    uw, counts = rt.estep.dense_to_unique(words, mf > 0)
    if not (torch.equal(uw, words) and torch.equal(counts.float(), mf)):
        raise AssertionError("sorted distinct words: the unique view is "
                             "not the document")
    _w, bw, _m, un, z0 = _inputs(rt, dev, dict(b=b, l=l, s=s,
                                               docs=(words, mf)),
                                 k, 50_000, 8)
    kw = dict(alpha=0.5, n_sweeps=s, burnin=15)
    dense = rt.gibbs_ops.gibbs_sweeps(bw, mf, un, z0, **kw)
    sparse = rt.sparse_ops.sparse_sweeps(bw, mf, un, z0, **kw)
    onehot = torch.nn.functional.one_hot(dense[1], k).float() * mf[..., None]
    same = (torch.equal(sparse[0], dense[0])
            and torch.equal(sparse[2], dense[2])
            and torch.equal(sparse[1], onehot))
    if not same:
        raise AssertionError("lda_sparse on counts in {0, 1} is not "
                             "lda_gibbs bit for bit")
    print(f"lda_sparse on counts in {{0, 1}} (B={b} L={l} K={k} S={s}): "
          f"lda_gibbs's bits", flush=True)
    return 0.0


def _profile_rounds(rt, dev, rounds=10):
    """``torch.profiler`` over ``rounds`` full-width sync rounds
    (``train_steps`` from a built state, after one warm segment). The
    same segment is first timed without the profiler, so the card's idle
    share is its device time over that wall, one window on both sides.
    Also kernels per round, the entries with the most device time and
    the host's waits on the card."""
    from torch.profiler import ProfilerActivity, profile

    f = FULL
    cfg_lda, corpus = _full_width_inputs(rt, dev)
    cfg = rt.deleda.DeledaConfig(lda=cfg_lda, mode="sync",
                                 batch_size=f["batch"])
    sched, _degs = rt.deleda.make_run_inputs(
        rt.graph.complete_graph(f["n"]), 2 * rounds, seed=1,
        kind="matching")
    warm, window = (rt.comm.GossipSchedule(sched.kind, part, f["n"])
                    for part in (sched.data[:rounds], sched.data[rounds:]))
    state = rt.deleda.init_state(cfg, rt.tf3.key(3, dev), f["n"])
    corr = torch.ones((rounds, f["n"]), device=dev)

    def segment(sched_part, start):
        return rt.deleda.train_steps(cfg, start, corpus.words, corpus.mask,
                                     sched_part, corr, record_every=rounds)

    state, _ = segment(warm, state)
    plain_wall, _ = _seconds(lambda: segment(window, state))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _ = _seconds(lambda: segment(window, state))
    events = prof.key_averages()
    on_dev = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_dev) / 1e3
    top = sorted(on_dev, key=lambda e: -e.self_device_time_total)[:8]
    waits = {e.key: e.count for e in events
             if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                          "cudaMemcpy", "cudaMemcpyAsync",
                          "cudaEventSynchronize")}
    out = {"rounds": rounds,
           "wall_ms_per_round": 1e3 * plain_wall / rounds,
           "profiled_wall_ms_per_round": 1e3 * wall / rounds,
           "device_busy_ms_per_round": busy_ms / rounds,
           "device_idle_share": 1.0 - busy_ms / (1e3 * plain_wall),
           "device_entries_per_round": sum(e.count for e in on_dev) / rounds,
           "top_device_ms_per_round": [
               [e.key[:100], e.self_device_time_total / 1e3 / rounds,
                e.count / rounds] for e in top],
           "host_waits": waits}
    print(f"profile, full width sync, {rounds} rounds from a built state: "
          f"{json.dumps(out)} | {rt.card}", flush=True)
    return out


def _trajectory_scenario(rt, kind):
    """At the golden shapes, one compiled scenario with all of the layer:
    a WS graph rewired once (per-step degrees), 20% drops, 20% churn, the
    last node's cold join at T/2 and node 2's leave at 3T/4."""
    gsz = GOLDEN
    seq = rt.scenario.GraphSequence.rewiring(
        lambda s: rt.graph.watts_strogatz_graph(gsz["n"], 4, 0.3, seed=s),
        2, gsz["t"] // 2)
    return rt.scenario.Scenario(
        topology=seq, kind=kind, drop_prob=0.2, churn=0.2,
        churn_mean_down=4.0, joins=((gsz["n"] - 1, gsz["t"] // 2),),
        leaves=((2, 3 * gsz["t"] // 4),), name="trajectory").compile(
        np.random.default_rng(5))


def _trajectory_check(rt, dev):
    """The CUDA path against the CPU plain path from the same inputs, at
    the golden test's shapes (tests/test_golden.py's tolerances); two of
    the runs take a compiled scenario (``_trajectory_scenario``), one in
    each schedule kind."""
    gsz = GOLDEN
    cfg_lda = rt.lda.LDAConfig(n_topics=gsz["k"], vocab_size=gsz["v"],
                               alpha=0.5, doc_len_max=gsz["l"], n_gibbs=4,
                               n_gibbs_burnin=2)
    cpu = torch.device("cpu")
    corpus = rt.data.make_corpus(cfg_lda, rt.tf3.key(0),
                                 rt.data.CorpusSpec(n_nodes=gsz["n"],
                                                    docs_per_node=4,
                                                    n_test=4))
    gobj = rt.graph.watts_strogatz_graph(gsz["n"], 4, 0.3, seed=0)
    scen = {kind: _trajectory_scenario(rt, kind) for kind in ("edge",
                                                             "matching")}
    out = []
    for kind, mode, every, layout, scenario in (
            ("edge", "async", 0, "dense", False),
            ("matching", "async", 0, "dense", False),
            ("matching", "sync", 10, "dense", False),
            ("edge", "async", 0, "unique", False),
            ("matching", "async", 10, "unique", False),
            ("edge", "async", 10, "dense", True),
            ("matching", "async", 10, "dense", True)):
        alive = member = None
        if scenario:
            sched, degs, alive, member = scen[kind].run_inputs()
        else:
            sched, degs = rt.deleda.make_run_inputs(gobj, gsz["t"], seed=0,
                                                    kind=kind)
        cfg = rt.deleda.DeledaConfig(lda=cfg_lda, mode=mode, batch_size=2,
                                     eval_every=every, corpus_layout=layout)
        init = rt.deleda.init_state(cfg, rt.tf3.key(1), gsz["n"])
        traces = []
        for d in (cpu, dev):
            spec = None
            if every:
                spec = rt.evaluation.EvalSpec(
                    words=corpus.test_words.to(d),
                    mask=corpus.test_mask.to(d), key=rt.tf3.key(7, d),
                    n_particles=4, probe_nodes=2, layout=layout)
            state = rt.deleda.TrainState(stats=init.stats.to(d),
                                         steps=init.steps.to(d),
                                         key=init.key.to(d))
            traces.append(rt.deleda.run_deleda(
                cfg, init.key.to(d), corpus.words.to(d), corpus.mask.to(d),
                sched, degs, gsz["t"], record_every=10, eval_spec=spec,
                init=state, alive=alive, member=member))
        a, b = traces
        sa, sb = a.stats.double(), b.stats.double().cpu()
        where = (f"trajectory {kind} {mode} {layout}"
                 + (" scenario" if scenario else ""))
        if a.steps.tolist() != b.steps.cpu().tolist():
            raise AssertionError(f"{where}: steps differ")
        mass = abs(float(sb.sum()) / float(sa.sum()) - 1.0)
        pa, pb = sa[::3, 1, ::7], sb[::3, 1, ::7]
        if mass > 1e-4 or not torch.allclose(pb, pa, rtol=3e-3, atol=1e-5):
            raise AssertionError(f"{where}: mass rel diff {mass}, probe "
                                 f"{pa} vs {pb}")
        row = {"kind": kind, "mode": mode, "layout": layout,
               "scenario": scenario, "mass_rel_diff": mass,
               "probe_max_abs_diff": float((pb - pa).abs().max())}
        if every:
            la, lb = a.eval_lp.double(), b.eval_lp.double().cpu()
            if not torch.allclose(lb, la, rtol=1e-5, atol=0):
                raise AssertionError(f"trajectory eval LP {la} vs {lb}")
            row["eval_lp_max_rel_diff"] = float(((lb - la) / la).abs().max())
        out.append(row)
        print(f"{where} check: {row}", flush=True)
    return out


def _scenario_plans(rt, scale):
    """Per (seed, regime) of the sweep: the updating nodes m of each round,
    as ``run_deleda`` plans them (``deleda._plan_segment``) from the
    compiled scenario's schedule and masks. Async matchings: K2 runs at
    B = batch x m and K1 at m/2 pairs in every round with m > 0."""
    cfg = rt.deleda.DeledaConfig(lda=scale.lda, mode="async",
                                 batch_size=scale.batch_size)
    n = scale.corpus.n_nodes
    plans = {}
    for seed in SCEN_SEEDS:
        for name in rt.scenario.SCENARIO_NAMES:
            sc = rt.scenario.paper_scenario(name, n=n, n_steps=scale.n_steps,
                                            seed=seed, ws_k=scale.ws_k)
            sched, _degs, alive, member = sc.compile(
                np.random.default_rng(seed + 17)).run_inputs()
            live = alive if member is None else alive & member
            _events, counts, _rows = rt.deleda._plan_segment(
                cfg, sched, live, "cpu")
            plans[seed, name] = np.asarray(counts)
    return plans


def _scenario_cases(rt, scale, plans):
    """Every shape the sweep launches: K2 and K1 at each m of the plans,
    K3 at the evaluator's held-out batch."""
    lda_cfg = scale.lda
    kv = dict(k=lda_cfg.n_topics, v=lda_cfg.vocab_size)
    length = ("poisson", 2, lda_cfg.doc_len_max)
    ms = sorted(set(np.concatenate(list(plans.values())).tolist()) - {0})
    cases = []
    for m in ms:
        cases.append(("lda_gibbs", f"scen_gibbs_{m}", dict(
            kv, b=scale.batch_size * m, l=lda_cfg.doc_len_max,
            s=lda_cfg.n_gibbs, burnin=lda_cfg.n_gibbs_burnin,
            lengths=length)))
        cases.append(("gossip_mix", f"scen_mix_{m // 2}", dict(
            n=scale.corpus.n_nodes, k=kv["k"], v=kv["v"], pairs=m // 2)))
    cases.append(("lda_l2r", "scen_eval", dict(
        kv, b=scale.corpus.n_test, l=lda_cfg.doc_len_max,
        p=scale.n_particles, lengths=length)))
    return cases


def _drive_scenarios(rt, dev):
    """The scenario sweep (slice 9) at paper scale through
    ``launch.scenario_bench`` (seeds ``SCEN_SEEDS``, all six regimes,
    async matchings on WS, the reference's gates, both resume drills).
    Every shape it launches is held first; with the counters zeroed, its
    launches by shape must equal what the compiled masks imply. Returns
    (held rows, summary)."""
    scale = rt.experiment.SCENARIO_PAPER
    plans = _scenario_plans(rt, scale)
    rows = _hold_deleda(rt, dev, _scenario_cases(rt, scale, plans),
                        seed=100)
    names = rt.scenario.SCENARIO_NAMES
    argv = ["--scale", "paper", "--seeds", *map(str, SCEN_SEEDS),
            "--resume-smoke", "--device", dev.type]
    rt.zero_counts()
    wall, res = _seconds(lambda: rt.scenario_bench.main(argv))
    got = _tally(rt, rows, "scenario sweep")
    half = scale.n_steps // 2
    counts = [plans[key] for key in plans]
    counts += [plans[SCEN_SEEDS[0], name]
               for name in rt.scenario_bench.RESUME_REGIMES]     # full runs
    counts += [plans[SCEN_SEEDS[0], name][half:]
               for name in rt.scenario_bench.RESUME_REGIMES]     # resumed
    want = {"scen_eval": len(SCEN_SEEDS) * (1 + scale.probe_nodes
                                            * len(names))}
    for c in counts:
        for m, k in zip(*np.unique(c[c > 0], return_counts=True)):
            want[f"scen_gibbs_{m}"] = want.get(f"scen_gibbs_{m}", 0) + int(k)
            want[f"scen_mix_{m // 2}"] = (want.get(f"scen_mix_{m // 2}", 0)
                                          + int(k))
    _check_phases("scenario sweep", got, want)
    idle = {name: int(sum((plans[s, name] == 0).sum() for s in SCEN_SEEDS))
            for name in names}
    print(f"scenario sweep: {len(SCEN_SEEDS) * len(names)} runs of "
          f"{scale.n_steps} rounds and the resume drills in {wall:.1f} s; "
          f"rounds without a live pair (no launch) by regime {idle}; "
          f"{len(rows)} held shapes | {rt.card}", flush=True)
    per_seed = res["per_seed"]
    over = res["regimes_over_seeds"]
    for name in names:
        runs = [per_seed[s]["runs"][name] for s in SCEN_SEEDS]
        vals = [r["rel_perplexity"] for r in runs] + [
            r["beta_distance"] for r in runs]
        if not np.all(np.isfinite(vals)):
            raise AssertionError(f"scenario {name}: a metric is not finite")
        print(f"scenario {name:>9s} over seeds {list(SCEN_SEEDS)}, mean "
              f"[min, max]: " + "; ".join(
                  f"{k} {m['mean']:+.5f} [{m['min']:+.5f}, {m['max']:+.5f}]"
                  for k, m in over[name].items())
              + f"; {np.mean([r['rounds_per_s'] for r in runs]):.2f} "
              f"rounds/s | {rt.card}", flush=True)
    summary = {
        "seeds": list(SCEN_SEEDS), "wall_s": wall,
        "lp_star": {s: per_seed[s]["lp_star"] for s in SCEN_SEEDS},
        "regimes_over_seeds": over,
        "rounds_per_s": {name: [per_seed[s]["runs"][name]["rounds_per_s"]
                                for s in SCEN_SEEDS] for name in names},
        "events": {name: [per_seed[s]["runs"][name]["events"]
                          for s in SCEN_SEEDS] for name in names},
        "coldjoin_tail_within_envelope": [
            per_seed[s]["runs"]["coldjoin"]["tail_within_envelope"]
            for s in SCEN_SEEDS],
        "gates": res["gates"], "resume_bitwise": res["resume_bitwise"],
        "kernel_launches": res["kernel_launches"], "card": rt.card}
    return rows, summary


def _drive_full_scenario(rt, dev, full_rows, cfg_lda, corpus):
    """One scenario at full width (``SCEN_FULL``): async edge events over a
    WS graph rewired every 10 rounds (per-step degrees drive Remark 1),
    10% drops, 20% churn, a cold join and a leave; LP every 20 rounds.
    Every launch falls on a shape ``_drive_full`` holds. Checks: K1 and K2
    once per live event; each node's step counter equals its live events;
    a node down or not a member through all the rounds between two
    records keeps its row bit for bit (the first record against the
    initial state)."""
    f, sf = FULL, SCEN_FULL
    n, rounds, rec = f["n"], f["rounds"], sf["record"]
    seq = rt.scenario.GraphSequence.rewiring(
        lambda s: rt.graph.watts_strogatz_graph(n, 4, 0.3, seed=s),
        sf["segments"], rounds // sf["segments"])
    compiled = rt.scenario.Scenario(
        topology=seq, kind="edge", drop_prob=sf["drop"], churn=sf["churn"],
        joins=(sf["join"],), leaves=(sf["leave"],),
        name="full_width").compile(np.random.default_rng(0))
    sched, degs, alive, member = compiled.run_inputs()
    live = alive & member
    src, dst = sched.data[:, 0], sched.data[:, 1]
    t_idx = np.arange(rounds)
    ev_live = (src != dst) & live[t_idx, src] & live[t_idx, dst]
    want_steps = np.zeros(n, np.int64)
    np.add.at(want_steps, src[ev_live], 1)
    np.add.at(want_steps, dst[ev_live], 1)
    cfg = rt.deleda.DeledaConfig(lda=cfg_lda, mode="async",
                                 batch_size=f["batch"],
                                 eval_every=f["every"])
    spec = rt.evaluation.EvalSpec(words=corpus.test_words,
                                  mask=corpus.test_mask,
                                  key=rt.tf3.key(1, dev), n_particles=10,
                                  probe_nodes=f["probes"])
    state = rt.deleda.init_state(cfg, rt.tf3.key(3, dev), n)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rt.zero_counts()
    wall, trace = _seconds(lambda: rt.deleda.run_deleda(
        cfg, state.key, corpus.words, corpus.mask, sched, degs, rounds,
        record_every=rec, eval_spec=spec, init=state, alive=alive,
        member=member))
    peak = torch.cuda.max_memory_allocated()
    where = f"full-width scenario (async edges, L={cfg_lda.doc_len_max})"
    got = _tally(rt, full_rows, where)
    n_live = int(ev_live.sum())
    _check_phases(where, got, {"full_async_mix": n_live,
                               "full_async": n_live,
                               "full_inloop": rounds // f["every"]})
    if trace.steps.cpu().tolist() != want_steps.tolist():
        raise AssertionError(f"{where}: step counters "
                             f"{trace.steps.tolist()}, live events "
                             f"{want_steps.tolist()}")
    frozen = []
    for r in range(rounds // rec):
        out = np.nonzero(~live[r * rec:(r + 1) * rec].any(0))[0]
        for i in out.tolist():
            before = state.stats[i] if r == 0 else trace.history[r - 1][i]
            if not torch.equal(trace.history[r][i], before):
                raise AssertionError(f"{where}: node {i} was out through "
                                     f"record {r}'s rounds but its row "
                                     f"moved")
            frozen.append((r, i))
    join_i, join_t = sf["join"]
    leave_i, leave_t = sf["leave"]
    must = {(r, join_i) for r in range(join_t // rec)} | {
        (r, leave_i) for r in range(-(-leave_t // rec), rounds // rec)}
    if not must <= set(frozen):
        raise AssertionError(f"{where}: the joiner's and leaver's out "
                             f"windows {sorted(must)} were not checked")
    lp = trace.eval_lp
    if (lp.shape != (rounds // f["every"], f["probes"])
            or not bool(torch.isfinite(lp).all())
            or not bool(torch.isfinite(trace.stats).all())):
        raise AssertionError(f"{where}: non-finite or misshapen output {lp}")
    events = {"drawn": compiled.n_events, "dropped": compiled.n_dropped,
              "churned": compiled.n_churned,
              "excluded": compiled.n_excluded,
              "sponsored": compiled.n_sponsored, "live": n_live}
    out = {"rounds": rounds, "segments": sched.n_segments,
           "wall_s": wall, "rounds_per_s": rounds / wall,
           "peak_mem_gb": peak / 1e9, "events": events,
           "frozen_rows_checked": len(frozen),
           "steps": trace.steps.tolist(), "eval_lp": lp.tolist(),
           "consensus": trace.consensus.tolist(), "card": rt.card}
    print(f"{where}: {rounds} rounds in {wall:.3f} s = "
          f"{out['rounds_per_s']:.2f} rounds/s, peak {peak / 1e9:.2f} GB, "
          f"events {events}, {len(frozen)} out (node, record) rows equal "
          f"to the record before, step counters = live events | {rt.card}",
          flush=True)
    del trace, state
    return out


# --------------------------------------------------------------------------
# LM serving (the port's fourth slice): gemma2-2b through K5
# --------------------------------------------------------------------------

def _visible(sq, sk, window, q_offset, causal=True):
    """Visible (query, key) pairs of one head, and the keys some query
    sees (the causal mask unless ``causal`` is false, and the window,
    keys below Sk)."""
    rows = q_offset + np.arange(sq, dtype=np.int64)
    lo = np.maximum(0, rows - window + 1)
    hi = np.minimum(sk - 1, rows) if causal else np.full_like(rows, sk - 1)
    pairs = int(np.maximum(0, hi - lo + 1).sum())
    keys = max(0, int(hi[-1] - max(0, rows[0] - window + 1)) + 1)
    return pairs, keys


def _flash_bound(case, q_offset):
    """Bytes: Q and O once, K and V rows some query sees once. Operations:
    4 D per visible (query, key) pair and head, at the bf16 tensor-core
    peak for bf16 inputs and the float32 peak for float32 ones."""
    b, sq, sk, h, hkv, d = (case[x] for x in ("b", "sq", "sk", "h", "hkv",
                                               "d"))
    pairs, keys = _visible(sq, sk, case["window"], q_offset,
                           case.get("causal", True))
    elem = 2 if case["dtype"] == torch.bfloat16 else 4
    bytes_moved = elem * (2 * b * sq * h * d + 2 * b * keys * hkv * d)
    ops = 4 * b * h * pairs * d
    peak = BF16_OPS_PER_S if elem == 2 else FP32_OPS_PER_S
    return _bound(bytes_moved, ops, peak), pairs


def _sdpa_attention(q, k, v, case, q_offset, grad=None):
    """One ``scaled_dot_product_attention`` call of the same function, as
    a callable (with ``grad``, its forward and backward): any shape with
    no softcap. A causal launch at Sq = Sk from offset 0 with no window
    takes ``is_causal``; any other causal or windowed one a boolean mask
    of the pairs K5 keeps (query i + q_offset sees key j when j <= i +
    q_offset, causal, and i + q_offset - j < window)."""
    if case["softcap"]:
        raise ValueError(f"{case['phase']}: scaled_dot_product_attention "
                         f"has no softcap")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    causal = case.get("causal", True)
    sq, sk, window = case["sq"], case["sk"], case["window"]
    kw = dict(scale=case["scale"])
    if causal and sq == sk and not q_offset and window >= sk:
        kw["is_causal"] = True
    elif causal or window <= sq - 1 + q_offset:
        qi = torch.arange(sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(sk, device=q.device)[None, :]
        mask = qi - ki < window
        kw["attn_mask"] = mask & (qi >= ki) if causal else mask
    if case["h"] != case["hkv"]:
        kw["enable_gqa"] = True
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if grad is None:
        return lambda: sdpa(qh, kh, vh, **kw).transpose(1, 2)
    leaves = [x.detach().requires_grad_() for x in (qh, kh, vh)]
    gh = grad.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(sdpa(*leaves, **kw), leaves, gh)


def _library_kind(case):
    """The library call a K5 hold times: the case's ``library`` where it
    names one, else "sdpa" where there is no softcap and "flex" (a
    compiled ``flex_attention``) where there is."""
    return case.get("library") or ("flex" if case["softcap"] else "sdpa")


def _library_attention(rt, q, k, v, case, q_offset, grad=None):
    """The library call of the same function that ``_library_kind``
    names, as a callable: "flex" one compiled
    ``flex_attention`` call (tanh softcap ``score_mod`` where there is a
    softcap, causal + window ``mask_mod``, or no mask for a non-causal
    global launch), the offset and window riding in as tensors, so one
    compile serves every offset of a shape; "flex_eager" the same call
    not compiled (where a compile takes minutes); "sdpa"
    ``_sdpa_attention`` (no compile). Compiled for static shapes (one
    specialised compile a shape: after a first shape, dynamo would
    otherwise recompile with dynamic sizes, whose kernels ran up to 10x
    slower at some float32 shapes). With ``grad`` (the output's
    gradient) the call is its forward and backward."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    kind = _library_kind(case)
    if kind == "sdpa":
        return _sdpa_attention(q, k, v, case, q_offset, grad)
    if rt.flex is None:
        # every held shape is compiled once; past dynamo's default
        # recompile limit (8) a call would run flex_attention eagerly
        for name in ("recompile_limit", "cache_size_limit"):
            if hasattr(torch._dynamo.config, name):
                setattr(torch._dynamo.config, name, 256)
        rt.flex = torch.compile(flex_attention, dynamic=False)
    dev = q.device
    off = torch.tensor(q_offset, device=dev)
    win = torch.tensor(case["window"], device=dev)
    cap = case["softcap"]
    causal = case.get("causal", True)

    def score_mod(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    def mask_mod(b, h, qi, ki):
        if causal:
            return (qi + off >= ki) & (qi + off - ki < win)
        return qi + off - ki < win

    mask = (create_block_mask(mask_mod, None, None, case["sq"], case["sk"],
                              device=dev)
            if causal or case["window"] < rt.flash_ops.GLOBAL_WINDOW
            else None)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    scale = case["scale"]
    kw = dict(score_mod=score_mod if cap else None, block_mask=mask,
              scale=scale, enable_gqa=True)
    flex = rt.flex if kind == "flex" else flex_attention

    if grad is None:
        def call():
            return flex(qh, kh, vh, **kw).transpose(1, 2)
        return call
    leaves = [x.detach().requires_grad_() for x in (qh, kh, vh)]
    gh = grad.transpose(1, 2).contiguous()

    def call_grad():
        return torch.autograd.grad(flex(*leaves, **kw), leaves, gh)
    return call_grad


def _flash_cases(rt, lm=LM, prefix="", long=True):
    """Every K5 shape an LM phase launches: serving's decode against the
    cache (bf16), the f32 consistency check's forward and decode (at
    ``lm["f32_prompt"]``), and with ``long`` the bf16 prefill at S=8192
    and the bf16 decode against an S=8192 cache; local (window 4096) and
    global layers, each phase named with ``prefix``. Each names the
    kernel variant it must take: "wgmma" for the bf16 prefill at D=256,
    "decode" for every Sq=1 launch, "fma" for the float32 forward."""
    cfg = rt.get_config(lm["arch"])
    s_max = lm["prompt"] + lm["gen"]
    f32 = lm.get("f32_prompt", lm["prompt"])
    base = dict(h=cfg.n_heads, hkv=cfg.n_kv, d=cfg.hd,
                softcap=cfg.attn_softcap, scale=cfg.query_scale)
    cases = []
    for kind, window in (("local", cfg.window),
                         ("global", rt.flash_ops.GLOBAL_WINDOW)):
        w = dict(base, window=window, kind=kind)
        cases += [
            dict(w, phase=f"{prefix}decode_{kind}", b=lm["batch"], sq=1,
                 sk=s_max, dtype=torch.bfloat16, tol=3e-2,
                 variant="decode", offsets=(0, s_max // 2 - 1, s_max - 2)),
            dict(w, phase=f"{prefix}f32_forward_{kind}", b=lm["batch"],
                 sq=f32, sk=f32, dtype=torch.float32,
                 tol=2e-5, variant="fma", offsets=(0,), control="bf16",
                 library=lm.get("f32_library")),
            dict(w, phase=f"{prefix}f32_decode_{kind}", b=lm["batch"], sq=1,
                 sk=f32, dtype=torch.float32, tol=2e-5,
                 variant="decode", control="bf16",
                 offsets=(0, f32 // 2 - 1, f32 - 1),
                 library=lm.get("f32_library"))]
        if long:
            cases += [
                dict(w, phase=f"{prefix}prefill_{kind}", b=1, sq=PREFILL_S,
                     sk=PREFILL_S, dtype=torch.bfloat16, tol=3e-2,
                     variant="wgmma", offsets=(0,), control="tile"),
                dict(w, phase=f"{prefix}decode_long_{kind}", b=lm["batch"],
                     sq=1, sk=PREFILL_S, dtype=torch.bfloat16, tol=3e-2,
                     variant="decode", control="split",
                     offsets=(PREFILL_S - LONG_STEPS,
                              PREFILL_S - LONG_STEPS // 2 - 1,
                              PREFILL_S - 1))]
    return cases


def _row_err(got, want):
    """The largest relative error of one output row (batch, query, head):
    the RMS over D of ``got - want`` over the RMS of that row of ``want``
    (a row of zeros counts its error over 1e-6)."""
    g, w = got.double(), want.double()
    err = (g - w).pow(2).mean(-1).sqrt()
    return float((err / w.pow(2).mean(-1).sqrt().clamp_min(1e-6)).max())


@torch.no_grad()
def _hold_flash(rt, dev, case, seed):
    """K5 against its plain version at one shape and each held offset,
    with the times: the kernel, the plain version, the bound and the
    library call at the middle offset (the mean work of a run whose
    offsets are spread evenly; the first and last are timed too).

    Every output row is held to ``ROW_TOL`` of its own size, and a case
    that names a control shows that this limit catches what it should,
    at its last offset: "split" the plain version without the first key
    split of the last query row, "tile" without its first 64-key tile,
    "bf16" on inputs rounded to bf16 (each must exceed the limit)."""
    b, sq, sk, h, hkv, d = (case[x] for x in ("b", "sq", "sk", "h", "hkv",
                                               "d"))
    var = rt.flash_ops.variant(case["dtype"], sq, d, h // hkv)
    if var != case["variant"]:
        raise AssertionError(f"{case['phase']}: K5 takes variant {var}, "
                             f"want {case['variant']}")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, sq, h, d), generator=g, device=dev).to(case["dtype"])
    k = torch.randn((b, sk, hkv, d), generator=g, device=dev).to(
        case["dtype"])
    v = torch.randn((b, sk, hkv, d), generator=g, device=dev).to(
        case["dtype"])
    kw = dict(window=case["window"], softcap=case["softcap"],
              scale=case["scale"], causal=case.get("causal", True))
    flash, ref = rt.flash_ops.flash_attention, rt.flash_ref.attention_ref

    def heads(x):
        return x.transpose(1, 2).reshape(-1, x.shape[1], d)

    def plain(off, qkv=(q, k, v), window=case["window"]):
        out = ref(*(heads(x) for x in qkv), q_offset=off,
                  **dict(kw, window=window))
        return out.reshape(b, h, sq, d).transpose(1, 2)

    row_tol = ROW_TOL[case["dtype"]]
    err, row_err, by_offset = 0.0, 0.0, {}
    mid = case["offsets"][len(case["offsets"]) // 2]
    for off in case["offsets"]:
        ms, got = _time_ms(lambda: flash(q, k, v, q_offset=off, **kw),
                           reps=5 if sq > 1 else 9, device_only=True)
        want = plain(off)
        e = float((got.float() - want.float()).abs().max())
        if not (e <= case["tol"] and bool(torch.isfinite(got).all())):
            raise AssertionError(f"flash_attention disagrees with its plain "
                                 f"version at {case['phase']} q_offset={off}"
                                 f": max_abs_err {e} > {case['tol']}")
        r = _row_err(got, want)
        if not r <= row_tol:
            raise AssertionError(f"flash_attention disagrees with its plain "
                                 f"version at {case['phase']} q_offset={off}"
                                 f": row error {r} > {row_tol}")
        err, row_err = max(err, e), max(row_err, r)
        by_offset[off] = ms
    control, ctl_err = case.get("control"), None
    if control is not None:
        last = case["offsets"][-1]
        seen = min(case["window"], last + sq)   # keys the last row sees
        if control == "bf16":
            ctl = plain(last, tuple(x.to(torch.bfloat16).to(case["dtype"])
                                    for x in (q, k, v)))
        else:
            splits = rt.flash_ops.n_splits(sq, sk, True, case["window"], last)
            drop = (-(-_visible(sq, sk, case["window"], last)[1] // splits)
                    if control == "split" else 64)
            ctl = plain(last, window=seen - drop)
        ctl_err = _row_err(ctl, plain(last))
        if not ctl_err > row_tol:
            raise AssertionError(f"{case['phase']}: the row check misses "
                                 f"the {control} control ({ctl_err} <= "
                                 f"{row_tol})")
    plain_ms, _ = _time_ms(lambda: plain(mid), reps=2, warmup=1)
    (bound, by), pairs = _flash_bound(case, mid)
    lib_ms, lib_err = None, None
    t_lib = time.perf_counter()
    try:
        call = _library_attention(rt, q, k, v, case, mid)
        lib_ms, out = _time_ms(call, reps=5, warmup=2, device_only=True)
        lib_err = float((out.float() - plain(mid).float()).abs().max())
        library = (f"{_library_kind(case)} {lib_ms:.4f} ms "
                   f"(max_abs_err {lib_err:.3g})")
    except Exception as exc:          # recorded, not fatal: a yardstick
        lib_ms = None
        library = f"none: {type(exc).__name__}: {str(exc)[:200]}"
    lib_s = time.perf_counter() - t_lib   # lint: allow(timer-no-barrier)
    shape = (f"B={b} Sq={sq} Sk={sk} H={h}/{hkv} D={d} "
             f"{'bf16' if case['dtype'] == torch.bfloat16 else 'f32'} "
             f"{case['kind']}{'' if kw['causal'] else ' non-causal'} "
             f"softcap {case['softcap']}")
    print(f"flash_attention [{var}] vs plain at {shape}, q_offset "
          f"{list(case['offsets'])}: max_abs_err {err:.3g} (tol "
          f"{case['tol']}), row error {row_err:.3g} (limit {row_tol}"
          f"{'' if control is None else f'; {control} control {ctl_err:.3g}'}"
          f"); {by_offset[mid]:.4f} ms at offset {mid} (all "
          f"{ {o: round(t, 4) for o, t in by_offset.items()} }), plain "
          f"{plain_ms:.3f} ms, bound {bound:.5f} ms by {by}, library "
          f"{library} ({lib_s:.1f} s with its compile) | {rt.card}",
          flush=True)
    key = rt.flash_ops.shape_key(q, k, case["window"], case["softcap"])
    return dict(name="flash_attention", key=key, shape=shape,
                phase=case["phase"], variant=var, ms=by_offset[mid],
                ms_by_offset=by_offset, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, visible_pairs_per_head=pairs,
                library_ms=lib_ms, library=library,
                library_max_abs_err=lib_err, max_abs_err=err,
                tol=case["tol"], row_err=row_err, row_tol=row_tol,
                control=control, control_row_err=ctl_err, launches=0)


def _library_jobs(rt):
    """Every library call a K5 hold compiles: (case, with its backward)
    for each held shape of the LM, families and training phases whose
    library call is the compiled ``flex_attention``."""
    cases = (_flash_cases(rt) + _flash_cases(rt, LM9, prefix="9b_",
                                             long=False)
             + _family_flash_cases(rt) + _train_flash_cases(rt)
             + _ftrain_flash_cases(rt))
    flex = [c for c in cases if _library_kind(c) == "flex"]
    return ([(c, False) for c in flex]
            + [(c, True) for c in flex if c["phase"].startswith("train_")])


def _warm_library(jobs):
    """The warming process: each job's compiled ``flex_attention`` call
    (``_library_attention``, as its hold calls it) compiled and run once
    on the card, its kernels left in the inductor and Triton caches. At
    the lowest priority and one compile thread, so the phases it runs
    beside keep the host's cores. A call that fails is left to its
    hold."""
    os.nice(19)
    torch._inductor.config.compile_threads = 1
    rt = _Port()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    for i, (case, grad) in enumerate(jobs):
        b, sq, sk, h, hkv, d = (case[x] for x in ("b", "sq", "sk", "h",
                                                   "hkv", "d"))
        try:
            q = torch.randn((b, sq, h, d), device=dev).to(case["dtype"])
            k, v = (torch.randn((b, sk, hkv, d), device=dev).to(
                case["dtype"]) for _ in range(2))
            if grad:
                _library_attention(rt, q, k, v, case, 0,
                                   grad=torch.randn_like(q))()
            else:
                with torch.no_grad():
                    mid = case["offsets"][len(case["offsets"]) // 2]
                    _library_attention(rt, q, k, v, case, mid)()
            torch.cuda.synchronize()
        except Exception:             # the hold records the error
            pass
        print(f"library yardstick: compile {i + 1}/{len(jobs)} "
              f"({case['phase']}{', backward' if grad else ''}) done "
              f"{time.perf_counter() - t0:.1f} s after the process "
              f"started", flush=True)


def _start_library_warmer(rt):
    """The process of ``_warm_library`` over ``_library_jobs``; returns
    (process, jobs)."""
    import multiprocessing as mp
    jobs = _library_jobs(rt)
    proc = mp.get_context("spawn").Process(target=_warm_library,
                                           args=(jobs,), daemon=True)
    proc.start()
    return proc, len(jobs)


def _library_warmer_state(warmer, t_start, stop=False):
    """Prints whether the warming process is still compiling; with
    ``stop``, stops it if it is."""
    proc, n = warmer
    running = proc.is_alive()
    if stop:
        proc.terminate()
        proc.join()
    print(f"library yardstick: the {n} flex_attention compiles "
          f"{'still running' if running else 'ended'} at "
          f"{time.perf_counter() - t_start:.1f} s"
          f"{' (stopped)' if stop and running else ''}", flush=True)


def _lm_counts(rt, rows, where, want):
    """This run's K5 launches by shape onto the held rows, checked
    against ``want`` (launches per phase), and by variant against the
    variant each held shape names; no LDA kernel may launch."""
    if any(rt.counts().values()):
        raise AssertionError(f"{where}: an LDA kernel launched: "
                             f"{rt.counts()}")
    by_key = {r["key"]: r for r in rows}
    got = {}
    for key, n in rt.flash_ops.launches_by_shape.items():
        row = by_key.get(key)
        if row is None:
            raise AssertionError(f"{where}: flash_attention launched {n} "
                                 f"times at {key}, a shape no row holds")
        row["launches"] += n
        got[row["phase"]] = n
    if rt.flash_ops.launches != sum(got.values()) or got != want:
        raise AssertionError(f"{where}: launches by shape {got}, want "
                             f"{want}")
    want_var = {}
    for key, n in rt.flash_ops.launches_by_shape.items():
        var = by_key[key]["variant"]
        want_var[var] = want_var.get(var, 0) + n
    if rt.flash_ops.launches_by_variant != want_var:
        raise AssertionError(f"{where}: launches by variant "
                             f"{rt.flash_ops.launches_by_variant}, want "
                             f"{want_var}")
    print(f"{where}: flash_attention launches by shape {got}, by variant "
          f"{want_var}", flush=True)


def _profile_decode(rt, cfg, params, dev, steps=8):
    """``torch.profiler`` over ``steps`` bf16 decode steps at serving's
    shape (a fresh cache filled to the prompt first): the card's idle
    share over the window, and the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    b, s0 = LM["batch"], LM["prompt"]
    caches = rt.lm.init_caches(cfg, b, s0 + LM["gen"], dev)
    tok = torch.zeros((b, 1), dtype=torch.long, device=dev)
    for i in range(s0):
        caches = rt.lm.decode_step(cfg, params, tok, caches, i).caches

    def window():
        for i in range(s0, s0 + steps):
            rt.lm.decode_step(cfg, params, tok, caches, i)

    plain_wall, _ = _seconds(window)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _ = _seconds(window)
    on_dev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_dev) / 1e3
    top = sorted(on_dev, key=lambda e: -e.self_device_time_total)[:8]
    out = {"steps": steps, "wall_ms_per_step": 1e3 * plain_wall / steps,
           "profiled_wall_ms_per_step": 1e3 * wall / steps,
           "device_busy_ms_per_step": busy_ms / steps,
           "device_idle_share": 1.0 - busy_ms / (1e3 * plain_wall),
           "device_entries_per_step": sum(e.count for e in on_dev) / steps,
           "top_device_ms_per_step": [
               [e.key[:80], e.self_device_time_total / 1e3 / steps,
                e.count / steps] for e in top]}
    print(f"profile, gemma2-2b decode B={b} at positions {s0}..."
          f"{s0 + steps - 1}: {json.dumps(out)} | {rt.card}", flush=True)
    return out


def _profile_prefill(rt, cfg, params, toks):
    """``torch.profiler`` over one bf16 ``forward`` at the prefill shape:
    the card's busy time and the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, out = _seconds(lambda: rt.lm.forward(cfg, params, toks))
    del out
    on_dev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_dev) / 1e3
    top = sorted(on_dev, key=lambda e: -e.self_device_time_total)[:8]
    res = {"profiled_wall_s": wall, "device_busy_ms": busy_ms,
           "device_entries": sum(e.count for e in on_dev),
           "top_device_ms": [[e.key[:80], e.self_device_time_total / 1e3,
                              e.count] for e in top]}
    print(f"profile, gemma2-2b prefill B=1 S={PREFILL_S}: "
          f"{json.dumps(res)} | {rt.card}", flush=True)
    return res


@torch.no_grad()
def _drive_lm(rt, dev):
    """The LM phase: K5 held at every shape first; then serving through
    ``launch.serve.main`` (counted), the float32 forward/decode
    consistency at full width (counted), the bf16 prefill at S=8192
    (counted) and a profiled window of decode steps. Returns (rows,
    the ``lm_serving`` numbers)."""
    cfg = dataclasses.replace(rt.get_config(LM["arch"]),
                              n_layers=LM["layers"])
    cases = _flash_cases(rt)
    rows = [_hold_flash(rt, dev, c, 90 + i) for i, c in enumerate(cases)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    per_layer = {kind: sum(1 for i in range(cfg.n_layers)
                           if (i % 2 == 0) == (kind == "local"))
                 for kind in ("local", "global")}
    steps = LM["prompt"] + LM["gen"] - 1

    # serving through the entry point a user calls
    torch.cuda.reset_peak_memory_stats()
    rt.zero_counts()
    served = rt.lm_serve.main(LM_ARGS)
    torch.cuda.synchronize()
    serve_peak = torch.cuda.max_memory_allocated()
    del served["params"]
    if rt.flash_ops.launches != cfg.n_layers * steps:
        raise AssertionError(f"serving: {rt.flash_ops.launches} K5 launches"
                             f", want {cfg.n_layers} x {steps}")
    _lm_counts(rt, rows, "lm serving", {f"decode_{k}": n * steps
                                        for k, n in per_layer.items()})
    tokens = served["tokens"]
    if (tuple(tokens.shape) != (LM["batch"], steps + 1)
            or int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab_size):
        raise AssertionError(f"served tokens {tuple(tokens.shape)} out of "
                             f"shape or vocabulary")
    torch.cuda.empty_cache()

    # float32 consistency at full width: forward against teacher-forced
    # decode_step (tests/test_decode_consistency.py's check, rel < 2e-3)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = rt.lm.init_decoder_lm(
        cfg32, torch.Generator(device=dev).manual_seed(1))
    g = torch.Generator(device=dev).manual_seed(2)
    b, s0 = LM["batch"], LM["prompt"]
    toks = torch.randint(0, cfg.vocab_size, (b, s0), generator=g, device=dev)
    rt.zero_counts()
    full = rt.lm.forward(cfg32, params, toks).logits
    caches = rt.lm.init_caches(cfg32, b, s0, dev)
    dec = torch.empty_like(full)
    for t in range(s0):
        out = rt.lm.decode_step(cfg32, params, toks[:, t:t + 1], caches, t)
        caches = out.caches
        dec[:, t] = out.logits[:, 0]
    torch.cuda.synchronize()
    _lm_counts(rt, rows, "f32 consistency",
               {**{f"f32_forward_{k}": n for k, n in per_layer.items()},
                **{f"f32_decode_{k}": n * s0 for k, n in per_layer.items()}})
    rel = float((dec - full).abs().max() / (full.abs().max() + 1e-9))
    if not (rel < 2e-3 and bool(torch.isfinite(full).all())):
        raise AssertionError(f"f32 decode vs forward at full width: rel "
                             f"{rel} (limit 2e-3)")
    print(f"gemma2-2b f32 forward vs teacher-forced decode_step [{b}, {s0}]:"
          f" rel max err {rel:.3g} (limit 2e-3) | {rt.card}", flush=True)
    del params, caches, full, dec, out
    torch.cuda.empty_cache()

    # bf16 prefill at S=8192 through forward, and a profiled decode window
    params = rt.lm.init_decoder_lm(
        cfg, torch.Generator(device=dev).manual_seed(LM["seed"]))
    toks = torch.randint(0, cfg.vocab_size, (1, PREFILL_S), generator=g,
                         device=dev)
    torch.cuda.reset_peak_memory_stats()
    rt.zero_counts()
    prefill_s, out = _seconds(lambda: rt.lm.forward(cfg, params, toks))
    prefill_peak = torch.cuda.max_memory_allocated()
    _lm_counts(rt, rows, f"prefill S={PREFILL_S}",
               {f"prefill_{k}": n for k, n in per_layer.items()})
    if (tuple(out.logits.shape) != (1, PREFILL_S, cfg.vocab_size)
            or not bool(torch.isfinite(out.logits).all())):
        raise AssertionError("prefill logits misshapen or not finite")
    del out
    torch.cuda.empty_cache()
    prefill_profile = _profile_prefill(rt, cfg, params, toks)
    torch.cuda.empty_cache()
    k5_prefill_ms = sum(r["ms"] * r["launches"] for r in rows
                        if r["phase"].startswith("prefill"))
    print(f"gemma2-2b prefill B=1 S={PREFILL_S} bf16: {prefill_s:.3f} s "
          f"(K5 {k5_prefill_ms:.1f} ms of it), peak "
          f"{prefill_peak / 1e9:.2f} GB | {rt.card}", flush=True)

    # bf16 decode against a long cache: LONG_STEPS steps at the last
    # positions of an S=8192 cache filled with random keys and values (the
    # window bites on local layers; K5 splits the keys over blocks)
    caches = rt.lm.init_caches(cfg, LM["batch"], PREFILL_S, dev)
    for c in caches:
        c.k.normal_(generator=g)
        c.v.normal_(generator=g)
    tok = torch.randint(0, cfg.vocab_size, (LM["batch"], 1), generator=g,
                        device=dev)

    def long_decode():
        out = None
        for i in range(PREFILL_S - LONG_STEPS, PREFILL_S):
            out = rt.lm.decode_step(cfg, params, tok, caches, i)
        return out
    rt.zero_counts()
    long_s, out = _seconds(long_decode)
    _lm_counts(rt, rows, f"decode against an S={PREFILL_S} cache",
               {f"decode_long_{k}": n * LONG_STEPS
                for k, n in per_layer.items()})
    if (tuple(out.logits.shape) != (LM["batch"], 1, cfg.vocab_size)
            or not bool(torch.isfinite(out.logits).all())):
        raise AssertionError("long-cache decode logits misshapen or not "
                             "finite")
    del caches, out
    torch.cuda.empty_cache()
    k5_long_ms = sum(r["ms"] * r["launches"] for r in rows
                     if r["phase"].startswith("decode_long"))
    print(f"gemma2-2b decode B={LM['batch']} against an S={PREFILL_S} "
          f"cache: {1e3 * long_s / LONG_STEPS:.2f} ms a step (K5 "
          f"{k5_long_ms / LONG_STEPS:.3f} ms of it) | {rt.card}", flush=True)
    profile = _profile_decode(rt, cfg, params, dev)
    del params
    torch.cuda.empty_cache()

    k5_decode_ms = sum(r["ms"] * r["launches"] for r in rows
                       if r["phase"] in ("decode_local", "decode_global"))
    lm = {"arch": cfg.name, "layers": cfg.n_layers,
          "n_params": cfg.n_params(),
          "batch": LM["batch"], "prompt_len": LM["prompt"],
          "gen": LM["gen"], "decode_steps": steps,
          "prefill_s": served["prefill_sec"],
          "decode_s": served["decode_sec"],
          "decode_tok_per_s": served["decode_tok_per_sec"],
          "serve_peak_mem_gb": serve_peak / 1e9,
          "k5_ms_in_serving": k5_decode_ms,
          "k5_launches_in_serving": cfg.n_layers * steps,
          "f32_decode_vs_forward_rel": rel,
          "prefill_8192_s": prefill_s,
          "prefill_8192_k5_ms": k5_prefill_ms,
          "prefill_8192_peak_mem_gb": prefill_peak / 1e9,
          "prefill_8192_profile": prefill_profile,
          "long_cache_decode_ms_per_step": 1e3 * long_s / LONG_STEPS,
          "long_cache_k5_ms_per_step": k5_long_ms / LONG_STEPS,
          "init_s": served["init_sec"],
          "decode_profile": profile, "card": rt.card}
    print(f"gemma2-2b ({cfg.n_layers} of 26 layers) serving B="
          f"{LM['batch']} prompt {LM['prompt']} gen "
          f"{LM['gen']}: prefill {lm['prefill_s']:.3f} s, decode "
          f"{lm['decode_s']:.3f} s = {lm['decode_tok_per_s']:.1f} tok/s, "
          f"peak {lm['serve_peak_mem_gb']:.2f} GB | {rt.card}", flush=True)
    return rows, lm


def _drive_lm9(rt, dev):
    """gemma2-9b (d=3584, GQA 16/8, head_dim 256; its 42 layers cut to
    ``LM9["layers"]``): K5 held at every shape first, then ``launch.serve.main`` at full width in bf16
    (counted) and the float32 forward/decode consistency at a short
    prompt (counted). Returns (rows, numbers)."""
    cfg = dataclasses.replace(rt.get_config(LM9["arch"]),
                              n_layers=LM9["layers"])
    t0 = time.perf_counter()
    rows = [_hold_flash(rt, dev, c, 130 + i) for i, c in
            enumerate(_flash_cases(rt, LM9, prefix="9b_", long=False))]
    hold_s = time.perf_counter() - t0   # lint: allow(timer-no-barrier)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    per_layer = {kind: sum(1 for i in range(cfg.n_layers)
                           if (i % 2 == 0) == (kind == "local"))
                 for kind in ("local", "global")}
    steps = LM9["prompt"] + LM9["gen"] - 1
    torch.cuda.reset_peak_memory_stats()
    rt.zero_counts()
    served = rt.lm_serve.main(LM9_ARGS)
    torch.cuda.synchronize()
    serve_peak = torch.cuda.max_memory_allocated()
    del served["params"]
    _lm_counts(rt, rows, "gemma2-9b serving",
               {f"9b_decode_{k}": n * steps for k, n in per_layer.items()})
    tokens = served["tokens"]
    if (tuple(tokens.shape) != (LM9["batch"], steps + 1)
            or int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab_size):
        raise AssertionError("gemma2-9b served tokens out of shape or "
                             "vocabulary")
    del tokens
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = rt.lm.init_decoder_lm(
        cfg32, torch.Generator(device=dev).manual_seed(1))
    g = torch.Generator(device=dev).manual_seed(2)
    b, s0 = LM9["batch"], LM9["f32_prompt"]
    toks = torch.randint(0, cfg.vocab_size, (b, s0), generator=g, device=dev)
    rt.zero_counts()
    full = rt.lm.forward(cfg32, params, toks).logits
    caches = rt.lm.init_caches(cfg32, b, s0, dev)
    dec = torch.empty_like(full)
    for t in range(s0):
        out = rt.lm.decode_step(cfg32, params, toks[:, t:t + 1], caches, t)
        caches = out.caches
        dec[:, t] = out.logits[:, 0]
    torch.cuda.synchronize()
    _lm_counts(rt, rows, "gemma2-9b f32 consistency",
               {**{f"9b_f32_forward_{k}": n for k, n in per_layer.items()},
                **{f"9b_f32_decode_{k}": n * s0
                   for k, n in per_layer.items()}})
    rel = float((dec - full).abs().max() / (full.abs().max() + 1e-9))
    f32_s = time.perf_counter() - t0   # lint: allow(timer-no-barrier)
    if not (rel < 2e-3 and bool(torch.isfinite(full).all())):
        raise AssertionError(f"gemma2-9b f32 decode vs forward: rel {rel} "
                             f"(limit 2e-3)")
    del params, caches, full, dec, out
    torch.cuda.empty_cache()
    k5_ms = sum(r["ms"] * r["launches"] for r in rows
                if r["phase"] in ("9b_decode_local", "9b_decode_global"))
    lm9 = {"arch": cfg.name, "layers": cfg.n_layers,
           "n_params": cfg.n_params(), "batch": LM9["batch"], "prompt_len": LM9["prompt"],
           "gen": LM9["gen"], "weight_draw_s": served["init_sec"],
           "prefill_s": served["prefill_sec"],
           "decode_s": served["decode_sec"],
           "decode_tok_per_s": served["decode_tok_per_sec"],
           "serve_peak_mem_gb": serve_peak / 1e9,
           "k5_ms_in_serving": k5_ms,
           "k5_launches_in_serving": cfg.n_layers * steps,
           "f32_prompt": s0, "f32_decode_vs_forward_rel": rel,
           "k5_holds_s": hold_s, "f32_check_s": f32_s, "card": rt.card}
    print(f"gemma2-9b ({cfg.n_layers} of 42 layers) serving B="
          f"{LM9['batch']} prompt {LM9['prompt']} gen "
          f"{LM9['gen']}: weights drawn in {lm9['weight_draw_s']:.2f} s, "
          f"prefill {lm9['prefill_s']:.3f} s, decode {lm9['decode_s']:.3f} "
          f"s = {lm9['decode_tok_per_s']:.1f} tok/s, peak "
          f"{lm9['serve_peak_mem_gb']:.2f} GB; f32 forward vs decode_step "
          f"[{b}, {s0}] rel {rel:.3g}; K5 holds {hold_s:.1f} s, f32 check "
          f"{f32_s:.1f} s | {rt.card}", flush=True)
    return rows, lm9


# --------------------------------------------------------------------------
# The LM families: MoE, hybrid Mamba2, xLSTM, VLM, encoder-decoder
# --------------------------------------------------------------------------

def _family_cfg(rt, run, **updates):
    """The run's config at full width, its depth cut to ``run["layers"]``
    (an encoder-decoder keeps both stacks)."""
    cfg = rt.get_config(run["arch"])
    if run["layers"]:
        updates["n_layers"] = run["layers"]
    return dataclasses.replace(cfg, **updates)


def _attention_layers(cfg):
    """K5 launches of one decode step (and of one forward): a layer each
    for dense, vlm and moe, a stage each for hybrid, none for ssm; an
    encoder-decoder's decoder layer launches two (self, cross)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "ssm":
        return 0
    return cfg.n_layers


def _family_flash_cases(rt):
    """Every K5 shape the families phase launches: each family's served
    decode (bf16, B=4, S_max=160), its float32 check's forward and decode
    (S=128), pixtral's bf16 forward with its 256 image tokens, and
    whisper's non-causal launches: the encoder at 1,500 frames and the
    cross decode against them, in bf16 and in the float32 check (with its
    cross forward)."""
    bf16, f32 = torch.bfloat16, torch.float32
    b, s_max, sf = FAM["batch"], FAM["prompt"] + FAM["gen"], FAM["f32_prompt"]
    cases = []
    for run in FAMILY_RUNS:
        cfg, tag = rt.get_config(run["arch"]), run["tag"]
        if cfg.family == "ssm":
            continue
        base = dict(h=cfg.n_heads, hkv=cfg.n_kv, d=cfg.hd,
                    softcap=cfg.attn_softcap,
                    scale=cfg.query_scale or cfg.hd ** -0.5,
                    window=rt.flash_ops.GLOBAL_WINDOW, kind="global", b=b)
        group = cfg.n_heads // cfg.n_kv
        cases.append(dict(base, phase=f"{tag}_decode", sq=1, sk=s_max,
                          dtype=bf16, tol=3e-2, variant="decode",
                          offsets=(0, s_max // 2 - 1, s_max - 2)))
        cases += [
            dict(base, phase=f"{tag}_f32_forward", sq=sf, sk=sf, dtype=f32,
                 tol=2e-5, variant=rt.flash_ops.variant(f32, sf, cfg.hd,
                                                        group),
                 offsets=(0,), control="bf16"),
            dict(base, phase=f"{tag}_f32_decode", sq=1, sk=sf, dtype=f32,
                 tol=2e-5, variant="decode", control="bf16",
                 offsets=(0, sf // 2 - 1, sf - 1))] \
            if run["f32"] is not None else []
        if cfg.family == "vlm":
            n = cfg.n_image_tokens + FAM["prompt"]
            cases.append(dict(base, phase=f"{tag}_image_forward", sq=n, sk=n,
                              dtype=bf16, tol=3e-2, variant="wgmma",
                              offsets=(0,), control="tile"))
        if cfg.family == "encdec":
            t, nc = cfg.max_source_len, dict(base, causal=False)
            cases += [
                dict(nc, phase=f"{tag}_encoder", sq=t, sk=t, dtype=bf16,
                     tol=3e-2, variant="wgmma", offsets=(0,)),
                dict(nc, phase=f"{tag}_cross_decode", sq=1, sk=t,
                     dtype=bf16, tol=3e-2, variant="decode", offsets=(0,)),
                dict(nc, phase=f"{tag}_f32_encoder", sq=t, sk=t, dtype=f32,
                     tol=2e-5, variant="fma", offsets=(0,), control="bf16"),
                dict(nc, phase=f"{tag}_f32_cross_forward", sq=sf, sk=t,
                     dtype=f32, tol=2e-5, variant="fma", offsets=(0,),
                     control="bf16"),
                dict(nc, phase=f"{tag}_f32_cross_decode", sq=1, sk=t,
                     dtype=f32, tol=2e-5, variant="decode", offsets=(0,),
                     control="bf16")]
    return cases


def _family_params(rt, cfg, seed, dev):
    """Weights drawn on the card from a seeded CUDA generator (not the
    CPU draw of the same seed), timed with the card drained."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed)
    params = (rt.encdec.init_encdec(cfg, g) if cfg.family == "encdec"
              else rt.lm.init_decoder_lm(cfg, g))
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0   # lint: allow(timer-no-barrier)


def _k5_ms(rows, want):
    """K5's held ms times the launches ``want`` names, summed."""
    by_phase = {r["phase"]: r["ms"] for r in rows}
    return sum(by_phase[ph] * n for ph, n in want.items())


def _family_f32_check(rt, dev, run, cfg, prompt, frames, rows):
    """The float32 forward (``forward_encdec`` for whisper) against the
    same prompt teacher-forced through the cached step, at full width
    (rel max error of the logits < 2e-3,
    ``tests/test_decode_consistency.py``'s bound), K5 counted."""
    tag, sf = run["tag"], FAM["f32_prompt"]
    cfg32 = dataclasses.replace(cfg, dtype="float32", **run["f32"])
    params, _ = _family_params(rt, cfg32, FAM["seed"] + 1, dev)
    b, toks = prompt.shape[0], prompt[:, :sf]
    n = _attention_layers(cfg32)
    t0 = time.perf_counter()
    rt.zero_counts()
    if cfg32.family == "encdec":
        fr = frames.float()
        full = rt.encdec.forward_encdec(cfg32, params, toks, fr).logits
        caches = rt.encdec.init_encdec_caches(cfg32, params, fr, b, sf)
        step = rt.encdec.decode_step_encdec
        want = {f"{tag}_f32_encoder": 2 * cfg32.n_encoder_layers,
                f"{tag}_f32_forward": n, f"{tag}_f32_cross_forward": n,
                f"{tag}_f32_decode": n * sf,
                f"{tag}_f32_cross_decode": n * sf}
    else:
        full = rt.lm.forward(cfg32, params, toks).logits
        caches = rt.lm.init_caches(cfg32, b, sf, dev)
        step = rt.lm.decode_step
        want = ({f"{tag}_f32_forward": n, f"{tag}_f32_decode": n * sf}
                if n else {})
    dec = torch.empty_like(full)
    for t in range(sf):
        out = step(cfg32, params, toks[:, t:t + 1], caches, t)
        caches = out.caches
        dec[:, t] = out.logits[:, 0]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0   # lint: allow(timer-no-barrier)
    _lm_counts(rt, rows, f"{tag} f32 consistency", want)
    rel = float((dec - full).abs().max() / (full.abs().max() + 1e-9))
    if not (rel < 2e-3 and bool(torch.isfinite(full).all())):
        raise AssertionError(f"{cfg.name} f32 decode vs forward at full "
                             f"width: rel {rel} (limit 2e-3)")
    print(f"{cfg.name} ({cfg32.n_layers} layers"
          f"{', ' + cfg32.moe_impl if cfg32.family == 'moe' else ''}) f32 "
          f"forward vs teacher-forced step [{b}, {sf}]: rel max err "
          f"{rel:.3g} (limit 2e-3), {secs:.2f} s | {rt.card}", flush=True)
    del params, caches, full, dec, out
    torch.cuda.empty_cache()
    return rel, secs


@torch.no_grad()
def _drive_family(rt, dev, run, rows):
    """One family: its weights drawn on the card, ``launch.serve.generate``
    at B=4, prompt 128, 32 new tokens (counted: K5's launches by shape and
    variant; whisper's encoder and cross caches built first, from 1,500
    stub frames), pixtral's forward with image embeddings (counted), then
    the float32 check. Returns the family's numbers."""
    cfg, tag = _family_cfg(rt, run), run["tag"]
    b, s0, gen = FAM["batch"], FAM["prompt"], FAM["gen"]
    steps = s0 + gen - 1
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, draw_s = _family_params(rt, cfg, FAM["seed"], dev)
    weights_gb = torch.cuda.memory_allocated() / 1e9
    cpu = torch.Generator().manual_seed(FAM["seed"])
    prompt = torch.randint(0, cfg.vocab_size, (b, s0), generator=cpu).to(dev)
    frames = (rt.frontends.audio_frames_stub(cfg, cpu, b, device=dev)
              if cfg.family == "encdec" else None)
    n = _attention_layers(cfg)
    rt.zero_counts()
    tokens, stats = rt.lm_serve.generate(cfg, params, prompt, gen,
                                         frames=frames)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    want = {f"{tag}_decode": n * steps} if n else {}
    if cfg.family == "encdec":
        want.update({f"{tag}_cross_decode": n * steps,
                     f"{tag}_encoder": cfg.n_encoder_layers})
    _lm_counts(rt, rows, f"{tag} serving", want)
    if (tuple(tokens.shape) != (b, s0 + gen) or int(tokens.min()) < 0
            or int(tokens.max()) >= cfg.vocab_size):
        raise AssertionError(f"{cfg.name}: served tokens out of shape or "
                             f"vocabulary")
    out = {"arch": cfg.name, "family": cfg.family, "layers": cfg.n_layers,
           "n_params": cfg.n_params(), "weights_gb": weights_gb,
           "weight_draw_s": draw_s, "batch": b, "prompt_len": s0,
           "gen": gen, "decode_steps": steps,
           "caches_s": stats["caches_sec"],
           "prefill_s": stats["prefill_sec"], "decode_s": stats["decode_sec"],
           "decode_tok_per_s": stats["decode_tok_per_sec"],
           "serve_peak_mem_gb": peak / 1e9,
           "k5_launches_per_step": (2 if cfg.family == "encdec" else 1) * n,
           "k5_ms_in_serving": _k5_ms(rows, want)}
    if cfg.family == "vlm":
        images = rt.frontends.image_patches_stub(cfg, cpu, b, device=dev)
        rt.zero_counts()
        secs, fwd = _seconds(lambda: rt.lm.forward(cfg, params, prompt,
                                                   image_embeds=images))
        _lm_counts(rt, rows, f"{tag} forward with images",
                   {f"{tag}_image_forward": n})
        want_shape = (b, cfg.n_image_tokens + s0, cfg.vocab_size)
        if (tuple(fwd.logits.shape) != want_shape
                or not bool(torch.isfinite(fwd.logits).all())):
            raise AssertionError(f"{cfg.name}: forward with images "
                                 f"misshapen or not finite")
        out["image_forward_s"] = secs
        del fwd, images
    del params
    torch.cuda.empty_cache()
    if run["f32"] is not None:
        out["f32_decode_vs_forward_rel"], out["f32_check_s"] = \
            _family_f32_check(rt, dev, run, cfg, prompt, frames, rows)
    out["card"] = rt.card
    print(f"{cfg.name} ({cfg.n_layers} layers, {cfg.n_params() / 1e9:.2f} B"
          f" params, {weights_gb:.1f} GB) serving B={b} prompt {s0} gen "
          f"{gen}: weights drawn on the card in {draw_s:.2f} s, caches "
          f"{out['caches_s']:.3f} s, prefill {out['prefill_s']:.3f} s, "
          f"decode {out['decode_s']:.3f} s = {out['decode_tok_per_s']:.1f} "
          f"tok/s, peak {out['serve_peak_mem_gb']:.2f} GB, K5 "
          f"{out['k5_ms_in_serving']:.2f} ms of it | {rt.card}", flush=True)
    return out


def _drive_families(rt, dev, lap):
    """The families phase: K5 held at every shape first (non-causal and
    D=80 among them), then each family in ``FAMILY_RUNS``. Returns (rows,
    the ``families`` numbers)."""
    t0 = time.perf_counter()
    rows = [_hold_flash(rt, dev, c, 400 + i)
            for i, c in enumerate(_family_flash_cases(rt))]
    hold_s = time.perf_counter() - t0   # lint: allow(timer-no-barrier)
    torch.cuda.empty_cache()
    lap("families K5 holds")
    out = {"k5_holds_s": hold_s}
    for run in FAMILY_RUNS:
        out[run["tag"]] = _drive_family(rt, dev, run, rows)
        lap(f"{run['tag']} serving")
    return rows, out


def _drive_scale_sim(rt, dev, full_rows, cfg_lda, corpus):
    """FULL's sync run with ``vocab_shards=4`` against the same run at
    ``vocab_shards=1`` from the same initial statistic (bit for bit: the
    shard axis is a view), its launches at the held full-width shapes,
    rounds/s and peak memory; then saved at round 20, killed (step 40
    deleted, an uncommitted step-40 directory left) and resumed, bit for
    bit against the uninterrupted run."""
    f = FULL
    spec = rt.evaluation.EvalSpec(words=corpus.test_words,
                                  mask=corpus.test_mask,
                                  key=rt.tf3.key(1, dev), n_particles=10,
                                  probe_nodes=f["probes"])
    sched, degs = rt.deleda.make_run_inputs(
        rt.graph.complete_graph(f["n"]), f["rounds"], seed=0,
        kind="matching")

    def cfg(shards):
        return rt.deleda.DeledaConfig(lda=cfg_lda, mode="sync",
                                      batch_size=f["batch"],
                                      eval_every=f["every"],
                                      vocab_shards=shards)

    one = rt.deleda.init_state(cfg(1), rt.tf3.key(3, dev), f["n"])
    four = dataclasses.replace(one, stats=one.stats.reshape(
        f["n"], f["k"], SCALE_SHARDS, f["v"] // SCALE_SHARDS))

    def run(shards, state, **kw):
        return rt.deleda.run_deleda(cfg(shards), state.key, corpus.words,
                                    corpus.mask, sched, degs, f["rounds"],
                                    record_every=f["every"], eval_spec=spec,
                                    init=state, **kw)

    dense = run(1, one)
    want_stats, want_lp = dense.stats.cpu(), dense.eval_lp.cpu()
    want_cons = dense.consensus.cpu()
    del dense
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rt.zero_counts()
    wall, trace = _seconds(lambda: run(SCALE_SHARDS, four))
    peak = torch.cuda.max_memory_allocated()
    where = f"scale: vocab_shards={SCALE_SHARDS} sync matching complete"
    got = _tally(rt, full_rows, where)
    e = _expected("sync", sched, f["every"])
    _check_phases(where, got, {"full_sync_mix": e["gossip_mix"],
                               "full_sync": e["lda_gibbs"],
                               "full_inloop": e["lda_l2r"]})
    if tuple(trace.state.stats.shape) != (f["n"], f["k"], SCALE_SHARDS,
                                          f["v"] // SCALE_SHARDS):
        raise AssertionError(f"{where}: carried {trace.state.stats.shape}")
    same = (torch.equal(trace.stats.cpu(), want_stats)
            and torch.equal(trace.eval_lp.cpu(), want_lp)
            and torch.equal(trace.consensus.cpu(), want_cons))
    if not same:
        err = float((trace.stats.cpu() - want_stats).abs().max())
        raise AssertionError(f"{where}: differs from vocab_shards=1, max "
                             f"{err}")
    print(f"{where}: equal to vocab_shards=1 bit for bit (stats, LP, "
          f"consensus); {wall:.3f} s = {f['rounds'] / wall:.2f} rounds/s, "
          f"peak {peak / 1e9:.2f} GB | {rt.card}", flush=True)
    del trace
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as ckpt:
        run(SCALE_SHARDS, four, save_every=f["every"], checkpoint_dir=ckpt)
        _kill_step(ckpt, f["rounds"])
        rt.zero_counts()
        resume_s, resumed = _seconds(lambda: rt.deleda.run_deleda(
            cfg(SCALE_SHARDS), four.key, corpus.words, corpus.mask, sched,
            degs, f["rounds"], record_every=f["every"], eval_spec=spec,
            restore_from=ckpt))
        got = _tally(rt, full_rows, where + " (resumed)")
        half = f["rounds"] - f["every"]
        _check_phases(where + " (resumed)", got,
                      {"full_sync_mix": half, "full_sync": half,
                       "full_inloop": 1})
    if not (resumed.state.t == f["rounds"]
            and torch.equal(resumed.stats.cpu(), want_stats)
            and torch.equal(resumed.eval_lp.cpu(), want_lp[-1:])
            and torch.equal(resumed.consensus.cpu(), want_cons[-1:])):
        raise AssertionError(f"{where}: the resumed run differs")
    print(f"{where}: saved every {f['every']}, killed, resumed from "
          f"{f['every']} in {resume_s:.3f} s, bit for bit | {rt.card}",
          flush=True)
    del resumed, one, four
    torch.cuda.empty_cache()
    return {"vocab_shards": SCALE_SHARDS, "rounds": f["rounds"],
            "wall_s": wall, "rounds_per_s": f["rounds"] / wall,
            "peak_mem_gb": peak / 1e9, "bitwise_vs_vs1": True,
            "resume_s": resume_s, "resume_bitwise": True, "card": rt.card}


def _mesh_lda(rt, size):
    return rt.lda.LDAConfig(n_topics=size["k"], vocab_size=size["v"],
                            alpha=0.5, doc_len_max=size["l"],
                            n_gibbs=30 if size is FULL else 4,
                            n_gibbs_burnin=15 if size is FULL else 2)


def _mesh_rank(job):
    """One rank of a mesh phase (spawned by ``gossip_sim.launch``): runs
    ``job["runs"]`` through ``run_mesh_deleda`` with the launch counters
    set to 0 just before each, and returns on rank 0 every rank's counts
    by shape, peak memory and exchange/compute seconds, with rank 0's
    gathered results."""
    import torch.distributed as dist
    rt = _Port()
    from repro_torch.core import gossip
    from repro_torch.launch import gossip_sim
    out = {}
    for name, run in job["runs"]:
        if run.get("analysis"):
            # the analysis layer's mesh rows (and the planted doc gather)
            # in these ranks, their tensors on the card
            t0 = time.perf_counter()
            mine = rt.trace_audit.mesh_rank_ops(ANALYSIS_MESH, device="cuda")
            torch.cuda.synchronize()
            mine = {"ops": mine, "seconds": time.perf_counter() - t0}
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, mine)
            if dist.get_rank() == 0:
                out[name] = {
                    "ops": {n: [r["ops"][n] for r in every]
                            for n in ANALYSIS_MESH},
                    "seconds": max(r["seconds"] for r in every)}
            continue
        size = FULL if run.get("full") else MESH_TRAJ
        dev = run.get("device", "cuda")
        cfg_lda = _mesh_lda(rt, size)
        corpus = rt.data.make_corpus(
            cfg_lda, rt.tf3.key(0), rt.data.CorpusSpec(
                n_nodes=size["n"], docs_per_node=size["docs"],
                n_test=FULL["n_test"] if size is FULL else 4))
        spec = None
        if run.get("every"):
            spec = rt.evaluation.EvalSpec(
                words=corpus.test_words, mask=corpus.test_mask,
                key=rt.tf3.key(1), n_particles=10 if size is FULL else 3,
                probe_nodes=FULL["probes"] if size is FULL else 2)
        times = {"gossip": 0.0, "exchange": 0.0, "update": 0.0}
        real_mix, real_build = rt.comm.MeshComm.mix_matching, \
            gossip_sim.build_update_step
        real_exchange = gossip.exchange

        def sync():
            if dev == "cuda":
                torch.cuda.synchronize()

        def timed(key, fn):
            def wrapper(*a, **kw):
                sync()
                t0 = time.perf_counter()
                res = fn(*a, **kw)
                sync()
                # lint: allow(timer-no-barrier)
                times[key] += time.perf_counter() - t0
                return res
            return wrapper

        flat = run.get("flat")

        def mesh_run(rounds, every, spec):
            return gossip_sim.run_mesh_deleda(
                cfg_lda, corpus.words, corpus.mask,
                rt.graph.complete_graph(size["n"]), rounds, size["batch"],
                seed=0,
                mesh=(rt.comm.make_grid_mesh(*flat) if flat else None),
                mesh_shape=run.get("grid"), eval_every=every,
                eval_spec=spec, device=dev)

        # a full-width run's distributed calls are recorded (for
        # _audit_mesh), the update step's marked as its phase
        rec = rt.collectives.Recorder() if run.get("full") else None

        def build_update(*a, **kw):
            step = real_build(*a, **kw)
            if run.get("timed"):
                step = timed("update", step)
            if rec is None:
                return step

            def update(*args):
                rec.phase = "update"
                try:
                    return step(*args)
                finally:
                    rec.phase = "loop"
            return update

        warm = mesh_run(MESH_WARMUP, 0, None).seconds if run.get("full") \
            else None
        try:
            if run.get("timed"):
                rt.comm.MeshComm.mix_matching = timed("gossip", real_mix)
                gossip.exchange = timed("exchange", real_exchange)
            gossip_sim.build_update_step = build_update
            if dev == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            rt.zero_counts()
            with rec or contextlib.nullcontext():
                res = mesh_run(run["rounds"], run.get("every", 0), spec)
            sync()
        finally:
            rt.comm.MeshComm.mix_matching = real_mix
            gossip_sim.build_update_step = real_build
            gossip.exchange = real_exchange
        mine = {"by_shape": rt.by_shape(),
                "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                            if dev == "cuda" else 0.0),
                "times": times, "ops": [] if rec is None else rec.ops}
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        mc = rt.comm.MeshComm(rt.comm.make_grid_mesh(*run["grid"]),
                              vocab_axis="vocab") if run.get("grid") else \
            rt.comm.MeshComm(rt.comm.make_grid_mesh(*flat)) if flat else \
            rt.comm.MeshComm()
        sched = rt.comm.GossipSchedule.draw_matchings(
            rt.graph.complete_graph(size["n"]), run["rounds"],
            np.random.default_rng(0))
        wire = [mc.bytes_per_round((size["n"], size["k"], size["v"]), 4, p)
                for p in sched.data]
        if dist.get_rank() == 0:
            out[name] = {"stats": res.stats.cpu(), "steps": res.steps.cpu(),
                         "consensus": res.consensus,
                         "eval_lp": res.eval_lp, "seconds": res.seconds,
                         "warmup_seconds": warm,
                         "ranks": every, "world": dist.get_world_size(),
                         "wire_bytes_per_round": wire,
                         "partners": sched.data}
        del res
    return out


def _mesh_expected(rt, partners, n_dev, n_vocab, size, every, probes):
    """Launches a mesh run must make, summed over its ranks, by kernel
    shape: ``lda_gibbs`` once a round on every rank at B = n_local x
    batch; ``gossip_mix`` once a round on every rank whose node-device
    has an intra-rank pair (at that count of pairs); ``lda_l2r`` once an
    evaluation on the vocab-0 rank of the probe nodes' block."""
    n = size["n"]
    n_local, v_local = n // n_dev, size["v"] // n_vocab
    want = {("lda_gibbs", (n_local * size["batch"], size["l"], size["k"],
                           30 if size is FULL else 4)):
            n_dev * n_vocab * len(partners)}
    for row in partners:
        (_src, act), _passes = rt.comm._route_matching(row, n_dev)
        for a in range(n_dev):
            pairs = int(act[a * n_local:(a + 1) * n_local].sum()) // 2
            if pairs:
                key = ("gossip_mix", (n_local, size["k"], v_local, pairs))
                want[key] = want.get(key, 0) + n_vocab
    if every:
        key = ("lda_l2r", (probes * FULL["n_test"], size["l"], size["k"], 10,
                           False))
        want[key] = len(partners) // every
    return want


def _mesh_rows(rt, dev, want, phase, seed):
    """Each kernel shape a mesh run launches (``want``'s keys), held
    against its plain version."""
    rows = []
    for i, (name, key) in enumerate(sorted(want, key=str)):
        if name == "gossip_mix":
            n, k, v, pairs = key
            row = _hold_mix(rt, dev, dict(n=n, k=k, v=v, pairs=pairs),
                            seed + i)
        elif name == "lda_gibbs":
            b, l, k, s = key
            row = _hold_gibbs(rt, dev, dict(b=b, l=l, s=s, burnin=s // 2,
                                            lengths=("poisson", 2, l)),
                              k, FULL["v"], seed + i)
        else:
            b, l, k, p, _cw = key
            row = _hold_l2r(rt, dev, dict(b=b, l=l, p=p,
                                          lengths=("poisson", 2, l)),
                            k, FULL["v"], seed + i)
        row["phase"] = phase
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def _mesh_counts(rows, ranks, want, where):
    """The ranks' launches by shape, summed, onto the held rows and
    against ``want``."""
    got = {}
    for mine in ranks:
        for key, n in mine["by_shape"].items():
            got[key] = got.get(key, 0) + n
    if got != want:
        raise AssertionError(f"{where}: launches by shape {got}, the "
                             f"rounds and evals say {want}")
    by_key = {(r["name"], r["key"]): r for r in rows}
    for key, n in got.items():
        by_key[key]["launches"] += n
    print(f"{where}: launches by shape (summed over ranks) as the rounds "
          f"and evals imply: {sum(got.values())} launches", flush=True)


def _drive_mesh(rt, dev):
    """The mesh phases (slice 10). Returns (held rows, numbers)."""
    from repro_torch.launch import gossip_sim
    f = FULL
    cards = torch.cuda.device_count()
    world = max(r for r in range(1, cards + 1) if f["n"] % r == 0)
    rounds = f["rounds"]
    sched = rt.comm.GossipSchedule.draw_matchings(
        rt.graph.complete_graph(f["n"]), rounds, np.random.default_rng(0))
    want_nccl = _mesh_expected(rt, sched.data, world, 1, f, f["every"],
                               f["probes"])
    g_sched = sched.data[:MESH_GRID_ROUNDS]
    want_grid = _mesh_expected(rt, g_sched, 2, 2, f, 0, 0)
    want_flat = _mesh_expected(rt, g_sched, 2, 1, f, 0, 0)
    rows = (_mesh_rows(rt, dev, want_nccl, "mesh_nccl", 300)
            + _mesh_rows(rt, dev, {**want_grid, **want_flat}, "mesh_gloo",
                         400))
    t0 = time.perf_counter()
    nccl = gossip_sim.launch(_mesh_rank, world, "nccl", ({"runs": [
        ("nccl", {"full": True, "rounds": rounds, "every": f["every"],
                  "timed": True})]},), timeout_s=MESH_TIMEOUT_S)
    nccl_s = time.perf_counter() - t0   # lint: allow(timer-no-barrier)
    run = nccl["nccl"]
    _mesh_counts([r for r in rows if r["phase"] == "mesh_nccl"],
                 run["ranks"], want_nccl, f"mesh nccl x{world}")
    if not (bool(torch.isfinite(run["stats"]).all())
            and (run["steps"] == rounds).all()
            and run["eval_lp"].shape == (rounds // f["every"], f["probes"])
            and np.isfinite(run["eval_lp"]).all()):
        raise AssertionError("mesh nccl: non-finite or misshapen output")
    wire = run["wire_bytes_per_round"]
    nccl_out = {"ranks": world, "rounds": rounds,
                "seconds": run["seconds"],
                "rounds_per_s": rounds / run["seconds"],
                "warmup_seconds": run["warmup_seconds"],
                "per_round": {f"{t}_s": run["ranks"][0]["times"][t] / rounds
                              for t in ("gossip", "update")},
                "wire_bytes_per_round": float(np.mean(wire)),
                "peak_mem_gb_per_rank": [r["peak_gb"] for r in run["ranks"]],
                "k2_shape_per_rank": f"B={f['n'] // world * f['batch']} "
                                     f"L={f['l']} K={f['k']} S=30",
                "eval_lp": run["eval_lp"].tolist(),
                "consensus": run["consensus"], "spawn_and_run_s": nccl_s}
    nccl_out["audit"] = _audit_mesh(rt, run["ranks"], "mesh_nccl")
    note = ("" if world > 1 else
            "; one rank: every pair is intra-rank, no pass crosses ranks")
    print(f"mesh nccl: {world} rank(s) on {cards} card(s), {rounds} rounds "
          f"in {run['seconds']:.3f} s = {nccl_out['rounds_per_s']:.2f} "
          f"rounds/s (after {MESH_WARMUP} warm-up rounds in "
          f"{run['warmup_seconds']:.3f} s; a round's gossip "
          f"{nccl_out['per_round']['gossip_s']:.4f} s, update "
          f"{nccl_out['per_round']['update_s']:.4f} s), "
          f"{nccl_out['wire_bytes_per_round']:.0f} wire bytes a "
          f"round (bytes_per_round), peak "
          f"{nccl_out['peak_mem_gb_per_rank']} GB a rank{note} | {rt.card}",
          flush=True)
    del nccl, run
    torch.cuda.empty_cache()

    # the grid over gloo: 4 ranks on the one card, then the flat (2, 1)
    # mesh of the same seed in 2 ranks; and the grid's trajectory on the
    # card against the CPU at the test shapes
    t0 = time.perf_counter()
    grid = gossip_sim.launch(_mesh_rank, 4, "gloo", ({"runs": [
        ("grid", {"full": True, "rounds": MESH_GRID_ROUNDS, "grid": (2, 2),
                  "timed": True}),
        ("traj_cuda", {"rounds": MESH_TRAJ["rounds"], "grid": (2, 2),
                       "every": MESH_TRAJ["every"]}),
        ("traj_cpu", {"rounds": MESH_TRAJ["rounds"], "grid": (2, 2),
                      "every": MESH_TRAJ["every"], "device": "cpu"}),
        ("analysis", {"analysis": True})]},),
        timeout_s=MESH_TIMEOUT_S)
    grid_s = time.perf_counter() - t0   # lint: allow(timer-no-barrier)
    flat = gossip_sim.launch(_mesh_rank, 2, "gloo", ({"runs": [
        ("flat", {"full": True, "rounds": MESH_GRID_ROUNDS, "flat": (2, 1),
                  "timed": True})]},), timeout_s=MESH_TIMEOUT_S)
    gloo_rows = [r for r in rows if r["phase"] == "mesh_gloo"]
    _mesh_counts(gloo_rows, grid["grid"]["ranks"], want_grid,
                 "mesh gloo grid 2x2")
    _mesh_counts(gloo_rows, flat["flat"]["ranks"], want_flat,
                 "mesh gloo flat (2, 1)")
    g, fl = grid["grid"], flat["flat"]
    audits = {"grid": _audit_mesh(rt, g["ranks"], "mesh_gloo_grid",
                                  grid=(2, 2), rounds=MESH_GRID_ROUNDS),
              "flat": _audit_mesh(rt, fl["ranks"], "mesh_gloo_flat")}
    err = float((g["stats"] - fl["stats"]).abs().max())
    cons_rel = float(np.max(np.abs(np.array(g["consensus"])
                                   - np.array(fl["consensus"]))
                            / np.abs(np.array(fl["consensus"]))))
    if not (err < 1e-5 and cons_rel < 1e-4
            and torch.equal(g["steps"], fl["steps"])):
        raise AssertionError(f"mesh grid (2, 2) vs flat (2, 1): stats "
                             f"{err} (bound 1e-5), consensus rel {cons_rel} "
                             f"(bound 1e-4)")
    tc, tp = grid["traj_cuda"], grid["traj_cpu"]
    mass = abs(float(tc["stats"].double().sum() / tp["stats"].double().sum())
               - 1.0)
    ent = torch.isclose(tc["stats"], tp["stats"], rtol=3e-3, atol=1e-5)
    lp_rel = float(np.max(np.abs(tc["eval_lp"] / tp["eval_lp"] - 1.0)))
    if not (torch.equal(tc["steps"], tp["steps"]) and mass < 1e-4
            and bool(ent.all()) and lp_rel < 1e-5):
        raise AssertionError(f"mesh grid trajectory, card vs CPU: mass rel "
                             f"{mass}, entries {bool(ent.all())}, LP rel "
                             f"{lp_rel}")
    per_round = {k: {f"{t}_s": max(r["times"][t] for r in ranks)
                     / MESH_GRID_ROUNDS
                     for t in ("exchange", "gossip", "update")}
                 for k, ranks in (("grid", g["ranks"]),
                                  ("flat", fl["ranks"]))}
    gloo_out = {"rounds": MESH_GRID_ROUNDS,
                "grid_seconds": g["seconds"], "flat_seconds": fl["seconds"],
                "grid_warmup_seconds": g["warmup_seconds"],
                "flat_warmup_seconds": fl["warmup_seconds"],
                "grid_rounds_per_s": MESH_GRID_ROUNDS / g["seconds"],
                "flat_rounds_per_s": MESH_GRID_ROUNDS / fl["seconds"],
                "per_round": per_round,
                "grid_wire_bytes_per_round":
                    float(np.mean(g["wire_bytes_per_round"])),
                "flat_wire_bytes_per_round":
                    float(np.mean(fl["wire_bytes_per_round"])),
                "grid_peak_mem_gb_per_rank": [r["peak_gb"]
                                              for r in g["ranks"]],
                "grid_vs_flat_max_abs": err,
                "grid_vs_flat_consensus_rel": cons_rel,
                "traj_mass_rel": mass, "traj_lp_rel": lp_rel,
                "spawn_and_run_s": grid_s, "audit": audits}
    print(f"mesh gloo grid 2x2 on one card: {MESH_GRID_ROUNDS} rounds in "
          f"{g['seconds']:.3f} s (flat (2, 1): {fl['seconds']:.3f} s); a "
          f"round's exchange {per_round['grid']['exchange_s']:.3f} s (the "
          f"whole gossip step {per_round['grid']['gossip_s']:.3f} s) "
          f"against the update step {per_round['grid']['update_s']:.3f} s "
          f"(flat {per_round['flat']['exchange_s']:.3f} / "
          f"{per_round['flat']['gossip_s']:.3f} / "
          f"{per_round['flat']['update_s']:.3f}); wire bytes a round "
          f"{gloo_out['grid_wire_bytes_per_round']:.0f} (flat "
          f"{gloo_out['flat_wire_bytes_per_round']:.0f}); grid vs flat: "
          f"stats {err:.3g} (bound 1e-5), consensus rel {cons_rel:.3g} "
          f"(bound 1e-4); card vs CPU at the test shapes: mass rel "
          f"{mass:.3g}, LP rel {lp_rel:.3g}; recorded calls audited (grid "
          f"{audits['grid']['calls']}, flat {audits['flat']['calls']}): "
          f"no doc-shaped integer payload, the grid's update all-reduces "
          f"on the vocab lines | {rt.card}", flush=True)
    return rows, {"nccl": nccl_out, "gloo_grid": gloo_out, "card": rt.card,
                  "analysis_ranks": grid["analysis"]}


def _audit_mesh(rt, ranks, where, grid=None, rounds=0):
    """A full-width mesh run's recorded calls, every rank's: all of them
    under the privacy rule (no integer tensor whose trailing dim is the
    document length), and the update step's: on a node x vocab ``grid``
    only all-reduces over the rank's vocab line, two a round; on a 1-D
    mesh none. With one rank no payload collective may cross ranks."""
    ta = rt.trace_audit
    ops = [op for r in ranks for op in r["ops"]]
    world = len(ranks)
    report = ta.audit_ops(ops, ta.InvariantSpec(
        where, allowed_collectives=ta.GOSSIP_ALLOWED
        | {"all-reduce", "all-gather"}, doc_len=FULL["l"]))
    update = [op for op in ops if op.phase == "update"]
    want = 2 * rounds if grid else 0
    upd = ta.audit_ops(update, ta.InvariantSpec(
        f"{where} update", allowed_collectives=frozenset(
            {"all-reduce"} if grid else ()),
        max_counts=(("all-reduce", want),), doc_len=FULL["l"],
        replica_groups=ta._vocab_groups(grid) if grid else None,
        grouped_kinds=frozenset({"all-reduce"})))
    per_rank = [sum(op.rank == r for op in update) for r in range(world)]
    crossing = [op for op in ops if op.crosses_ranks]
    if (not report.ok or not upd.ok or per_rank != [want] * world
            or (world == 1 and crossing)):
        raise AssertionError(f"{where} audit: {report.summary()}; update "
                             f"step: {upd.summary()}, calls a rank "
                             f"{per_rank} (want {want}); calls that cross "
                             f"ranks: {len(crossing)}")
    return {"ranks": world, "calls": len(ops),
            "inventory": report.inventory,
            "update_inventory": upd.inventory,
            "payload_collectives_across_ranks": len(crossing),
            "note": ("one rank: every pair is intra-rank, and no payload "
                     "collective crosses ranks" if world == 1 else
                     "every call passes the privacy rule; " + (
                         "the update step's all-reduces run over the "
                         "vocab lines" if grid else
                         "the update step makes no collective"))}


# ----------------------------------------------------------------------------
# The training slice (PR 23): K1 in bf16, K5's gradient, the LM trainer
# ----------------------------------------------------------------------------

K5_NAMES = re.compile(r"flash_fwd_kernel|flash_wgmma_kernel|decode_kernel|"
                      r"combine_kernel")
MATMUL_NAMES = re.compile(r"gemm|nvjet|xmma|cutlass|cublas", re.I)


def _train_args(extra):
    return ["--arch", TRAIN["arch"], "--full", "--seq", str(TRAIN["seq"]),
            "--device", "cuda", *extra]


def _hold_mix_leaf(rt, dev, shape, pairs, seed, dtype=torch.bfloat16):
    """K1 on a parameter leaf's dtype (bfloat16, or float32 as the sLSTM's
    leaves) against its plain version (exact), and their times. Bound:
    two rows read and two written per pair."""
    n = shape[0]
    row = int(np.prod(shape[1:]))
    elem = 2 if dtype == torch.bfloat16 else 4
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    g = torch.Generator(device=dev).manual_seed(seed)
    stats = torch.randn(shape, generator=g, device=dev).to(dtype)
    partners = _mix_partners(n, pairs, seed)
    plan = rt.mix_ops.pairs_of(partners)
    plain_ms, want = _time_ms(
        lambda: rt.mix_ref.mix_pairs_ref_(stats.clone(), plan), reps=3)
    got = rt.mix_ops.mix_pairs_(stats.clone(), plan)
    err = float((got.float() - want.float()).abs().max())
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    if not torch.equal(got.view(bits), want.view(bits)):
        raise AssertionError(f"gossip_mix {name} differs from its plain "
                             f"version at {shape}, {pairs} pairs: max error "
                             f"{err}")
    # the bits are the sum halved in the leaf's dtype (the reference's op)
    i, j = (torch.as_tensor(plan[:, c], device=dev) for c in (0, 1))
    if not torch.equal(got[i].view(bits),
                       (0.5 * (stats[i] + stats[j])).view(bits)):
        raise AssertionError(f"gossip_mix {name} at {shape}: not the "
                             f"{name} 0.5 * (a + b)")
    del got, want
    work = stats.clone()
    ms, _ = _time_ms(lambda: rt.mix_ops.mix_pairs_(work, plan), reps=10,
                     warmup=2, device_only=True)
    bound, by = _bound(4 * pairs * row * elem, 2 * pairs * row)
    txt = f"[{', '.join(map(str, shape))}] {name} pairs={pairs}"
    print(f"gossip_mix vs plain at {txt}: exact; {ms:.4f} ms (plain "
          f"{plain_ms:.4f} ms, bound {bound:.5f} ms by {by}) | {rt.card}",
          flush=True)
    key = (*shape, pairs) + (("bf16",) if dtype == torch.bfloat16 else ())
    return dict(name="gossip_mix", key=key, shape=txt,
                phase="train_sync_sim", ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, max_abs_err=err, launches=0)


def _train_flash_cases(rt):
    """K5's shapes on the training path: gemma2-2b's at the standard run's
    batch and at the decentralized run's (bf16, "wgmma", local and
    global), and the smoke trajectory's float32 shape ("fma")."""
    cfg = rt.get_config(TRAIN["arch"])
    base = dict(h=cfg.n_heads, hkv=cfg.n_kv, d=cfg.hd,
                softcap=cfg.attn_softcap, scale=cfg.query_scale,
                sq=TRAIN["seq"], sk=TRAIN["seq"], dtype=torch.bfloat16,
                tol=3e-2, variant="wgmma", offsets=(0,), control="tile")
    cases = []
    for b, tag in ((TRAIN["batch"], "train"), (DEC["batch"], "dec")):
        for kind, window in (("local", cfg.window),
                             ("global", rt.flash_ops.GLOBAL_WINDOW)):
            cases.append(dict(base, b=b, window=window, kind=kind,
                              phase=f"{tag}_{kind}"))
    smoke = rt.smoke(rt.get_config(TRAJ["arch"]))
    cases.append(dict(phase="traj_f32", b=TRAJ["batch"], sq=TRAJ["seq"],
                      sk=TRAJ["seq"], h=smoke.n_heads, hkv=smoke.n_kv,
                      d=smoke.hd, softcap=smoke.attn_softcap,
                      scale=smoke.query_scale or smoke.hd ** -0.5,
                      window=rt.flash_ops.GLOBAL_WINDOW, kind="global",
                      dtype=torch.float32, tol=2e-5, variant="fma",
                      offsets=(0,), control="bf16"))
    return cases


def _hold_train_attention(rt, dev, case, seed):
    """K5's forward held as every other shape (``_hold_flash``), then its
    gradient: the wrapper's dQ/dK/dV (``ref.attention_bwd``) against
    ``torch.autograd.grad`` of the plain version on the same inputs and
    output gradient, each within ``BWD_TOL`` of that tensor's max (float32
    2e-5; bf16 1e-2: both compute in float32 from the same bf16 inputs,
    so they differ by the float32 sum order and one bf16 rounding of the
    result, under 4e-3 of an element). The backward is timed alone
    (CUDA events over its torch ops) beside its bound: 5 products of 2 D
    operations per visible pair and head (S, dP, dV, dQ, dK)."""
    row = _hold_flash(rt, dev, case, seed)
    b, sq, sk, h, hkv, d = (case[x] for x in ("b", "sq", "sk", "h", "hkv",
                                               "d"))
    g = torch.Generator(device=dev).manual_seed(seed + 1000)
    q, do = (torch.randn((b, sq, h, d), generator=g, device=dev).to(
        case["dtype"]) for _ in range(2))
    k, v = (torch.randn((b, sk, hkv, d), generator=g, device=dev).to(
        case["dtype"]) for _ in range(2))
    kw = dict(window=case["window"], softcap=case["softcap"],
              scale=case["scale"], causal=case.get("causal", True))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(rt.flash_ops.flash_attention(*leaves, **kw),
                              leaves, do)
    plain = [x.clone().requires_grad_() for x in (q, k, v)]

    def heads(x):
        return x.transpose(1, 2).reshape(-1, x.shape[1], d)

    def plain_grad():
        out = rt.flash_ref.attention_ref(*map(heads, plain), **kw)
        return torch.autograd.grad(out.reshape(b, h, sq, d).transpose(1, 2),
                                   plain, do)
    want = plain_grad()
    tol = BWD_TOL[case["dtype"]]
    rel = max(float((a.float() - w.float()).abs().max()
                    / w.float().abs().max()) for a, w in zip(got, want))
    if not (rel <= tol and all(bool(torch.isfinite(a).all()) for a in got)):
        raise AssertionError(f"attention backward at {case['phase']}: rel "
                             f"{rel} > {tol}")
    del got, want
    bwd_ms, _ = _time_ms(lambda: rt.flash_ref.attention_bwd(q, k, v, do,
                                                            **kw), reps=5)
    plain_bwd_ms, _ = _time_ms(plain_grad, reps=3)
    pairs, _keys = _visible(sq, sk, case["window"], 0, kw["causal"])
    peak = BF16_OPS_PER_S if case["dtype"] == torch.bfloat16 else \
        FP32_OPS_PER_S
    elem = 2 if case["dtype"] == torch.bfloat16 else 4
    bwd_bound, bwd_by = _bound(elem * (4 * b * sq * h * d
                                       + 4 * b * sk * hkv * d),
                               10 * b * h * pairs * d, peak)
    # the library's forward and backward together (a compiled
    # flex_attention and its compiled backward, or SDPA's), at the
    # standard runs' shapes and wherever SDPA is the library call: the
    # yardstick of K5's forward plus this backward
    lib_fb_ms, lib_fb = None, "not measured (the standard run's shapes)"
    if case["phase"].startswith("train_") or _library_kind(case) == "sdpa":
        try:
            call = _library_attention(rt, q, k, v, case, 0, grad=do)
            lib_fb_ms, _ = _time_ms(call, reps=5, warmup=2)
            lib_fb = f"{lib_fb_ms:.4f} ms"
        except Exception as exc:      # recorded, not fatal: a yardstick
            lib_fb = f"none: {type(exc).__name__}: {str(exc)[:200]}"
    print(f"attention backward (torch ops) at {row['shape']}: rel "
          f"{rel:.3g} (tol {tol}) against autograd of plain; {bwd_ms:.4f} "
          f"ms (autograd of plain {plain_bwd_ms:.4f} ms, bound "
          f"{bwd_bound:.5f} ms by {bwd_by}); library forward+backward "
          f"{lib_fb} beside K5 + this backward "
          f"{row['ms'] + bwd_ms:.4f} ms | {rt.card}", flush=True)
    row.update(bwd_ms=bwd_ms, bwd_plain_ms=plain_bwd_ms, bwd_rel=rel,
               bwd_tol=tol, bwd_bound_ms=bwd_bound, bwd_bound_by=bwd_by,
               library_fwd_bwd_ms=lib_fb_ms, library_fwd_bwd=lib_fb)
    return row


def _profile_train_step(rt, cfg, state, batch, lr=TRAIN_LR, ranges=()):
    """One more train step, timed, then again under ``torch.profiler``:
    the card's busy time and idle share, and its device time in K5 (by
    kernel name), in the attention backward, in the optimizer and in each
    of ``ranges`` ((name, module, attribute): kernels launched inside a
    range opened around that function here; a backward runs on the
    autograd engine's thread, outside the range of its forward), in the
    other matmul kernels (by name) and in the rest."""
    from torch.profiler import (ProfilerActivity, profile,
                                record_function)

    _, opt = rt.steps.make_train_step(cfg, lr)

    def ranged(name, fn):
        def call(*a, **kw):
            with record_function(f"chip:{name}"):
                return fn(*a, **kw)
        return call

    wrapped = [("attention_bwd", rt.flash_ops, "attention_bwd"), *ranges]
    real = [getattr(mod, attr) for _n, mod, attr in wrapped]
    plain_wall, _ = _seconds(lambda: _one_step(rt, cfg, state, batch,
                                               opt.update))
    for (name, mod, attr), fn in zip(wrapped, real):
        setattr(mod, attr, ranged(name, fn))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, _ = _seconds(lambda: _one_step(
                rt, cfg, state, batch, ranged("optimizer", opt.update)))
    finally:
        for (_n, mod, attr), fn in zip(wrapped, real):
            setattr(mod, attr, fn)
    # the ranges opened here also show as device-side spans: not kernels
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == cuda and not e.name.startswith("chip:")]
    in_range = [(n, r, us) for n, r, us in _kernels_by_range(prof)
                if any(x.startswith("chip:") for x in r)]
    buckets = {"k5": sum(us for n, us in kernels if K5_NAMES.search(n))}
    for name in [w[0] for w in wrapped] + ["optimizer"]:
        buckets[name] = sum(us for _n, r, us in in_range
                            if f"chip:{name}" in r)
    buckets["matmul_other"] = (
        sum(us for n, us in kernels if MATMUL_NAMES.search(n))
        - sum(us for n, _r, us in in_range if MATMUL_NAMES.search(n)))
    buckets["other"] = sum(us for _n, us in kernels) - sum(buckets.values())
    on_dev = [e for e in prof.key_averages() if e.device_type == cuda
              and not e.key.startswith("chip:")]
    busy_ms = sum(e.self_device_time_total for e in on_dev) / 1e3
    top = sorted(on_dev, key=lambda e: -e.self_device_time_total)[:8]
    out = {"wall_s": plain_wall, "profiled_wall_s": wall,
           "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / (1e3 * plain_wall),
           "device_ms": {k: v / 1e3 for k, v in buckets.items()},
           "kernels": sum(e.count for e in on_dev),
           "top_device_ms": [[e.key[:80], e.self_device_time_total / 1e3,
                              e.count] for e in top]}
    print(f"profile, {cfg.name} train step B={batch['tokens'].shape[0]} "
          f"S={batch['tokens'].shape[1]}: {json.dumps(out)} | {rt.card}",
          flush=True)
    return out


def _one_step(rt, cfg, state, batch, update):
    loss, grads = rt.steps.value_and_grad(
        lambda p: rt.lm.lm_loss(cfg, p, batch), state.params)
    update(grads, state.opt, state.params, state.step)
    return loss


def _kernels_by_range(prof):
    """(kernel name, names of the CPU ranges around its launch, device
    us) of every kernel the profiler tied to a CPU event (an aten op's
    kernels; a ctypes launch has none): each CPU event's kernels with the
    names of that event and its parents."""
    out = []
    for evt in prof.events():
        kernels = getattr(evt, "kernels", None) or []
        if not kernels:
            continue
        names, node = set(), evt
        while node is not None:
            names.add(node.name)
            node = node.cpu_parent
        for k in kernels:
            out.append((k.name, names, k.duration))
    return out


def _drive_train(rt, dev, rows):
    """Phase c: ``launch.train.main`` at gemma2-2b's full width and depth
    in standard mode, counted; then one more step profiled."""
    cfg = rt.get_config(TRAIN["arch"])
    per_layer = {kind: sum(1 for i in range(cfg.n_layers)
                           if (i % 2 == 0) == (kind == "local"))
                 for kind in ("local", "global")}
    torch.cuda.empty_cache()
    rt.zero_counts()
    log = rt.train.main(_train_args(
        ["--mode", "standard", "--batch", str(TRAIN["batch"]), "--steps",
         str(TRAIN["steps"]), "--lr", repr(TRAIN_LR), "--log-every", "1"]))
    torch.cuda.synchronize()
    per_step = 2 if cfg.remat and cfg.remat_policy != "none" else 1
    _lm_counts(rt, rows, "train standard",
               {f"train_{k}": n * per_step * TRAIN["steps"]
                for k, n in per_layer.items()})
    losses, norms = log.losses, log.grad_norms
    if not (all(np.isfinite(losses)) and all(np.isfinite(norms))
            and losses[-1] < losses[0]):
        raise AssertionError(f"train standard: losses {losses}, grad norms "
                             f"{norms}: not finite, or the loss did not "
                             f"fall")
    steady = statistics.mean(log.step_seconds[1:])
    batch = next(rt.pipeline(cfg.vocab_size, TRAIN["seq"], TRAIN["batch"],
                             seed=1).batches(dev))._asdict()
    profile = _profile_train_step(rt, cfg, log.state, batch)
    k5_ms = sum(r["ms"] * r["launches"] for r in rows
                if r["phase"].startswith("train_")) / TRAIN["steps"]
    bwd_ms = sum(r["bwd_ms"] * n for r in rows for kind, n in
                 per_layer.items() if r["phase"] == f"train_{kind}")
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "n_params": cfg.n_params(), "batch": TRAIN["batch"],
           "seq": TRAIN["seq"], "steps": TRAIN["steps"], "lr": TRAIN_LR,
           "optimizer": cfg.optimizer, "remat": cfg.remat_policy,
           "losses": losses, "grad_norms": norms,
           "first_step_s": log.step_seconds[0], "s_per_step": steady,
           "tokens_per_s": log.tokens_per_step / steady,
           "peak_mem_gb": log.peak_bytes[0] / 1e9,
           "k5_launches_per_step": per_step * cfg.n_layers,
           "k5_ms_per_step": k5_ms, "attention_bwd_ms_per_step": bwd_ms,
           "profile": profile, "card": rt.card, "state": log.state}
    print(f"gemma2-2b train (standard, full width and depth) B="
          f"{TRAIN['batch']} S={TRAIN['seq']}: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, {steady:.3f} s/step ({out['tokens_per_s']:.0f}"
          f" tok/s; first step {log.step_seconds[0]:.2f} s), peak "
          f"{out['peak_mem_gb']:.2f} GB, K5 {k5_ms:.2f} ms a step | "
          f"{rt.card}", flush=True)
    del log
    torch.cuda.empty_cache()
    return out


# the sharding phase: the train step of _drive_train, the serve phase's
# decode (8 of 26 layers, B=4, S_max = prompt + gen), one dry run
SHARD = dict(train_steps=3, decode_steps=8, dry_arch="gemma2_2b",
             dry_shape="train_4k", dry_timeout=300)


def _cloned(tree):
    from torch.utils import _pytree as pytree
    return pytree.tree_map(
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


def _sharded_train(rt, dev, mesh, state, rows, standard):
    """(a): ``steps.build``'s train step on the one-card mesh from the
    state ``_drive_train`` leaves, against ``make_train_step`` on a copy
    of it; then one step under the dispatch counters and the H100
    roofline of its counts."""
    cfg = rt.get_config(TRAIN["arch"])
    n = SHARD["train_steps"]
    shape = rt.input_shape("card_train", TRAIN["seq"], TRAIN["batch"],
                           "train")
    step = rt.steps.build(cfg, shape, mesh)
    batches = [next(rt.pipeline(cfg.vocab_size, TRAIN["seq"],
                                TRAIN["batch"], seed=7 + i).batches(dev)
                    )._asdict() for i in range(n + 1)]
    # the plain step on a copy of the same state (build's step runs the
    # reference's default lr; so does this one)
    train_step, _ = rt.steps.make_train_step(cfg)
    plain = rt.steps.TrainState(_cloned(state.params), _cloned(state.opt),
                                state.step)
    want = []
    for b in batches[:n]:
        plain, m = train_step(plain, b)
        want.append((float(m["loss"]), float(m["grad_norm"])))
    del plain
    torch.cuda.empty_cache()
    placed, _ = step.place(state, {})
    per_layer = {kind: sum(1 for i in range(cfg.n_layers)
                           if (i % 2 == 0) == (kind == "local"))
                 for kind in ("local", "global")}
    per_step = 2 if cfg.remat and cfg.remat_policy != "none" else 1
    rt.zero_counts()
    got, secs = [], []
    for b in batches[:n]:
        pb = step.place(None, b)[1]
        sec, (placed, m) = _seconds(lambda: step(placed, pb))
        secs.append(sec)
        got.append((float(m["loss"]), float(m["grad_norm"])))
    _lm_counts(rt, rows, "sharding: build's train step",
               {f"train_{k}": v * per_step * n for k, v in per_layer.items()})
    # every placement is Replicate and the local ops are the plain
    # step's: equal bit for bit
    if got != want:
        raise AssertionError(f"build's train step: loss / grad_norm "
                             f"{got}, make_train_step {want}")
    # one more step under the counters; K5 (a ctypes launch) counted from
    # its launches, its FLOPs as the dry run counts them, its bytes its
    # q, k, v and output once
    rt.zero_counts()
    pb = step.place(None, batches[n])[1]
    with rt.roofline.StepCounter() as counter:
        sec_counted, (placed, m) = _seconds(lambda: step(placed, pb))
    k5_flops = rt.roofline.attention_flops(rt.flash_ops.launches_by_shape)
    k5_bytes = rt.roofline.attention_bytes(rt.flash_ops.launches_by_shape)
    _lm_counts(rt, rows, "sharding: counted step",
               {f"train_{k}": v * per_step for k, v in per_layer.items()})
    report = rt.roofline.analyze(
        cfg, shape, "1", 1, counter.flops + k5_flops,
        counter.bytes + k5_bytes, counter.collective_bytes,
        counter.collectives, {"temp_size_in_bytes": counter.temp_peak})
    s_step = statistics.mean(secs[1:])
    out = {"losses": [g[0] for g in got], "grad_norms": [g[1] for g in got],
           "make_train_step": want, "bitwise": True,
           "s_per_step": s_step, "step_seconds": secs,
           "drive_train_s_per_step": standard["s_per_step"],
           "counted_step_s": sec_counted,
           "flops": counter.flops + k5_flops, "k5_flops": k5_flops,
           "bytes": counter.bytes + k5_bytes,
           "roofline_model_s": {"compute": report.compute_sec,
                                "memory": report.memory_sec,
                                "collective": report.collective_sec,
                                "dominant": report.dominant},
           "useful_flops_ratio": report.useful_flops_ratio}
    print(f"sharding (a): gemma2-2b train step through steps.build on the "
          f"one-card mesh, B={TRAIN['batch']} S={TRAIN['seq']}: losses "
          f"{out['losses']} grad norms {out['grad_norms']}, "
          f"make_train_step's {want}: "
          f"bit for bit; "
          f"{s_step:.3f} s/step (make_train_step in launch.train: "
          f"{standard['s_per_step']:.3f}); counted step: "
          f"{out['flops']:.4g} FLOPs (K5 {k5_flops:.4g}), "
          f"{out['bytes']:.4g} bytes; roofline, a model from H100 "
          f"datasheet figures (989 TFLOP/s bf16, 3.35 TB/s), not a "
          f"measurement: compute {report.compute_sec:.4f} s, memory "
          f"{report.memory_sec:.4f} s ({report.dominant}), beside "
          f"{s_step:.3f} s/step measured | {rt.card}", flush=True)
    return out, placed


def _sharded_decode(rt, dev, mesh):
    """(b): ``steps.build``'s decode step at the serve phase's depth
    against ``make_decode_step``, each on its own caches."""
    cfg = dataclasses.replace(rt.get_config(LM["arch"]),
                              n_layers=LM["layers"])
    b, s_max, n = LM["batch"], LM["prompt"] + LM["gen"], SHARD["decode_steps"]
    params = rt.lm.init_decoder_lm(
        cfg, torch.Generator(device=dev).manual_seed(LM["seed"]))
    toks = torch.randint(0, cfg.vocab_size, (b, n), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(5)).to(dev)
    dec = rt.steps.make_decode_step(cfg)
    caches = rt.lm.init_caches(cfg, b, s_max, dev)
    want = []
    for i in range(n):
        logits, caches = dec(params, {"tokens": toks[:, i:i + 1],
                                      "index": i, "caches": caches})
        want.append(logits)
    step = rt.steps.build(cfg, rt.input_shape("card_decode", s_max, b,
                                              "decode"), mesh)
    pp, pb = step.place(params, {"caches": rt.lm.init_caches(
        cfg, b, s_max, dev)})
    caches = pb["caches"]
    rt.zero_counts()
    got, secs = [], []
    for i in range(n):
        tb = step.place(None, {"tokens": toks[:, i:i + 1]})[1]["tokens"]
        sec, (logits, caches) = _seconds(lambda: step(
            pp, {"tokens": tb, "index": i, "caches": caches}))
        secs.append(sec)
        got.append(logits.full_tensor())
    launches = dict(rt.flash_ops.launches_by_variant)
    if launches != {"decode": cfg.n_layers * n} or any(
            rt.counts().values()):
        raise AssertionError(f"build's decode step: K5 launches by variant "
                             f"{launches}, want {{'decode': "
                             f"{cfg.n_layers * n}}}; LDA {rt.counts()}")
    diff = max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want))
    top = max(float(w.float().abs().max()) for w in want)
    # every placement Replicate: the same kernels on the same local
    # tensors, so the logits are equal bit for bit
    if diff != 0.0:
        raise AssertionError(f"build's decode logits differ from "
                             f"make_decode_step's by {diff} (largest "
                             f"logit {top})")
    out = {"layers": cfg.n_layers, "batch": b, "s_max": s_max,
           "steps": n, "k5_decode_launches": launches["decode"],
           "bitwise": True,
           "s_per_step": statistics.mean(secs[1:])}
    print(f"sharding (b): gemma2-2b decode through steps.build ({cfg.n_layers}"
          f" of 26 layers, B={b}, S_max={s_max}), {n} steps: logits against "
          f"make_decode_step's: bit for bit (largest logit {top:.3g}); "
          f"K5 'decode' launches "
          f"{launches['decode']}; {out['s_per_step'] * 1e3:.2f} ms/step "
          f"| {rt.card}", flush=True)
    return out


def _drive_sharding(rt, dev, state, rows, standard):
    """Phase 8b (slice 16): the LM scaffold's sharding half on the card.
    (a) gemma2-2b's train step through ``launch.steps.build`` on a
    one-card ``DeviceMesh`` against ``make_train_step``, K5 counted by
    shape, then one step counted and its H100 roofline beside the
    measured s/step; (b) the decode step through ``build`` against
    ``make_decode_step``; (c) one production dry run (gemma2-2b x
    train_4k x 16x16 on a fake world of 512) in a process of its own,
    started first, on the CPU beside (a) and (b)."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    with tempfile.TemporaryDirectory() as tmp:
        dry = subprocess.Popen(
            ["nice", "-n", "10", sys.executable, "-m",
             "repro_torch.launch.dryrun", "--arch", SHARD["dry_arch"],
             "--shape", SHARD["dry_shape"], "-o", os.path.join(tmp, "dry")],
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        try:
            own = not dist.is_initialized()
            if own:
                dist.init_process_group(
                    "nccl", store=dist.FileStore(os.path.join(tmp, "pg"), 1),
                    rank=0, world_size=1)
            try:
                mesh = rt.mesh.make_lm_host_mesh("cuda")
                train, state = _sharded_train(rt, dev, mesh, state, rows,
                                              standard)
                del state
                torch.cuda.empty_cache()
                decode = _sharded_decode(rt, dev, mesh)
            finally:
                if own:
                    dist.destroy_process_group()
            log, _ = dry.communicate(timeout=SHARD["dry_timeout"])
        finally:
            if dry.poll() is None:
                dry.kill()
                dry.wait()
    lines = [x for x in log.splitlines() if x.startswith(("== ", "   "))]
    if dry.returncode != 0 or "1/1 combinations ran" not in log:
        raise AssertionError(f"dry run exited {dry.returncode}:\n"
                             f"{log[-3000:]}")
    for x in lines:
        print(f"sharding (c): {x.strip()}", flush=True)
    took = re.search(r"\(build ([\d.]+)s run ([\d.]+)s\)", lines[0])
    dry_s = float(took.group(1)) + float(took.group(2))
    print(f"sharding (c): the dry run's build and run {dry_s:.1f} s by its "
          f"own clock (a process of its own, on the CPU: counts and H100 "
          f"model seconds, not a measurement) | {rt.card}", flush=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(f"sharding phase: {seconds:.1f} s | {rt.card}", flush=True)
    return {"train": train, "decode": decode,
            "dryrun": {"lines": lines, "seconds": dry_s},
            "seconds": seconds, "card": rt.card}



def _train_rank(job):
    """One rank of phase d (spawned by ``gossip_sim.launch``): this node's
    params drawn once on the card, then ``train_decentralized`` once per
    sync spec from a copy of them, then xlstm-125m's run
    (``job["xlstm_argv"]``) from its own draw, the counters set to 0 just
    before each; returns on rank 0 every rank's log, counts and peak."""
    import torch.distributed as dist
    rt = _Port()
    torch.set_num_threads(2)
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = rt.mesh.make_host_mesh()
    tree_map = torch.utils._pytree.tree_map
    out, host = {}, None
    for sync in DEC["syncs"]:
        args = rt.train.parse_args(_train_args(job["argv"] + ["--sync",
                                                               sync]))
        cfg = rt.train.config_of(args)
        if host is None:      # the node's draw, kept on the host
            seed = rt.train.node_seed(args.seed, args.nodes,
                                      mesh.index("data"))
            host = tree_map(lambda x: x.cpu(), rt.lm.init_decoder_lm(
                cfg, torch.Generator(device=dev).manual_seed(seed)))
        init = tree_map(lambda x: x.to(dev), host)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        rt.zero_counts()
        log = rt.train.train_decentralized(cfg, args, mesh,
                                           init_params=init)
        torch.cuda.synchronize()
        mine = {"log": dataclasses.replace(log, state=None),
                "flash_by_shape": dict(rt.flash_ops.launches_by_shape),
                "flash_by_variant": dict(rt.flash_ops.launches_by_variant),
                "mix_launches": rt.mix_ops.launches}
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        out[sync] = every
        del init, log
    del host
    args = rt.train.parse_args(job["xlstm_argv"])
    cfg = rt.train.config_of(args)
    seed = rt.train.node_seed(args.seed, args.nodes, mesh.index("data"))
    init = rt.lm.init_decoder_lm(cfg, torch.Generator(
        device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rt.zero_counts()
    log = rt.train.train_decentralized(cfg, args, mesh, init_params=init)
    torch.cuda.synchronize()
    mine = {"log": dataclasses.replace(log, state=None),
            "flash_launches": rt.flash_ops.launches,
            "mix_launches": rt.mix_ops.launches}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    out["xlstm"] = every
    return out


def _drive_decentralized(rt, dev, rows):
    """Phase d: ``train_decentralized`` at gemma2-2b's full width, depth
    cut to DEC["layers"], DEC["nodes"] gloo ranks sharing the card, H =
    2, once per sync spec; then ``sync_tree_sim`` over a stacked copy of
    that parameter tree on the card (K1 in bf16, counted)."""
    from repro_torch.launch import gossip_sim
    cfg = dataclasses.replace(rt.get_config(TRAIN["arch"]),
                              n_layers=DEC["layers"])
    print(f"decentralized phase: {cfg.name} at full width, depth cut to "
          f"{DEC['layers']} of 26 layers (widths and vocab kept), "
          f"{DEC['nodes']} gloo ranks on one card", flush=True)
    argv = ["--mode", "decentralized", "--layers", str(DEC["layers"]),
            "--local-steps", str(DEC["local_steps"]), "--steps",
            str(DEC["steps"]), "--batch", str(DEC["batch"]), "--nodes",
            str(DEC["nodes"]), "--log-every", str(DEC["steps"] - 1),
            "--dist-backend", "gloo"]
    xlstm_argv = ["--full", "--mode", "decentralized", "--sync",
                  FDEC["sync"], "--local-steps", str(FDEC["local_steps"]),
                  "--steps", str(FDEC["steps"]), "--batch",
                  str(FDEC["batch"]), "--seq", str(FDEC["seq"]), "--nodes",
                  str(FDEC["nodes"]), "--log-every", str(FDEC["steps"] - 1),
                  "--dist-backend", "gloo", "--device", "cuda"]
    t0 = time.perf_counter()
    runs = gossip_sim.launch(_train_rank, DEC["nodes"], "gloo",
                             ({"argv": argv, "xlstm_argv": xlstm_argv},),
                             timeout_s=DEC_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0   # lint: allow(timer-no-barrier)
    xlstm = _xlstm_decentralized(rt, runs.pop("xlstm"))
    per_layer = {kind: sum(1 for i in range(cfg.n_layers)
                           if (i % 2 == 0) == (kind == "local"))
                 for kind in ("local", "global")}
    per_step = DEC["local_steps"] * 2 + 1   # fwd + recompute, then the loss
    by_key = {r["key"]: r for r in rows}
    out = {}
    for sync, ranks in runs.items():
        spec = rt.dec.parse_sync(sync)
        log = ranks[0]["log"]
        for r, mine in enumerate(ranks):
            if mine["mix_launches"]:
                raise AssertionError(f"decentralized {sync}: rank {r} "
                                     f"launched K1 (no intra-rank pair)")
            got = {}
            for key, n in mine["flash_by_shape"].items():
                if key not in by_key:
                    raise AssertionError(f"decentralized {sync}: K5 at "
                                         f"{key}, a shape no row holds")
                by_key[key]["launches"] += n
                got[by_key[key]["phase"]] = n
            want = {f"dec_{k}": n * per_step * DEC["steps"]
                    for k, n in per_layer.items()}
            if got != want or mine["flash_by_variant"] != {
                    "wgmma": sum(want.values())}:
                raise AssertionError(f"decentralized {sync}: rank {r} K5 "
                                     f"launches {got}, want {want}")
        spreads = [s for _t, s in log.spreads]
        losses = log.losses
        exact = rt.dec.is_exact(spec, (DEC["nodes"],))
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
                and all(np.isfinite(spreads))
                and (spreads[-1] == 0.0 if exact else spreads[-1] > 0.0)):
            raise AssertionError(f"decentralized {sync}: losses {losses}, "
                                 f"spreads {spreads}")
        steady = statistics.mean(log.step_seconds[1:])
        out[sync] = {
            "losses": losses, "spreads": log.spreads,
            "s_per_step": steady,
            "tokens_per_s": log.tokens_per_step / steady,
            "sync_s": statistics.mean(log.sync_seconds),
            "sync_s_all": log.sync_seconds,
            "sync_bytes_per_rank": log.sync_bytes,
            "collective_bytes_per_sync": log.napkin_bytes,
            "param_bytes": log.param_bytes,
            "peak_mem_gb_per_rank": [p / 1e9 for p in log.peak_bytes]}
        print(f"decentralized {sync}: loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, spread {log.spreads}, {steady:.2f} s/step "
              f"({out[sync]['tokens_per_s']:.0f} tok/s over "
              f"{DEC['nodes']} nodes), sync {out[sync]['sync_s']:.3f} s "
              f"({log.sync_bytes / 1e9:.3f} GB handed to torch.distributed "
              f"a rank; collective_bytes_per_sync "
              f"{log.napkin_bytes / 1e9:.3f} GB), peak "
              f"{max(out[sync]['peak_mem_gb_per_rank']):.2f} GB a rank | "
              f"{rt.card}", flush=True)
    out["spawn_s"] = spawn_s
    out["xlstm_125m"] = xlstm
    out["layers"], out["nodes"] = DEC["layers"], DEC["nodes"]
    out["sim"] = _drive_sync_sim(rt, dev, cfg, rows)
    out["card"] = rt.card
    return out


def _sim_tree(rt, cfg, dev):
    """A stacked DEC["nodes"]-node copy of the parameter tree, each node
    drawn on the card from its own generator."""
    nodes = [rt.lm.init_decoder_lm(cfg, torch.Generator(
        device=dev).manual_seed(500 + i)) for i in range(DEC["nodes"])]
    stacked = torch.utils._pytree.tree_map(lambda *xs: torch.stack(xs),
                                           *nodes)
    del nodes
    return stacked


def _mix_tree_rows(rt, dev, cfg):
    """Every K1 shape ``sync_tree_sim`` launches over the stacked tree of
    ``cfg`` (one leaf shape and dtype of each kind; DEC["nodes"] / 2
    pairs a round), and the one-bf16 path at [20, 5, 51] (a row of 255
    elements)."""
    one = rt.lm.init_decoder_lm(dataclasses.replace(cfg, n_layers=1),
                                torch.Generator(device=dev).manual_seed(0))
    shapes = sorted({((DEC["nodes"], *x.shape), x.dtype)
                     for x in torch.utils._pytree.tree_leaves(one)},
                    key=lambda sd: (sd[0], str(sd[1])))
    del one
    torch.cuda.empty_cache()
    rows = [_hold_mix_leaf(rt, dev, s, DEC["nodes"] // 2, 40 + i, dtype)
            for i, (s, dtype) in enumerate(shapes)]
    _hold_mix_leaf(rt, dev, (20, 5, 51), 7, 39)
    torch.cuda.empty_cache()
    return rows


def _drive_sync_sim(rt, dev, cfg, rows):
    """``sync_tree_sim`` once on the card over a stacked copy of the
    decentralized run's tree, exact hypercube: K1's launches by shape
    equal leaves x rounds, and every node ends equal bit for bit."""
    tree = _sim_tree(rt, cfg, dev)
    leaves = torch.utils._pytree.tree_leaves(tree)
    spec = rt.dec.parse_sync("gossip-hypercube")
    (k,) = rt.dec.rounds_per_axis(spec, (DEC["nodes"],))
    want = {}
    for x in leaves:
        key = (*x.shape, DEC["nodes"] // 2) + (
            ("bf16",) if x.dtype == torch.bfloat16 else ())
        want[key] = want.get(key, 0) + k
    torch.cuda.synchronize()
    rt.zero_counts()
    secs, _ = _seconds(lambda: rt.dec.sync_tree_sim(tree, spec,
                                                    DEC["nodes"]))
    got = dict(rt.mix_ops.launches_by_shape)
    if got != want or rt.mix_ops.launches != len(leaves) * k:
        raise AssertionError(f"sync_tree_sim: K1 launches {got}, want "
                             f"{want}")
    by_key = {r["key"]: r for r in rows}
    for key, n in got.items():
        by_key[key]["launches"] += n
    for x in leaves:
        if not all(torch.equal(x[0], x[i]) for i in range(1, x.shape[0])):
            raise AssertionError("sync_tree_sim: the nodes differ after an "
                                 "exact hypercube")
    nbytes = rt.dec.tree_bytes(tree)
    del tree, leaves
    torch.cuda.empty_cache()
    out = {"spec": "gossip-hypercube", "rounds": k, "seconds": secs,
           "launches": sum(got.values()),
           "tree_bytes": nbytes}
    print(f"sync_tree_sim (hypercube, {k} rounds) over a stacked "
          f"{DEC['nodes']}-node copy ({nbytes / 1e9:.2f} GB): "
          f"{secs:.3f} s, {out['launches']} K1 launches at held shapes, "
          f"nodes equal | {rt.card}", flush=True)
    return out


def _train_trajectory(rt, dev, rows):
    """Phase e: the smoke variant of TRAJ["arch"] in float32, TRAJ["steps"]
    AdamW and Adafactor steps on the card and on the CPU from the same
    params (drawn on the CPU): losses rtol 1e-5, params within the CPU
    tests' AdamW bound (every element within a tenth of the summed lr, at
    most 1e-4 of a leaf's elements beyond 1e-6); K5 counted."""
    smoke = rt.smoke(rt.get_config(TRAJ["arch"]))
    out = {}
    rt.zero_counts()
    for kind in ("adamw", "adafactor"):
        cfg = dataclasses.replace(smoke, optimizer=kind)
        runs = {}
        for where in ("cpu", "cuda"):
            d = torch.device(where)
            params = rt.lm.init_decoder_lm(
                cfg, torch.Generator().manual_seed(0), device=d)
            step, opt = rt.steps.make_train_step(cfg, TRAJ_LR)
            state = rt.steps.TrainState(params, opt.init(params), 0)
            losses = []
            it = rt.pipeline(cfg.vocab_size, TRAJ["seq"], TRAJ["batch"],
                             seed=0).batches(d)
            for _ in range(TRAJ["steps"]):
                state, m = step(state, next(it)._asdict())
                losses.append(float(m["loss"]))
            runs[where] = (losses, rt.convert.decoder_lm_to_numpy(
                state.params))
        (cl, cp), (gl, gp) = runs["cpu"], runs["cuda"]
        loss_rel = float(np.max(np.abs(np.array(gl) - cl) / np.abs(cl)))
        lr_sum = sum(float(rt.schedule("cosine", TRAJ_LR)(t))
                     for t in range(TRAJ["steps"]))
        worst, frac = 0.0, 0.0

        def walk(a, b):
            nonlocal worst, frac
            if isinstance(a, dict):
                for key in a:
                    walk(a[key], b[key])
                return
            diff = np.abs(a - b)
            worst = max(worst, float(diff.max()))
            frac = max(frac, float((diff > 1e-6).mean()))
        walk(gp, cp)
        if not (loss_rel <= 1e-5 and worst < 0.1 * lr_sum and frac <= 1e-4):
            raise AssertionError(f"trajectory {kind}: loss rel {loss_rel}, "
                                 f"param max diff {worst} (bound "
                                 f"{0.1 * lr_sum}), share beyond 1e-6 "
                                 f"{frac}")
        out[kind] = {"losses_cuda": gl, "losses_cpu": cl,
                     "loss_rel": loss_rel, "param_max_diff": worst,
                     "param_bound": 0.1 * lr_sum, "share_beyond_1e-6": frac}
        print(f"trajectory {cfg.name} f32 {kind}, {TRAJ['steps']} steps: "
              f"card vs CPU loss rel {loss_rel:.3g} (1e-5), params max "
              f"{worst:.3g} (bound {0.1 * lr_sum:.3g}), share beyond 1e-6 "
              f"{frac:.3g} (1e-4)", flush=True)
    # two optimizers, one forward a step (the smoke variant has no remat)
    per = 2 * smoke.n_layers * TRAJ["steps"]
    _lm_counts(rt, rows, "trajectory", {"traj_f32": per})
    return out


def _ftrain_flash_cases(rt):
    """K5's shapes on the families' training path (bf16, full width):
    zamba2's shared attention (D=80, "fma"), whisper's encoder (non-
    causal, Sq=Sk=1,500), decoder self-attention and cross-attention (Sq
    = S, Sk=1,500, non-causal), pixtral's 256 image tokens and its text
    (S=512, GQA 4), arctic's (GQA 7); and phase e's float32 whisper smoke
    shapes (at most 64 query rows a KV head: "decode"). arctic's smoke
    shape is phase e's granite one."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = []

    def attn(cfg, **kw):
        return dict(h=cfg.n_heads, hkv=cfg.n_kv, d=cfg.hd,
                    softcap=cfg.attn_softcap,
                    scale=cfg.query_scale or cfg.hd ** -0.5,
                    window=rt.flash_ops.GLOBAL_WINDOW, kind="global",
                    offsets=(0,), **kw)

    for run in FAMILY_TRAIN:
        cfg, tag = rt.get_config(run["arch"]), run["tag"]
        b, s = run["batch"], run["seq"]
        group = cfg.n_heads // cfg.n_kv
        base = attn(cfg, b=b, dtype=bf16, tol=3e-2)
        if cfg.family == "ssm":
            continue
        if cfg.family == "encdec":
            t, nc = cfg.max_source_len, dict(base, causal=False)
            cases += [
                dict(nc, phase=f"train_{tag}_encoder", sq=t, sk=t,
                     variant="wgmma"),
                dict(base, phase=f"train_{tag}_self", sq=s, sk=s,
                     variant="wgmma", control="tile"),
                dict(nc, phase=f"train_{tag}_cross", sq=s, sk=t,
                     variant="wgmma")]
            continue
        n = s + (cfg.n_image_tokens if cfg.family == "vlm" else 0)
        cases.append(dict(base, phase=f"train_{tag}", sq=n, sk=n,
                          variant=rt.flash_ops.variant(bf16, n, cfg.hd,
                                                       group),
                          control="tile"))
    for run in TRAJ_FAMILIES:
        if run["frames"] is None:
            continue
        smoke = rt.smoke(rt.get_config(run["arch"]))
        base = attn(smoke, b=TRAJ["batch"], dtype=f32, tol=2e-5,
                    control="bf16")
        t, s = run["frames"], TRAJ["seq"]
        for phase, sq, sk, causal in (("encoder", t, t, False),
                                      ("self", s, s, True),
                                      ("cross", s, t, False)):
            cases.append(dict(
                base, phase=f"traj_whisper_{phase}", sq=sq, sk=sk,
                causal=causal, variant=rt.flash_ops.variant(
                    f32, sq, smoke.hd, smoke.n_heads // smoke.n_kv)))
    return cases


def _ftrain_layers(cfg, tag):
    """(attention calls a step, forward launches a call) by phase: remat
    "full" runs each rematted attention's forward again in the backward;
    zamba2's shared block is applied outside remat, as in the
    reference."""
    per = 2 if cfg.remat and cfg.remat_policy != "none" else 1
    if cfg.family == "encdec":
        return {f"train_{tag}_encoder": (cfg.n_encoder_layers, per),
                f"train_{tag}_self": (cfg.n_layers, per),
                f"train_{tag}_cross": (cfg.n_layers, per)}
    if cfg.family == "ssm":
        return {}
    if cfg.family == "hybrid":
        return {f"train_{tag}": (_attention_layers(cfg), 1)}
    return {f"train_{tag}": (cfg.n_layers, per)}


def _family_batches(rt, cfg, run, dev):
    """The run's batches: ``TokenPipeline`` tokens, targets and mask on
    the card, with whisper's stub frames and pixtral's stub image
    embeddings (drawn on the CPU from the seed, moved)."""
    cpu = torch.Generator().manual_seed(1)
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = rt.frontends.audio_frames_stub(
            cfg, cpu, run["batch"], device=dev)
    if cfg.family == "vlm":
        extra["image_embeds"] = rt.frontends.image_patches_stub(
            cfg, cpu, run["batch"], device=dev)
    for batch in rt.pipeline(cfg.vocab_size, run["seq"], run["batch"],
                             seed=0).batches(dev):
        yield dict(batch._asdict(), **extra)


def _train_family(rt, dev, run, rows):
    """One family trained at full width: xlstm through ``launch.train.main``
    (no ``--arch``: the default), the rest through
    ``steps.make_train_step`` on weights drawn on the card; K5 counted by
    shape and variant; every loss and grad norm finite. Returns its
    numbers: s/step (steps 2 on), tokens/s, peak memory, the losses."""
    cfg, tag = _family_cfg(rt, run), run["tag"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rt.zero_counts()
    draw_s = None
    if tag == "xlstm":
        if rt.train.parse_args([]).arch != run["arch"]:
            raise AssertionError("launch.train's default arch is not "
                                 "xlstm-125m")
        log = rt.train.main(["--full", "--batch", str(run["batch"]),
                             "--seq", str(run["seq"]), "--steps",
                             str(run["steps"]), "--lr", repr(FTRAIN_LR),
                             "--log-every", "1", "--device", "cuda"])
        losses, norms, secs = log.losses, log.grad_norms, log.step_seconds
        peak, state = log.peak_bytes[0], log.state
    else:
        params, draw_s = _family_params(rt, cfg, 0, dev)
        step, opt = rt.steps.make_train_step(cfg, FTRAIN_LR)
        state = rt.steps.TrainState(params, opt.init(params), 0)
        del params
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, norms, secs = [], [], []
        for _, batch in zip(range(run["steps"]),
                            _family_batches(rt, cfg, run, dev)):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))          # drains the card
            norms.append(float(m["grad_norm"]))
            secs.append(time.perf_counter() - t0)   # lint: allow(timer-no-barrier)
        peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    layers = _ftrain_layers(cfg, tag)
    want = {ph: n * per * run["steps"] for ph, (n, per) in layers.items()}
    _lm_counts(rt, rows, f"{tag} train", want)
    if not (all(np.isfinite(losses)) and all(np.isfinite(norms))):
        raise AssertionError(f"{cfg.name} train: losses {losses}, grad "
                             f"norms {norms}: not finite")
    steady = statistics.mean(secs[1:])
    text = run["batch"] * run["seq"]
    n_img = cfg.n_image_tokens if cfg.family == "vlm" else 0
    by_phase = {r["phase"]: r for r in rows}
    out = {"arch": cfg.name, "family": cfg.family, "layers": cfg.n_layers,
           "n_params": cfg.n_params(), "optimizer": cfg.optimizer,
           "remat": cfg.remat_policy if cfg.remat else "off",
           "batch": run["batch"], "seq": run["seq"], "steps": run["steps"],
           "image_tokens": n_img, "lr": FTRAIN_LR,
           "route": "launch.train.main" if tag == "xlstm"
           else "steps.make_train_step",
           "losses": losses, "grad_norms": norms,
           "first_step_s": secs[0], "s_per_step": steady,
           "tokens_per_s": text / steady,
           "tokens_per_s_with_images": (text + run["batch"] * n_img)
           / steady,
           "peak_mem_gb": peak / 1e9, "weight_draw_s": draw_s,
           "k5_launches": want,
           "k5_fwd_ms_per_step": sum(by_phase[ph]["ms"] * n * per for ph,
                                     (n, per) in layers.items()),
           "k5_bwd_ms_per_step": sum(by_phase[ph]["bwd_ms"] * n for ph,
                                     (n, _per) in layers.items()),
           "card": rt.card}
    print(f"{cfg.name} train ({cfg.n_layers} layers, {out['route']}, "
          f"{cfg.optimizer}) B={run['batch']} S={run['seq']}"
          f"{f' + {n_img} image tokens' if n_img else ''}: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, {steady:.3f} s/step "
          f"({out['tokens_per_s']:.0f} tok/s; first step {secs[0]:.2f} s), "
          f"peak {out['peak_mem_gb']:.2f} GB, K5 launches {want} | "
          f"{rt.card}", flush=True)
    return out, state


def _xlstm_decentralized(rt, ranks):
    """xlstm-125m (whole, the default arch) in ``train_decentralized``,
    run by phase d's ranks after gemma2-2b's (``_train_rank``):
    FDEC["nodes"] gloo ranks sharing the card, exact hypercube: the loss
    finite on every rank, the spread 0 after the last sync, no K5 (no
    attention) and no K1 (no pair inside a rank); s/step, a sync's
    seconds and bytes, peak memory a rank."""
    log = ranks[0]["log"]
    for r, mine in enumerate(ranks):
        if mine["mix_launches"] or mine["flash_launches"]:
            raise AssertionError(f"xlstm decentralized: rank {r} launched "
                                 f"K1 {mine['mix_launches']} / K5 "
                                 f"{mine['flash_launches']} times")
        if not all(np.isfinite(mine["log"].losses)):
            raise AssertionError(f"xlstm decentralized: rank {r} losses "
                                 f"{mine['log'].losses}")
    spreads = [sp for _t, sp in log.spreads]
    if spreads[-1] != 0.0:
        raise AssertionError(f"xlstm decentralized: spread {log.spreads} "
                             f"after an exact hypercube")
    steady = statistics.mean(log.step_seconds[1:])
    out = {"arch": "xlstm_125m", "nodes": FDEC["nodes"],
           "sync": FDEC["sync"], "local_steps": FDEC["local_steps"],
           "batch": FDEC["batch"], "seq": FDEC["seq"],
           "losses": log.losses, "spreads": log.spreads,
           "s_per_step": steady,
           "tokens_per_s": log.tokens_per_step / steady,
           "sync_s": statistics.mean(log.sync_seconds),
           "sync_bytes_per_rank": log.sync_bytes,
           "collective_bytes_per_sync": log.napkin_bytes,
           "param_bytes": log.param_bytes,
           "peak_mem_gb_per_rank": [p / 1e9 for p in log.peak_bytes],
           "card": rt.card}
    print(f"xlstm-125m decentralized ({FDEC['sync']}, {FDEC['nodes']} gloo "
          f"ranks): loss {log.losses[0]:.4f} -> {log.losses[-1]:.4f}, "
          f"spread {log.spreads}, {steady:.2f} s/step "
          f"({out['tokens_per_s']:.0f} tok/s over the nodes), sync "
          f"{out['sync_s']:.3f} s ({log.sync_bytes / 1e9:.3f} GB a rank), "
          f"peak {max(out['peak_mem_gb_per_rank']):.2f} GB a rank | "
          f"{rt.card}", flush=True)
    return out


def _adafactor_scale(g):
    """Adafactor's first-step denominator of each element,
    ``sqrt(r_i c_j / mean r)`` over a leaf's last two axes (``|g|`` for a
    vector), in float64 (``tests/test_torch_train_families.py``)."""
    g = np.asarray(g, np.float64)
    if g.ndim < 2:
        return np.abs(g)
    g2 = g * g + 1e-30
    vr, vc = g2.mean(-1), g2.mean(-2)
    return np.sqrt(vr[..., None] * vc[..., None, :]
                   / vr.mean(-1)[..., None, None])


def _gate_params(cfg, got, want, grads, lrs):
    """The card's parameter leaves ``got`` against the CPU's ``want``
    after steps at learning rates ``lrs``, with the bound of
    ``tests/test_torch_train_families.py::_assert_params_close`` summed
    over the steps (``grads``: the CPU's gradient leaves at each step).
    Every element within 2 lr a step (neither optimizer moves one by more
    than about lr); an element whose gradient is 0 at every step (the ssm
    family's idle block, a token no batch holds) moves by its weight decay
    alone on both sides, within 1e-6 of its leaf's max |p|; a leaf whose
    max |g| is below 1e-6 of the tree's at some step is rounding noise as
    a whole (whisper's key biases without
    RoPE, about 1e-8: the softmax cancels them) and gets only this.
    AdamW: where the gradient is resolved at every step (at least
    ``GRAD_REL`` of its leaf's max |g|), PR 23's bound: within a tenth of
    the summed lr, at most 1e-4 of a leaf's resolved elements beyond
    1e-6 (elsewhere the gradient is rounding noise, which AdamW's
    sign-like steps move by up to lr either way). Adafactor (one step):
    within ``4 lr delta / scale`` of each element, ``delta`` ``GRAD_REL``
    of the leaf's max |g|. Returns each bound's worst share."""
    lr_sum = sum(lrs)
    worst = {"all": 0.0, "zero": 0.0, "resolved": 0.0, "share": 0.0}
    tops = [max(float(np.abs(x).max()) for x in g) for g in grads]
    for i, (a, b) in enumerate(zip(got, want)):
        d = np.abs(a - b)
        worst["all"] = max(worst["all"], float(d.max()) / (2 * lr_sum))
        zero = np.logical_and.reduce([g[i] == 0 for g in grads])
        if zero.any():
            worst["zero"] = max(worst["zero"], float(d[zero].max()) / (
                1e-6 * max(float(np.abs(b).max()), 1e-30)))
        if any(np.abs(g[i]).max() < 1e-6 * top
               for g, top in zip(grads, tops)):
            continue
        if cfg.optimizer == "adafactor":
            g = grads[0][i]
            delta = GRAD_REL * np.abs(g).max()
            over = d / (lrs[0] * delta / (_adafactor_scale(g) + 1e-30))
            worst["resolved"] = max(worst["resolved"], float(over.max()) / 4)
            continue
        resolved = np.logical_and.reduce(
            [np.abs(g[i]) >= GRAD_REL * np.abs(g[i]).max() for g in grads])
        d = d[resolved]
        if d.size:
            worst["resolved"] = max(worst["resolved"],
                                    float(d.max()) / (0.1 * lr_sum))
            worst["share"] = max(worst["share"],
                                 float((d > 1e-6).mean()) / 1e-4)
    if not (worst["all"] <= 1 and worst["zero"] <= 1
            and worst["resolved"] < 1 and worst["share"] <= 1):
        raise AssertionError(f"trajectory {cfg.name} ({cfg.optimizer}): "
                             f"parameters beyond the bound, each bound's "
                             f"worst share {worst}")
    return worst


def _family_trajectory(rt, dev, rows):
    """Phase e for TRAJ_FAMILIES: each smoke variant in float32, its
    steps of its optimizer on the card and on the CPU (the plain
    versions) from the same params and batches (drawn on the CPU):
    losses rtol 1e-5, the parameters gated by ``_gate_params`` against
    the CPU's gradients; arctic's Adafactor step on the card in pieces of
    one expert matrix (``optimizers.CHUNK`` cut), the pieces counted. K5
    counted (arctic's smoke shape onto phase e's granite row, among
    ``rows``)."""
    from repro_torch.optim import optimizers
    real_chunk, real_pieces = optimizers.CHUNK, optimizers._matrix_pieces
    out = {}
    rt.zero_counts()
    for run in TRAJ_FAMILIES:
        cfg = rt.smoke(rt.get_config(run["arch"]))
        res, grads, pieces = {}, [], []

        def counted(*a):
            for piece in real_pieces(*a):
                pieces.append(tuple(piece[0].shape))
                yield piece
        for side, where in (("cpu", torch.device("cpu")), ("card", dev)):
            cpu = torch.Generator().manual_seed(0)
            params = (rt.encdec.init_encdec(cfg, cpu, device=where)
                      if cfg.family == "encdec"
                      else rt.lm.init_decoder_lm(cfg, cpu, device=where))
            frames = (rt.frontends.audio_frames_stub(
                cfg, torch.Generator().manual_seed(1), TRAJ["batch"],
                run["frames"], device=where) if run["frames"] else None)
            step, opt = rt.steps.make_train_step(cfg, TRAJ_LR)
            state = rt.steps.TrainState(params, opt.init(params), 0)
            it = rt.pipeline(cfg.vocab_size, TRAJ["seq"], TRAJ["batch"],
                             seed=0).batches(where)
            if side == "card" and run.get("chunk"):
                optimizers.CHUNK = run["chunk"]
                optimizers._matrix_pieces = counted
            losses = []
            try:
                for _ in range(run["steps"]):
                    batch = next(it)._asdict()
                    if frames is not None:
                        batch["frames"] = frames
                    if side == "cpu":
                        _, g = rt.steps.value_and_grad(
                            lambda p: rt.steps.loss_fn(cfg, p, batch),
                            state.params)
                        grads.append(torch.utils._pytree.tree_leaves(
                            rt.convert.decoder_lm_to_numpy(g)))
                    state, m = step(state, batch)
                    losses.append(float(m["loss"]))
            finally:
                optimizers.CHUNK = real_chunk
                optimizers._matrix_pieces = real_pieces
            res[side] = (losses, torch.utils._pytree.tree_leaves(
                rt.convert.decoder_lm_to_numpy(state.params)))
        (cl, cp), (gl, gp) = res["cpu"], res["card"]
        loss_rel = float(np.max(np.abs(np.array(gl) - cl) / np.abs(cl)))
        if not loss_rel <= 1e-5:
            raise AssertionError(f"trajectory {cfg.name}: card vs CPU loss "
                                 f"rel {loss_rel} > 1e-5")
        if run.get("chunk"):
            n_moe = cfg.n_layers - cfg.first_dense_layers
            d, f = cfg.d_model, cfg.moe_d_ff
            expert = pieces.count((1, d, f)) + pieces.count((1, f, d))
            if not (expert >= 3 * cfg.n_experts * n_moe
                    and cfg.n_experts * d * f > run["chunk"]):
                raise AssertionError(f"trajectory {cfg.name}: {expert} "
                                     f"expert pieces, not one a matrix")
        lrs = [float(rt.schedule("cosine", TRAJ_LR)(t))
               for t in range(run["steps"])]
        worst = max(float(np.abs(a - b).max()) for a, b in zip(gp, cp))
        gate = _gate_params(cfg, gp, cp, grads, lrs)
        out[run["arch"]] = {"losses_cuda": gl, "losses_cpu": cl,
                            "loss_rel": loss_rel, "param_max_diff": worst,
                            "bound_shares": gate, "steps": run["steps"],
                            "optimizer": cfg.optimizer,
                            "pieces": len(pieces) or None}
        print(f"trajectory {cfg.name} f32 {cfg.optimizer}, {run['steps']} "
              f"steps{f' ({len(pieces)} pieces)' if pieces else ''}: card "
              f"vs CPU loss rel {loss_rel:.3g} (1e-5), params max "
              f"{worst:.3g}, each bound's worst share {gate}", flush=True)
    want = {}
    for run in TRAJ_FAMILIES:
        smoke = rt.smoke(rt.get_config(run["arch"]))
        n = smoke.n_layers * run["steps"]
        if run["frames"]:
            want.update({f"traj_whisper_{ph}": n
                         for ph in ("encoder", "self", "cross")})
        elif smoke.family != "ssm":
            want["traj_f32"] = want.get("traj_f32", 0) + n
    _lm_counts(rt, rows, "families trajectory", want)
    return out


def _drive_family_training(rt, dev, lap, traj_rows):
    """Phase f: K5 and its gradient held at every new training shape,
    then each run of FAMILY_TRAIN (a zamba2 step profiled),
    ``sync_tree_sim`` through K1 over a stacked 4-node xlstm tree, and
    phase e's float32 trajectory for TRAJ_FAMILIES (xlstm's
    decentralized run is phase d's; ``traj_rows`` phase e's K5 row,
    which arctic's smoke shape shares).
    Returns (the numbers, K5 rows, K1 rows)."""
    t0 = time.perf_counter()
    k5_rows = [_hold_train_attention(rt, dev, c, 600 + i)
               for i, c in enumerate(_ftrain_flash_cases(rt))]
    torch.cuda.empty_cache()
    lap("families' training K5 holds")
    out = {}
    for run in FAMILY_TRAIN:
        out[run["tag"]], state = _train_family(rt, dev, run, k5_rows)
        if run["tag"] == "zamba2":
            cfg = _family_cfg(rt, run)
            batch = next(_family_batches(rt, cfg, run, dev))
            from repro_torch.models import mamba2
            out["zamba2"]["profile"] = _profile_train_step(
                rt, cfg, state, batch, FTRAIN_LR,
                ranges=(("mamba2", mamba2, "apply_mamba2"),))
        del state
        torch.cuda.empty_cache()
        lap(f"{run['tag']} training")
    xcfg = rt.get_config("xlstm_125m")
    k1_rows = _mix_tree_rows(rt, dev, xcfg)
    out["xlstm_sync_sim"] = _drive_sync_sim(rt, dev, xcfg, k1_rows)
    lap("xlstm sync_tree_sim")
    out["trajectory"] = _family_trajectory(rt, dev, k5_rows + traj_rows)
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    out["card"] = rt.card
    return out, k5_rows, k1_rows


def _drive_training(rt, dev, lap):
    """The training slice (6a, a-e): K1 in bf16 and K5 with its gradient
    held at every
    shape of the training path, then the standard run, the decentralized
    runs with the K1 simulation, and the float32 trajectory. Returns the
    numbers, with the held rows under "k1_rows" and "k5_rows"."""
    t0 = time.perf_counter()
    dec_cfg = dataclasses.replace(rt.get_config(TRAIN["arch"]),
                                  n_layers=DEC["layers"])
    k1_rows = _mix_tree_rows(rt, dev, dec_cfg)
    k5_rows = [_hold_train_attention(rt, dev, c, 200 + i)
               for i, c in enumerate(_train_flash_cases(rt))]
    torch.cuda.empty_cache()
    lap("training K1 and K5 holds")
    out = {"standard": _drive_train(rt, dev, k5_rows)}
    lap("gemma2-2b standard training")
    out["sharding"] = _drive_sharding(rt, dev, out["standard"].pop("state"),
                                      k5_rows, out["standard"])
    torch.cuda.empty_cache()
    lap("sharding: build, roofline, dry run")
    out["decentralized"] = _drive_decentralized(rt, dev, k5_rows + k1_rows)
    lap("decentralized training")
    out["trajectory"] = _train_trajectory(rt, dev, k5_rows)
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    out.update(card=rt.card, k1_rows=k1_rows, k5_rows=k5_rows)
    return out


def _kernel_line(name, route, source, replaces, rows, node_err):
    """One kernel's entry: totals, the most launched shape, every shape."""
    top = max(rows, key=lambda r: r["launches"])
    return {"name": name, "route": route, "source": source,
            "replaces": replaces,
            "launches": sum(r["launches"] for r in rows),
            "max_abs_err": max([node_err] + [r["max_abs_err"] for r in rows]),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "chain_ms": top.get("chain_ms"),
            "library_ms": None, "shape": top["shape"],
            "active_tokens": top.get("active_tokens"), "per_shape": rows}


def _e2e(summary, offered):
    server = summary["server"]
    lat = {}
    for r in summary["results"]:
        lat.setdefault(f"{r.bucket}/{r.kind}", []).append(1e3 * r.latency_s)
    return {"req_per_s": summary["req_per_s"], "offered_req_per_s": offered,
            "p50_ms": summary["p50_ms"], "p99_ms": summary["p99_ms"],
            "requests": len(summary["results"]), "slabs": server.n_slabs,
            "occupancy": server.mean_occupancy,
            "slabs_by_queue": {f"{lb}/{kind}": n for (lb, kind), n
                               in server.slabs_by_queue.items()},
            "requests_by_queue": {q: len(v) for q, v in lat.items()},
            "p50_ms_by_queue": {q: float(np.percentile(v, 50))
                                for q, v in lat.items()},
            "p99_ms_by_queue": {q: float(np.percentile(v, 99))
                                for q, v in lat.items()}}


def _ptxas_lines(log):
    """One line per compiled kernel of nvcc's ``-Xptxas -v`` output (its
    template instance, registers and spills), and ptxas's performance
    warnings (C75xx)."""
    out, entry, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = re.search(r"([A-Za-z]+(?:_[A-Za-z]+)*_kernel)I(\w*?)E+v",
                           m.group(1))
            args = ([] if fn is None else
                    (["bf16"] if "bfloat16" in fn.group(2) else
                     ["f32"] if fn.group(2).startswith("f") else [])
                    + re.findall(r"Li(\d+)", fn.group(2)))
            entry = (m.group(1) if fn is None
                     else f"{fn.group(1)}<{', '.join(args)}>")
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            out.append(f"{entry}: {line.split(':', 1)[1].strip()}; {spill}")
        elif "C75" in line:
            out.append(line.strip())
    return out


def _drive_analysis(rt, compiled, mesh):
    """The analysis phase (slice 15): the single-process rows with the
    kernels on (temp bytes by the card's meter against the reference's
    budgets; a planted dense [K, V] beta must fail ``temp-budget``), the
    mesh rows recorded in the grid's gloo ranks (``mesh``: their calls
    and the slowest rank's seconds, counted in the phase's), every
    inventory against the reference's golden, the PRNG checks on the
    card, and the compile counter over the whole script (``compiled``,
    exited here: each library loaded once, at most one nvcc run each)."""
    ta = rt.trace_audit
    t0 = time.perf_counter()
    reports, rows = {}, {}
    for name, kernels in ANALYSIS_KERNELS.items():
        rt.zero_counts()
        reports[name] = ta.run_audits([name], device="cuda")[name]
        launched = rt.counts()
        missing = [k for k in kernels if launched[k] < 1]
        if missing:
            raise AssertionError(f"analysis {name}: {missing} not launched")
        rep = reports[name]
        rows[name] = {"ok": rep.ok, "temp_bytes": rep.temp_bytes,
                      "budget": rep.spec.max_temp_bytes,
                      "launches": {k: launched[k] for k in kernels}}
    planted = ta.run_audits(["planted_dense_temp"], device="cuda")[
        "planted_dense_temp"]
    caught = [v.rule for v in planted.violations] == ["temp-budget"]
    mesh_reports = ta.reports_from_ranks(mesh["ops"])
    leak = mesh_reports.pop("planted_doc_gather")
    leak_rules = sorted({v.rule for v in leak.violations})
    reports.update(mesh_reports)
    golden = ta.check_against_golden(reports, ta.load_golden())
    prng = rt.audit.prng_checks("cuda")
    compiled.__exit__(None, None, None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0 + mesh["seconds"]
    failed = [r.summary() for r in reports.values() if not r.ok]
    if (failed or golden or prng or not caught
            or leak_rules != ["collective-allowlist", "privacy-doc-buffer"]
            or set(reports) != set(ta.ENTRY_POINTS)
            or any(n != 1 for n in compiled.counts.values())
            or any(n > 1 for n in compiled.builds.values())):
        raise AssertionError(
            f"analysis: failed rows {failed}, golden {golden}, prng {prng}, "
            f"planted dense beta caught {caught}, planted doc gather "
            f"{leak_rules}, loads {compiled.counts}, nvcc runs "
            f"{compiled.builds}")
    out = {"rows": rows,
           "planted_dense_temp": {"caught": caught,
                                  "temp_bytes": planted.temp_bytes,
                                  "budget": planted.spec.max_temp_bytes},
           "mesh_rows": {n: r.inventory for n, r in mesh_reports.items()},
           "planted_doc_gather": leak_rules,
           "golden_match": not golden, "prng_problems": prng,
           "library_loads": compiled.counts, "nvcc_runs": compiled.builds,
           "seconds": seconds, "card": rt.card}
    print(f"analysis: {len(reports)} rows pass and match the reference's "
          f"golden; temp bytes on the card "
          f"{ {n: r['temp_bytes'] for n, r in rows.items()} }; planted "
          f"dense beta {planted.temp_bytes} B caught; loads "
          f"{compiled.counts}, nvcc runs {compiled.builds}; "
          f"{seconds:.1f} s | {rt.card}", flush=True)
    return out


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {ROOT / 'chip_smoke.py'};"
              f" run it from a checkout of the repository", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))
    rt = _Port()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = rt.card = _smi("name,power.limit")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} driver "
          f"{_smi('driver_version')} | {card}; SM clock "
          f"{_smi('clocks.sm,clocks.max.sm')}", flush=True)

    # the compile counter spans the script: exited in the analysis phase
    compiled = rt.trace_audit.CompileCounter(*rt.common.KERNEL_NAMES)
    compiled.__enter__()
    t0 = time.perf_counter()
    warmer = _start_library_warmer(rt)
    probe = _start_add_chain(rt)
    logs = rt.common.build_all()
    build_s = time.perf_counter() - t0   # lint: allow(timer-no-barrier)
    for name, log in logs.items():
        for line in _ptxas_lines(log):
            print(f"  {name}: {line}")
    print(f"kernels built in {build_s:.1f}s: "
          f"{', '.join(rt.common.KERNEL_NAMES)}", flush=True)
    _time_add(rt, dev, *probe)

    def lap(name):
        print(f"[chip_smoke {time.perf_counter() - t_start:.1f} s] {name} "
              f"done", flush=True)
    lap("build")
    # phase 3: every kernel against its plain version, node shape first
    node_len = ("poisson", 2, NODE["l"])
    node_err = {
        "lda_gibbs": _hold_gibbs(rt, dev, dict(
            b=64, l=NODE["l"], s=TRAIN_SWEEPS, burnin=TRAIN_BURNIN,
            lengths=node_len, full_first=True), NODE["k"], NODE["v"],
            1)["max_abs_err"],
        "lda_l2r": _hold_l2r(rt, dev, dict(
            b=64, l=NODE["l"], p=PARTICLES, lengths=node_len,
            full_first=True), NODE["k"], NODE["v"], 1)["max_abs_err"]}
    cases = _main_path_cases(rt)
    hold = {"lda_gibbs": _hold_gibbs, "lda_l2r": _hold_l2r}
    rows = [hold[name](rt, dev, case, SLICE["k"], SLICE["v"], 2 + i)
            for i, (name, case) in enumerate(cases)]
    for (_name, case), row in zip(cases, rows):
        row["phase"] = f"serving {case['queue']}"
    words, _bw, mf, _u, _z = _inputs(rt, dev, dict(
        b=256, l=64, lengths=("poisson", 2, 64)), 100, 50_000, 3)
    per_pos = torch.rand((256, 64, 100), device=dev)
    first = rt.estep.stats_from_per_pos(words, per_pos, 50_000, mf)
    if not torch.equal(first, rt.estep.stats_from_per_pos(words, per_pos,
                                                          50_000, mf)):
        raise AssertionError("the [K, V] scatter is not deterministic")
    torch.cuda.synchronize()

    # phase 4: the main path, closed loop (capacity), then open loop
    with tempfile.TemporaryDirectory() as ckpt:
        closed = _drive(rt, dev,
                        SERVE_ARGS + ["--closed-loop", "--save", ckpt],
                        cases, rows, trained=True)
        rate = LOAD * closed["req_per_s"]
        opened = _drive(rt, dev,
                        SERVE_ARGS + ["--rate", repr(rate), "--restore", ckpt],
                        cases, rows, trained=False)
    torch.cuda.empty_cache()
    lap("serving")

    # phase 5: DELEDA, every launched shape held first, then the paths
    d_cases = _deleda_cases(rt)
    d_rows = _hold_deleda(rt, dev, d_cases)
    node_err["gossip_mix"] = _check_mix_scalar(rt, dev)
    trajectory = _trajectory_check(rt, dev)
    paper = _drive_paper(rt, dev, [r for r in d_rows
                                   if r["phase"].startswith("paper")])
    torch.cuda.empty_cache()
    lap("DELEDA paper scale")
    # phase 5a: the scenario layer (slice 9): the sweep at paper scale
    s_rows, scen = _drive_scenarios(rt, dev)
    torch.cuda.empty_cache()
    lap("scenario sweep")
    full_rows = [r for r in d_rows if r["phase"].startswith("full")]
    full_inputs = _full_width_inputs(rt, dev)
    full = _drive_full(rt, dev, full_rows, *full_inputs)
    torch.cuda.empty_cache()
    scen["full_width"] = _drive_full_scenario(rt, dev, full_rows,
                                              *full_inputs)
    del full_inputs
    torch.cuda.empty_cache()
    profile = _profile_rounds(rt, dev)
    torch.cuda.empty_cache()
    # phase 5b: the lifecycle (slice 8): save, kill, resume, serve a node
    lap("DELEDA full width")
    life = _drive_lifecycle(rt, dev, full_rows, cases, rows)
    lap("lifecycle")

    # phase 6: the unique-token layout (slice 3), shapes held in each
    node_err["lda_sparse"] = _check_sparse_binary(rt, dev)
    mix_rows = [r for r in full_rows if r["name"] == "gossip_mix"]
    z_rows, zipf = _drive_zipf(rt, dev, mix_rows)
    torch.cuda.empty_cache()
    lap("unique-token full width")
    b_rows, bench = _drive_sparse_bench(rt, dev)
    torch.cuda.empty_cache()
    lap("unique layout")

    # phase 6a: the Scale layer (slice 10): vocab_shards in the simulation,
    # then run_mesh_deleda over NCCL and as a node x vocab grid over gloo
    full_inputs = _full_width_inputs(rt, dev)
    scale = {"sim": _drive_scale_sim(rt, dev, full_rows, *full_inputs)}
    del full_inputs
    torch.cuda.empty_cache()
    lap("vocab_shards=4")
    mesh_rows, scale["mesh"] = _drive_mesh(rt, dev)
    torch.cuda.empty_cache()
    lap("Scale layer")

    # phase 7: the LM slice, gemma2-2b, then gemma2-9b, served through K5
    _library_warmer_state(warmer, t_start)
    lm_rows, lm = _drive_lm(rt, dev)
    torch.cuda.empty_cache()
    lap("gemma2-2b serving")
    lm9_rows, lm["gemma2_9b"] = _drive_lm9(rt, dev)
    lm_rows += lm9_rows
    torch.cuda.empty_cache()
    lap("gemma2-9b serving")
    # phase 7a: the other families, every new K5 shape held first
    fam_rows, families = _drive_families(rt, dev, lap)
    lm_rows += fam_rows
    torch.cuda.empty_cache()

    # phase 8 (the docstring's 6a): the training slice (PR 23), every new
    # shape held first
    training = _drive_training(rt, dev, lap)
    train_k5 = training.pop("k5_rows")
    lm_rows += train_k5
    lap("training")
    # phase 8f: the families' training, every new shape held first
    fam_train, ft_k5, ft_k1 = _drive_family_training(
        rt, dev, lap, [r for r in train_k5 if r["phase"] == "traj_f32"])
    lm_rows += ft_k5
    torch.cuda.empty_cache()
    lap("families' training")
    _library_warmer_state(warmer, t_start, stop=True)
    # phase 9: the analysis layer (slice 15)
    analysis = _drive_analysis(rt, compiled, scale["mesh"].pop(
        "analysis_ranks"))
    lap("analysis")
    all_rows = (rows + d_rows + s_rows + z_rows + b_rows + mesh_rows
                + lm_rows + training.pop("k1_rows") + ft_k1)
    for row in all_rows:
        if row["launches"] < 1:
            raise AssertionError(f"held shape {row['shape']} "
                                 f"({row['phase']}) was never launched")

    lines = []
    for name, src, tpu in (("gossip_mix", MIX_SRC, MIX_TPU),
                           ("lda_gibbs", GIBBS_SRC, GIBBS_TPU),
                           ("lda_l2r", L2R_SRC, L2R_TPU),
                           ("lda_sparse", SPARSE_SRC, SPARSE_TPU)):
        mine = [r for r in all_rows if r["name"] == name]
        lines.append(_kernel_line(name, "cuda", src, tpu, mine,
                                  node_err[name]))
    k5 = _kernel_line("flash_attention", "cuda", FLASH_SRC, FLASH_TPU,
                      lm_rows, 0.0)
    top = max(lm_rows, key=lambda r: r["launches"])
    k5.update(library_ms=top["library_ms"], library=top["library"])
    lines.append(k5)
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"e2e": {
        "goem_steps_per_s": closed["train_steps_per_s"],
        "closed_loop": _e2e(closed, None),
        "open_loop": _e2e(opened, rate), "card": card}}))
    print(json.dumps({"deleda": {"paper": paper, "full_width": full,
                                 "profile": profile,
                                 "trajectory_check": trajectory,
                                 "card": card}}))
    print(json.dumps({"unique_layout": {"full_width": zipf,
                                        "sparse_bench": bench,
                                        "card": card}}))
    print(json.dumps({"lm_serving": lm}))
    print(json.dumps({"families": families}))
    print(json.dumps({"lifecycle": life}))
    print(json.dumps({"scenarios": scen}))
    print(json.dumps({"scale": scale}))
    print(json.dumps({"training": training}))
    print(json.dumps({"families_training": fam_train}))
    print(json.dumps({"analysis": analysis}))
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
