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
     {complete, WS}): the Fig. 1a/1b trajectories, the share of records
     inside the eq. (3) envelope, rounds/s per run and claims C1-C3; its
     LP* against the LP* of the same seed's corpus on the CPU (rel 1e-4:
     a corpus is drawn on the CPU on every device);
   - full width, ``core.deleda.run_deleda`` at K=100, V=50,000, L=64,
     n=50, batch 20: 40 rounds of sync matchings on the complete graph
     and 40 async edge events on WS, held-out LP every 20 rounds (3 probe
     nodes, 100 documents, P=10). The initial state is built and timed
     apart; a cold run from it is timed, then a counted run repeats it
     bit for bit: rounds/s, peak memory and each kernel's share of that
     run's wall. Then 10 sync rounds from a built state, timed, then
     again under ``torch.profiler``: the card's idle share over that one
     window, kernels per round, the entries with the most device time
     and the host's waits on the card.
   - a trajectory check at the golden test's shapes (K=3, V=20, L=8,
     N=8, T=20): the CUDA path against the CPU plain path from the same
     inputs (steps equal, mass rtol 1e-4, probe rtol 3e-3, LP rtol 1e-5),
     in both corpus layouts.
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
6. The LM slice (the port's fourth): gemma2-2b at full width (26 layers, d=2304,
   vocab 256,000, random bf16 weights from seed 0). ``flash_attention``
   (K5) is held against its plain version at every shape the phase
   launches (bf16 within 3e-2, float32 within 2e-5; and each output
   row's error within ``ROW_TOL`` of that row's size, a limit shown to
   catch a dropped key split or tile, or inputs rounded to bf16, by a
   control at the long shapes) and timed beside its
   bound and a compiled ``flex_attention`` call (the library yardstick,
   "none" with its error if it does not run): serving's decode against
   the cache (B=4, Sq=1, S_max=192) at q_offset 0, 95 and 190, the
   float32 check's forward [4, 128] and decode (S_max=128), the bf16
   prefill at S=8192, the bf16 decode against an S=8192 cache at its
   last 8 positions; each local (window 4096) and global. Each shape
   prints the kernel variant it takes ("wgmma" for the bf16 prefill,
   "decode" for every Sq=1 launch, "fma" for the float32 forward), and
   every counted run below checks the launches by variant too. Then, with
   the counters set to 0 before each and read after:
   ``launch.serve.main`` (``--arch gemma2_2b --full --batch 4
   --prompt-len 128 --gen 64``): 26 x 191 K5 launches, half local and
   half global, every one at a held shape; prefill s, decode s, tok/s
   and peak memory. The float32 forward over a [4, 128] prompt against
   the same prompt teacher-forced through ``decode_step`` (rel max error
   of the logits < 2e-3, ``tests/test_decode_consistency.py``'s bound).
   ``forward`` once at B=1, S=8192 in bf16 (26 launches): seconds and
   peak memory, then once more under ``torch.profiler`` (device time by
   kernel). 8 bf16 decode steps against an S=8192 cache of random
   keys and values (26 x 8 launches, the keys split over blocks). Then 8
   decode steps under ``torch.profiler``.
7. Prints one ``{"kernels": [...]}`` line (each kernel at the shape most
   main-path launches have, and every shape under ``per_shape`` with its
   counted launches; K2's, K3's and K4's shapes also carry ``chain_ms``,
   the bound of their designs, which make a document's draws (K3: a
   particle's steps) one after another: K2 and K4, S x the longest
   document's active positions x K dependent adds; K3, the most K-add
   chains a document's particle makes, E(E+1)/2 for E active positions
   (``_l2r_chain_ms``); each at this run's t_add, beside the bytes and
   operations bound), one line each of serving, DELEDA, unique-layout
   and LM-serving numbers with the card, and the script's seconds.
8. Prints the card's name and power limit, then ``{"ok": true, ...}``.

Any failed phase raises and the script exits non-zero. Without a CUDA
device it exits non-zero before printing any result.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import pathlib
import re
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
# the LM slice: gemma2-2b at full width served through launch/serve, and
# one prefill at S=8192 (the catalog's prefill_32k cut: its [32, 32768,
# 256000] logits alone would be 537 GB in bf16)
LM = dict(arch="gemma2_2b", batch=4, prompt=128, gen=64, seed=0)
LM_ARGS = ["--arch", LM["arch"], "--full", "--batch", str(LM["batch"]),
           "--prompt-len", str(LM["prompt"]), "--gen", str(LM["gen"]),
           "--seed", str(LM["seed"]), "--device", "cuda"]
PREFILL_S = 8192
LONG_STEPS = 8                 # decode steps against an S=8192 cache
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 dense tensor cores
# K5's row check: the RMS over D of the error of one output row (batch,
# query, head) over the RMS of that row of the plain version. A bf16 row
# carries two roundings of its values (under 4e-3); a 512-key split or a
# 64-key tile dropped from 8,192 keys moves some row by over a fifth
ROW_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
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
        reps=case.get("plain_reps", 2), warmup=0)
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
        reps=case.get("plain_reps", 2), warmup=0)
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
        reps=case.get("plain_reps", 2), warmup=0)
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
        from repro_torch.core import comm, deleda, estep, evaluation, graph
        from repro_torch.core import serving
        from repro_torch.core import lda
        from repro_torch.core import threefry as tf3
        from repro_torch.data import lda_synthetic
        from repro_torch.kernels import common
        from repro_torch.kernels.gossip_mix import ops as mix_ops
        from repro_torch.kernels.gossip_mix import ref as mix_ref
        from repro_torch.kernels.lda_gibbs import ops as gibbs_ops
        from repro_torch.kernels.lda_l2r import ops as l2r_ops
        from repro_torch.kernels.lda_sparse import ops as sparse_ops
        from repro_torch.launch import (deleda_experiment, serve_topics,
                                        sparse_bench)
        from repro_torch.configs import get_config
        from repro_torch.kernels.flash_attention import ops as flash_ops
        from repro_torch.kernels.flash_attention import ref as flash_ref
        from repro_torch.launch import serve as lm_serve
        from repro_torch.models import transformer as lm
        self.estep, self.evaluation, self.tf3 = estep, evaluation, tf3
        self.serving, self.deleda, self.graph, self.lda = (serving, deleda,
                                                           graph, lda)
        self.data, self.comm = lda_synthetic, comm
        self.common, self.gibbs_ops, self.l2r_ops = common, gibbs_ops, l2r_ops
        self.mix_ops, self.mix_ref = mix_ops, mix_ref
        self.sparse_ops, self.sparse_bench = sparse_ops, sparse_bench
        self.serve_topics, self.experiment = serve_topics, deleda_experiment
        self.ops = {"gossip_mix": mix_ops, "lda_gibbs": gibbs_ops,
                    "lda_l2r": l2r_ops, "lda_sparse": sparse_ops}
        # the LM slice's kernel, counted apart from the LDA paths' four
        self.flash_ops, self.flash_ref = flash_ops, flash_ref
        self.lm, self.lm_serve, self.get_config = lm, lm_serve, get_config
        self.flex = None      # compiled flex_attention, the K5 yardstick

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
    """The §4 experiment through its entry point, counters zeroed; its
    launches by shape go to ``rows`` and are checked against the rules."""
    p = rt.experiment.PAPER
    n, graph = p.corpus.n_nodes, rt.graph
    # the same seed's corpus and LP* on the CPU (the plain path): a corpus
    # is drawn on the CPU on every device, so the two LP* agree
    cpu = torch.device("cpu")
    corpus_cpu = rt.data.make_corpus(p.lda, rt.tf3.key(0, cpu), p.corpus)
    _, lp_cpu = rt.experiment.make_beta_evaluator(p, corpus_cpu, 0)
    rt.zero_counts()
    res = rt.experiment.run_experiment(p, seed=0, device=dev)
    torch.cuda.synchronize()
    lp_rel = abs(res["lp_star"] - lp_cpu) / abs(lp_cpu)
    print(f"paper-scale LP* {res['lp_star']:.6f} on the card, "
          f"{lp_cpu:.6f} on the CPU from the same seed (rel {lp_rel:.3g}, "
          f"limit 1e-4; the CPU re-anchor run gave 35.686) | {rt.card}",
          flush=True)
    if not lp_rel < 1e-4:
        raise AssertionError(f"paper-scale LP* differs between the card "
                             f"and the CPU: rel {lp_rel}")
    got = _tally(rt, rows, "paper")
    n_rec = p.n_steps // p.record_every
    want = {"paper_goem": p.n_steps, "paper_eval": 1 + n_rec,
            "paper_sync": 0, "paper_async": 0, "paper_mix": 0,
            "paper_inloop": 0}
    graphs = {"complete": graph.complete_graph(n),
              "watts_strogatz": graph.watts_strogatz_graph(n, p.ws_k, 0.3,
                                                           seed=0)}
    for gobj in graphs.values():
        sched, _degs = rt.deleda.make_run_inputs(gobj, p.n_steps, seed=0)
        for mode in ("async", "sync"):
            e = _expected(mode, sched, p.record_every)
            want[f"paper_{mode}"] += e["lda_gibbs"]
            want["paper_mix"] += e["gossip_mix"]
            want["paper_inloop"] += e["lda_l2r"]
    _check_phases("paper", got, want)
    res["claims"] = rt.experiment.claims(res)
    rt.experiment.print_report(res)
    for name, run in res["runs"].items():
        vals = run["rel_perplexity"] + run["beta_distance"]
        if not np.all(np.isfinite(vals)):
            raise AssertionError(f"paper run {name}: a metric is not finite")
    print(f"(paper scale on {rt.card})", flush=True)
    summary = {k: res[k] for k in ("lp_star", "lambda2", "iterations",
                                   "claims")}
    summary["lp_star_cpu"] = lp_cpu
    summary["runs"] = {
        name: {k: run[k] for k in ("rel_perplexity", "beta_distance",
                                   "rounds_per_s", "wall_sec",
                                   "within_envelope_frac") if k in run}
        for name, run in res["runs"].items()}
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
    kv = dict(k=f["k"], v=f["v"], plain_reps=1)
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


def _trajectory_check(rt, dev):
    """The CUDA path against the CPU plain path from the same inputs, at
    the golden test's shapes (tests/test_golden.py's tolerances)."""
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
    out = []
    for kind, mode, every, layout in (
            ("edge", "async", 0, "dense"), ("matching", "async", 0, "dense"),
            ("matching", "sync", 10, "dense"),
            ("edge", "async", 0, "unique"),
            ("matching", "async", 10, "unique")):
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
                init=state))
        a, b = traces
        sa, sb = a.stats.double(), b.stats.double().cpu()
        where = f"trajectory {kind} {mode} {layout}"
        if a.steps.tolist() != b.steps.cpu().tolist():
            raise AssertionError(f"{where}: steps differ")
        mass = abs(float(sb.sum()) / float(sa.sum()) - 1.0)
        pa, pb = sa[::3, 1, ::7], sb[::3, 1, ::7]
        if mass > 1e-4 or not torch.allclose(pb, pa, rtol=3e-3, atol=1e-5):
            raise AssertionError(f"{where}: mass rel diff {mass}, probe "
                                 f"{pa} vs {pb}")
        row = {"kind": kind, "mode": mode, "layout": layout,
               "mass_rel_diff": mass,
               "probe_max_abs_diff": float((pb - pa).abs().max())}
        if every:
            la, lb = a.eval_lp.double(), b.eval_lp.double().cpu()
            if not torch.allclose(lb, la, rtol=1e-5, atol=0):
                raise AssertionError(f"trajectory eval LP {la} vs {lb}")
            row["eval_lp_max_rel_diff"] = float(((lb - la) / la).abs().max())
        out.append(row)
        print(f"{where} check: {row}", flush=True)
    return out


# --------------------------------------------------------------------------
# LM serving (the port's fourth slice): gemma2-2b through K5
# --------------------------------------------------------------------------

def _visible(sq, sk, window, q_offset):
    """Visible (query, key) pairs of one head, and the keys some query
    sees (the causal mask and the window, keys below Sk)."""
    rows = q_offset + np.arange(sq, dtype=np.int64)
    lo = np.maximum(0, rows - window + 1)
    hi = np.minimum(sk - 1, rows)
    pairs = int(np.maximum(0, hi - lo + 1).sum())
    keys = max(0, int(min(sk - 1, rows[-1]) - max(0, rows[0] - window + 1))
               + 1)
    return pairs, keys


def _flash_bound(case, q_offset):
    """Bytes: Q and O once, K and V rows some query sees once. Operations:
    4 D per visible (query, key) pair and head, at the bf16 tensor-core
    peak for bf16 inputs and the float32 peak for float32 ones."""
    b, sq, sk, h, hkv, d = (case[x] for x in ("b", "sq", "sk", "h", "hkv",
                                               "d"))
    pairs, keys = _visible(sq, sk, case["window"], q_offset)
    elem = 2 if case["dtype"] == torch.bfloat16 else 4
    bytes_moved = elem * (2 * b * sq * h * d + 2 * b * keys * hkv * d)
    ops = 4 * b * h * pairs * d
    peak = BF16_OPS_PER_S if elem == 2 else FP32_OPS_PER_S
    return _bound(bytes_moved, ops, peak), pairs


def _library_attention(rt, q, k, v, case, q_offset):
    """One compiled ``flex_attention`` call of the same function (tanh
    softcap ``score_mod``, causal + window ``mask_mod``), as a callable;
    the offset and window ride in as tensors, so one compile serves every
    offset of a shape."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    if rt.flex is None:
        rt.flex = torch.compile(flex_attention)
    dev = q.device
    off = torch.tensor(q_offset, device=dev)
    win = torch.tensor(case["window"], device=dev)
    cap = case["softcap"]

    def score_mod(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    def mask_mod(b, h, qi, ki):
        return (qi + off >= ki) & (qi + off - ki < win)

    mask = create_block_mask(mask_mod, None, None, case["sq"], case["sk"],
                             device=dev)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    scale = case["scale"]

    def call():
        return rt.flex(qh, kh, vh, score_mod=score_mod, block_mask=mask,
                       scale=scale, enable_gqa=True).transpose(1, 2)
    return call


def _flash_cases(rt):
    """Every K5 shape the LM phase launches: serving's decode against the
    cache (bf16), the f32 consistency check's forward and decode, the
    bf16 prefill at S=8192 and the bf16 decode against an S=8192 cache;
    local (window 4096) and global layers. Each names the kernel variant
    it must take: "wgmma" for the bf16 prefill at D=256, "decode" for
    every Sq=1 launch, "fma" for the float32 forward."""
    cfg = rt.get_config(LM["arch"])
    s_max = LM["prompt"] + LM["gen"]
    base = dict(h=cfg.n_heads, hkv=cfg.n_kv, d=cfg.hd,
                softcap=cfg.attn_softcap, scale=cfg.query_scale)
    cases = []
    for kind, window in (("local", cfg.window),
                         ("global", rt.flash_ops.GLOBAL_WINDOW)):
        w = dict(base, window=window, kind=kind)
        cases += [
            dict(w, phase=f"decode_{kind}", b=LM["batch"], sq=1, sk=s_max,
                 dtype=torch.bfloat16, tol=3e-2, variant="decode",
                 offsets=(0, s_max // 2 - 1, s_max - 2)),
            dict(w, phase=f"prefill_{kind}", b=1, sq=PREFILL_S,
                 sk=PREFILL_S, dtype=torch.bfloat16, tol=3e-2,
                 variant="wgmma", offsets=(0,), control="tile"),
            dict(w, phase=f"f32_forward_{kind}", b=LM["batch"],
                 sq=LM["prompt"], sk=LM["prompt"], dtype=torch.float32,
                 tol=2e-5, variant="fma", offsets=(0,), control="bf16"),
            dict(w, phase=f"f32_decode_{kind}", b=LM["batch"], sq=1,
                 sk=LM["prompt"], dtype=torch.float32, tol=2e-5,
                 variant="decode", control="bf16",
                 offsets=(0, LM["prompt"] // 2 - 1, LM["prompt"] - 1)),
            dict(w, phase=f"decode_long_{kind}", b=LM["batch"], sq=1,
                 sk=PREFILL_S, dtype=torch.bfloat16, tol=3e-2,
                 variant="decode", control="split",
                 offsets=(PREFILL_S - LONG_STEPS,
                          PREFILL_S - LONG_STEPS // 2 - 1, PREFILL_S - 1))]
    return cases


def _row_err(got, want):
    """The largest relative error of one output row (batch, query, head):
    the RMS over D of ``got - want`` over the RMS of that row of ``want``
    (a row of zeros counts its error over 1e-6)."""
    g, w = got.double(), want.double()
    err = (g - w).pow(2).mean(-1).sqrt()
    return float((err / w.pow(2).mean(-1).sqrt().clamp_min(1e-6)).max())


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
              scale=case["scale"])
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
    try:
        call = _library_attention(rt, q, k, v, case, mid)
        lib_ms, out = _time_ms(call, reps=5, warmup=2, device_only=True)
        lib_err = float((out.float() - plain(mid).float()).abs().max())
        library = f"{lib_ms:.4f} ms (max_abs_err {lib_err:.3g})"
    except Exception as exc:          # recorded, not fatal: a yardstick
        lib_ms = None
        library = f"none: {type(exc).__name__}: {str(exc)[:200]}"
    shape = (f"B={b} Sq={sq} Sk={sk} H={h}/{hkv} D={d} "
             f"{'bf16' if case['dtype'] == torch.bfloat16 else 'f32'} "
             f"{case['kind']} softcap {case['softcap']}")
    print(f"flash_attention [{var}] vs plain at {shape}, q_offset "
          f"{list(case['offsets'])}: max_abs_err {err:.3g} (tol "
          f"{case['tol']}), row error {row_err:.3g} (limit {row_tol}"
          f"{'' if control is None else f'; {control} control {ctl_err:.3g}'}"
          f"); {by_offset[mid]:.4f} ms at offset {mid} (all "
          f"{ {o: round(t, 4) for o, t in by_offset.items()} }), plain "
          f"{plain_ms:.3f} ms, bound {bound:.5f} ms by {by}, library "
          f"{library} | {rt.card}", flush=True)
    key = rt.flash_ops.shape_key(q, k, case["window"], case["softcap"])
    return dict(name="flash_attention", key=key, shape=shape,
                phase=case["phase"], variant=var, ms=by_offset[mid],
                ms_by_offset=by_offset, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, visible_pairs_per_head=pairs,
                library_ms=lib_ms, library=library,
                library_max_abs_err=lib_err, max_abs_err=err,
                tol=case["tol"], row_err=row_err, row_tol=row_tol,
                control=control, control_row_err=ctl_err, launches=0)


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
    cfg = rt.get_config(LM["arch"])
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
    lm = {"arch": cfg.name, "n_params": cfg.n_params(),
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
    print(f"gemma2-2b serving B={LM['batch']} prompt {LM['prompt']} gen "
          f"{LM['gen']}: prefill {lm['prefill_s']:.3f} s, decode "
          f"{lm['decode_s']:.3f} s = {lm['decode_tok_per_s']:.1f} tok/s, "
          f"peak {lm['serve_peak_mem_gb']:.2f} GB | {rt.card}", flush=True)
    return rows, lm


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


def main() -> int:
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

    t0 = time.perf_counter()
    probe = _start_add_chain(rt)
    logs = rt.common.build_all()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        for line in _ptxas_lines(log):
            print(f"  {name}: {line}")
    print(f"kernels built in {build_s:.1f}s: "
          f"{', '.join(rt.common.KERNEL_NAMES)}", flush=True)
    _time_add(rt, dev, *probe)
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

    # phase 5: DELEDA, every launched shape held first, then the paths
    d_cases = _deleda_cases(rt)
    d_rows = _hold_deleda(rt, dev, d_cases)
    node_err["gossip_mix"] = _check_mix_scalar(rt, dev)
    trajectory = _trajectory_check(rt, dev)
    paper = _drive_paper(rt, dev, [r for r in d_rows
                                   if r["phase"].startswith("paper")])
    torch.cuda.empty_cache()
    full_rows = [r for r in d_rows if r["phase"].startswith("full")]
    full = _drive_full(rt, dev, full_rows, *_full_width_inputs(rt, dev))
    torch.cuda.empty_cache()
    profile = _profile_rounds(rt, dev)

    # phase 6: the unique-token layout (slice 3), shapes held in each
    node_err["lda_sparse"] = _check_sparse_binary(rt, dev)
    mix_rows = [r for r in full_rows if r["name"] == "gossip_mix"]
    z_rows, zipf = _drive_zipf(rt, dev, mix_rows)
    torch.cuda.empty_cache()
    b_rows, bench = _drive_sparse_bench(rt, dev)
    torch.cuda.empty_cache()

    # phase 7: the LM slice, gemma2-2b served through K5
    lm_rows, lm = _drive_lm(rt, dev)
    torch.cuda.empty_cache()
    all_rows = rows + d_rows + z_rows + b_rows + lm_rows
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
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
