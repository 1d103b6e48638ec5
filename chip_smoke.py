#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py

1. Prints torch, CUDA and driver versions and the card's name and power
   limit (``nvidia-smi --query-gpu=name,power.limit``).
2. Builds every kernel from ``src/repro_torch/kernels/*/csrc`` with
   ``nvcc`` (one process per source, all at once) and prints the seconds.
3. Holds each kernel against its plain torch version on the card, and
   times both (median of CUDA-event timings after warm-up), at the
   paper's node shape (K=5, V=1,000, L=32) and at every shape the main
   path launches at K=100, V=50,000: ``lda_gibbs`` at the G-OEM E-step
   (B=256, L=64, 30 sweeps, Poisson(10) lengths) and at each serving
   bucket's mixture slab (B=64, L=16/32/64, 8 sweeps), ``lda_l2r`` at
   each bucket's "ll" slab (B=64, P=10), with each bucket's request
   lengths. ``lda_gibbs`` per_pos, z and ndk_mean may differ only at a
   counted ulp tie, ``lda_l2r`` per-document LLs agree at rtol 1e-5; the
   E-step's ``[K, V]`` scatter is the same bits twice.
4. Runs the main path, ``repro_torch.launch.serve_topics.main``, at
   K=100, V=50,000, L=64 with request lengths uniform in [2, 64] (as
   ``benchmarks/serve_bench.py`` draws them), twice, the launch counters
   set to 0 before each and read after: closed loop (G-OEM 20 steps at
   batch 256, then all 2,048 requests at once, a quarter of them
   mixtures: the node's capacity), then open loop from the saved
   statistic at 70% of that capacity (serve_bench's rule) for p50/p99.
   Checks that both kernels launched in each run, once per G-OEM step
   and per slab, every "ll" is finite, mixtures sum to 1 and served "ll"
   answers equal ``evaluate_heldout`` at the bucket length.
5. Prints one ``{"kernels": [...]}`` line (each kernel at the shape most
   main-path launches have, and every shape under ``per_shape``) and one
   line of end-to-end numbers.
6. Prints ``{"ok": true, "device": {...}}`` last.

Any failed phase raises and the script exits non-zero. Without a CUDA
device it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

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


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def _inputs(rt, dev, case, k, v, seed):
    """Likelihood rows of random words under a random statistic.

    Lengths follow ``case["lengths"]``: ("poisson", lo, hi) is Poisson(10)
    clipped to [lo, hi] (the training corpus), ("uniform", lo, hi) uniform
    in [lo, hi] (the requests a bucket admits); ``full_first`` makes the
    first document ``hi`` long.
    """
    b, l, s = case["b"], case["l"], case.get("s", 1)
    kind, lo, hi = case["lengths"]
    g = torch.Generator(device=dev).manual_seed(seed)
    stats = torch.rand((k, v), generator=g, device=dev)
    words = torch.randint(0, v, (b, l), generator=g, device=dev)
    if kind == "poisson":
        lengths = torch.clamp(torch.poisson(
            torch.full((b,), 10.0, device=dev), generator=g), lo, hi)
    else:
        lengths = torch.randint(lo, hi + 1, (b,), generator=g, device=dev)
    if case.get("full_first"):
        lengths[0] = hi
    mask = torch.arange(l, device=dev)[None, :] < lengths[:, None]
    beta_w = rt.estep.beta_w_from_stats(stats, words, 1e-2)
    uniforms = torch.rand((s, b, l), generator=g, device=dev)
    z0 = torch.randint(0, k, (b, l), generator=g, device=dev)
    return words, beta_w, mask.float(), uniforms, z0


def _time_ms(fn, reps: int, warmup: int = 1):
    """Median CUDA-event milliseconds of ``fn`` and its last output."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times), out


def _bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
        lambda: rt.estep.gibbs_sweeps_dense(bw, mf, u, z0, **kw), reps=2,
        warmup=0)
    ms, got = _time_ms(lambda: rt.gibbs_ops.gibbs_sweeps(bw, mf, u, z0, **kw),
                       reps=7)
    bad = torch.zeros(b, dtype=torch.bool, device=dev)
    for g, w in zip(got, want):
        close = torch.isclose(g.double(), w.double(), rtol=1e-5, atol=1e-6)
        bad |= ~close.reshape(b, -1).all(-1)
    flips = int(bad.sum())
    active = int(mf.sum())
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
          f"{flips} in {active * s} draws; {ms:.3f} ms (plain "
          f"{plain_ms:.3f} ms, bound {bound:.5f} ms by {by})", flush=True)
    return dict(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, active_tokens=active, max_abs_err=err,
                tie_flips=flips)


def _hold_l2r(rt, dev, case, k, v, seed):
    """The kernel against its plain version at one shape, and their times."""
    b, l, p = case["b"], case["l"], case["p"]
    _w, bw, mf, _u, _z = _inputs(rt, dev, case, k, v, seed)
    kd = rt.tf3.fold_in_data(rt.tf3.key(seed, dev),
                             torch.arange(b, device=dev))
    plain_ms, want = _time_ms(
        lambda: rt.evaluation.l2r_position_scores(kd, bw, mf, 0.5, p),
        reps=2, warmup=0)
    ms, got = _time_ms(
        lambda: rt.l2r_ops.l2r_scores(kd, bw, mf, 0.5, n_particles=p),
        reps=7)
    got = rt.evaluation._sum_positions(got)
    want = rt.evaluation._sum_positions(want)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    err = float((got - want).abs().max())
    lens = mf.sum(-1).double()
    bound, by = _l2r_bound(b, l, k, p, lens)
    shape = f"B={b} L={l} K={k} P={p}"
    print(f"lda_l2r vs plain at {shape}: max_abs_err {err:.3g}; {ms:.3f} ms "
          f"(plain {plain_ms:.3f} ms, bound {bound:.5f} ms by {by})",
          flush=True)
    return dict(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, active_tokens=int(mf.sum()), max_abs_err=err)


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


def _drive(rt, dev, argv, cases, trained):
    """One main-path run with the launch counters set to 0 just before.

    Returns its summary and the launches per case (G-OEM steps and slabs
    per queue), after checking that both kernels launched, once per step
    and per slab.
    """
    rt.gibbs_ops.launches = 0
    rt.l2r_ops.launches = 0
    summary = rt.serve_topics.main(argv)
    torch.cuda.synchronize()
    launches = {"lda_gibbs": rt.gibbs_ops.launches,
                "lda_l2r": rt.l2r_ops.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel did not run on the main path: "
                             f"{launches}")
    server = summary["server"]
    per_case = []
    for name, case in cases:
        if case["queue"] == "train":
            per_case.append(TRAIN_STEPS if trained else 0)
            continue
        lb = case["queue"][0]
        if server.slab_docs[lb] != case["b"]:
            raise AssertionError(f"slab of bucket {lb} holds "
                                 f"{server.slab_docs[lb]} documents, the "
                                 f"measured shape {case['b']}")
        per_case.append(server.slabs_by_queue[case["queue"]])
    for name in launches:
        want = sum(n for (nm, _c), n in zip(cases, per_case) if nm == name)
        if launches[name] != want:
            raise AssertionError(f"{name} launched {launches[name]} times, "
                                 f"steps and slabs say {want}")
    _check_served(rt, summary, dev)
    return summary, per_case


class _Port:
    """The port's modules, imported once the checkout is on the path."""

    def __init__(self):
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.core import estep, evaluation, serving
        from repro_torch.core import threefry as tf3
        from repro_torch.kernels import common
        from repro_torch.kernels.lda_gibbs import ops as gibbs_ops
        from repro_torch.kernels.lda_l2r import ops as l2r_ops
        from repro_torch.launch import serve_topics
        self.estep, self.evaluation, self.tf3 = estep, evaluation, tf3
        self.serving = serving
        self.common, self.gibbs_ops, self.l2r_ops = common, gibbs_ops, l2r_ops
        self.serve_topics = serve_topics


def _kernel_line(name, route, source, replaces, rows, node_err):
    """One kernel's entry: totals, the most launched shape, every shape."""
    top = max(rows, key=lambda r: r["launches"])
    return {"name": name, "route": route, "source": source,
            "replaces": replaces,
            "launches": sum(r["launches"] for r in rows),
            "max_abs_err": max([node_err] + [r["max_abs_err"] for r in rows]),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None, "shape": top["shape"],
            "active_tokens": top["active_tokens"], "per_shape": rows}


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    rt = _Port()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _smi("name,power.limit")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} driver "
          f"{_smi('driver_version')} | {card}", flush=True)

    t0 = time.perf_counter()
    logs = rt.common.build_all()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    print(f"kernels built in {build_s:.1f}s: "
          f"{', '.join(rt.common.KERNEL_NAMES)}", flush=True)

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
        closed, n_closed = _drive(
            rt, dev, SERVE_ARGS + ["--closed-loop", "--save", ckpt], cases,
            trained=True)
        rate = LOAD * closed["req_per_s"]
        opened, n_open = _drive(
            rt, dev, SERVE_ARGS + ["--rate", repr(rate), "--restore", ckpt],
            cases, trained=False)
    for row, a, b in zip(rows, n_closed, n_open):
        row["launches"] = a + b

    lines = []
    for name, src, tpu in (("lda_gibbs", GIBBS_SRC, GIBBS_TPU),
                           ("lda_l2r", L2R_SRC, L2R_TPU)):
        mine = [r for (nm, _c), r in zip(cases, rows) if nm == name]
        lines.append(_kernel_line(name, "cuda", src, tpu, mine,
                                  node_err[name]))
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"e2e": {
        "goem_steps_per_s": closed["train_steps_per_s"],
        "closed_loop": _e2e(closed, None),
        "open_loop": _e2e(opened, rate), "card": card}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
