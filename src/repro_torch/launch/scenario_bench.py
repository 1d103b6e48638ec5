"""DELEDA across dynamic-network regimes, with the reference's gates.

The torch counterpart of ``benchmarks/scenario_bench.py``. Sweeps the
named regimes of :mod:`repro_torch.core.scenario` ({static, rewiring,
10% drops, 20% churn, non-IID shards, cold join}; async matchings on a
Watts-Strogatz graph) through
:func:`~repro_torch.launch.deleda_experiment.run_scenario_experiment`
and reports each regime's final relative perplexity, beta distance,
consensus trace, rounds/s and event counts, per seed and as the mean and
spread over ``--seeds``.

The gates, the reference's, asserted at ``--scale paper`` for every
seed: ``rewiring`` and ``drop10`` within ``ACCEPT_RATIO`` (10%) of the
static graph's LP (``lp_ratio_vs_static``), and the cold join's
member-masked consensus inside the eq. (3) envelope over its last
quarter of records (``COLDJOIN_TAIL_FRAC``, all of them).

``--resume-smoke`` runs the lifecycle's kill drill twice: ``static``
with its ``alive`` mask (the reference's drill) and ``coldjoin`` with
its ``member`` mask. Each trains with ``save_every = T/2``, deletes the
final checkpoint, resumes from disk and must equal the uninterrupted run
bit for bit (stats, last record, last consensus).

Departures from the reference. Its bench counts the compilations of
``train_steps`` (one compiled segment for the whole sweep); the port
runs eagerly and compiles nothing, so the bench reports in its place the
kernel launches the sweep made, by kernel (0 on the CPU, where the
plain versions run). It writes no file unless ``-o`` names one (never
the reference's ``BENCH_scenarios.json`` by default).

  PYTHONPATH=src python -m repro_torch.launch.scenario_bench \\
      --scale smoke --device cpu --resume-smoke
  PYTHONPATH=src python -m repro_torch.launch.scenario_bench --seeds 0 1 2

Runs on the GPU (the ``gossip_mix``, ``lda_gibbs`` and ``lda_l2r``
kernels); ``--device cpu`` runs the plain torch path.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import deleda
from repro_torch.core import threefry as tf3
from repro_torch.core.scenario import paper_scenario
from repro_torch.data.lda_synthetic import make_corpus
from repro_torch.launch.deleda_experiment import (get_scale,
                                                  run_scenario_experiment)

__all__ = ["ACCEPT_RATIO", "GATED", "COLDJOIN_TAIL_FRAC", "RESUME_REGIMES",
           "gates", "resume_smoke", "kernel_launches", "main"]

# |LP_scenario / LP_static - 1| bound for the degraded but connected
# regimes; churn and non-IID are reported, not gated
ACCEPT_RATIO = 0.10
GATED = ("rewiring", "drop10")
# share of the cold join's tail records whose member-masked consensus
# sits inside the eq. (3) envelope
COLDJOIN_TAIL_FRAC = 1.0
# the kill drills: the reference's (alive) and the membership one
RESUME_REGIMES = ("static", "coldjoin")


def kernel_launches() -> dict:
    """The kernel wrappers' launch counters, by kernel."""
    from repro_torch.kernels.gossip_mix import ops as mix_ops
    from repro_torch.kernels.lda_gibbs import ops as gibbs_ops
    from repro_torch.kernels.lda_l2r import ops as l2r_ops

    return {"gossip_mix": mix_ops.launches, "lda_gibbs": gibbs_ops.launches,
            "lda_l2r": l2r_ops.launches}


def gates(res: dict) -> dict:
    """One seed's gates: {name: (value, passed)}."""
    out = {}
    for name in GATED:
        if name in res["runs"]:
            ratio = res["runs"][name]["lp_ratio_vs_static"]
            out[name] = (ratio, abs(ratio) <= ACCEPT_RATIO)
    if "coldjoin" in res["runs"]:
        tail = res["runs"]["coldjoin"]["tail_within_envelope"]
        out["coldjoin"] = (tail, tail >= COLDJOIN_TAIL_FRAC)
    return out


def resume_smoke(scale, regime: str = "static", seed: int = 0,
                 device: str | torch.device = "cuda") -> bool:
    """Kill at T/2, resume from disk, compare bitwise to the full run."""
    dev = resolve_device(device)
    corpus = make_corpus(scale.lda, tf3.key(seed, dev), scale.corpus)
    sc = paper_scenario(regime, n=scale.corpus.n_nodes,
                        n_steps=scale.n_steps, seed=seed, ws_k=scale.ws_k)
    sched, degs, alive, member = sc.compile(
        np.random.default_rng(seed + 17)).run_inputs()
    cfg = deleda.DeledaConfig(lda=scale.lda, mode="async",
                              batch_size=scale.batch_size)
    key = tf3.key(seed + 3, dev)
    half = scale.n_steps // 2

    def run(**kw):
        return deleda.run_deleda(cfg, key, corpus.words, corpus.mask, sched,
                                 degs, scale.n_steps, scale.record_every,
                                 alive=alive, member=member, **kw)

    with tempfile.TemporaryDirectory() as d:
        full = run(save_every=half, checkpoint_dir=d)
        # the kill: drop everything after the T/2 checkpoint
        shutil.rmtree(os.path.join(d, f"step_{scale.n_steps:08d}"))
        resumed = run(restore_from=d)
    return bool(torch.equal(full.stats, resumed.stats)
                and torch.equal(full.history[-1], resumed.history[-1])
                and torch.equal(full.consensus[-1], resumed.consensus[-1]))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", default="paper", choices=["paper", "smoke"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain torch path)")
    ap.add_argument("-o", "--out", default=None,
                    help="write the results as JSON here (no file unless "
                         "given)")
    ap.add_argument("--resume-smoke", action="store_true",
                    help="also run the kill-at-T/2-then-resume drills and "
                         "gate on their bits")
    args = ap.parse_args(argv)
    scale = get_scale(f"scenario_{args.scale}")
    print(f"scenario_bench ({args.scale} scale, {args.device}, seeds "
          f"{args.seeds})", flush=True)
    before = kernel_launches()
    res = run_scenario_experiment(scale, device=args.device,
                                  seeds=args.seeds)
    res["kernel_launches"] = {k: v - before[k]
                              for k, v in kernel_launches().items()}
    res["scale"] = args.scale
    print(f"\nkernel launches for the whole sweep: "
          f"{res['kernel_launches']}")
    for name, metrics in res["regimes_over_seeds"].items():
        print(f"  {name:>9s}: " + "  ".join(
            f"{k} {m['mean']:+.4f} [{m['min']:+.4f}, {m['max']:+.4f}]"
            for k, m in metrics.items()))

    ok = True
    if args.scale == "paper":
        res["gates"] = {}
        for seed, one in res["per_seed"].items():
            res["gates"][seed] = gates(one)
            for name, (value, passed) in res["gates"][seed].items():
                ok &= passed
                limit = (f"|ratio| <= {ACCEPT_RATIO:.0%}" if name in GATED
                         else f"tail >= {COLDJOIN_TAIL_FRAC:.0%}")
                print(f"  seed {seed} {name:>9s}: {value:+.4f} "
                      f"({'OK' if passed else 'FAIL'} @ {limit})")
    if args.resume_smoke:
        res["resume_bitwise"] = {}
        for regime in RESUME_REGIMES:
            bit = resume_smoke(scale, regime, seed=args.seeds[0],
                               device=args.device)
            res["resume_bitwise"][regime] = bit
            ok &= bit
            print(f"  resume smoke ({regime}): bitwise "
                  f"{'IDENTICAL (OK)' if bit else 'MISMATCH (FAIL)'}")
    res["accept"] = bool(ok)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
        print(f"wrote {args.out}")
    print(f"accept={res['accept']}")
    if not ok:
        raise SystemExit(1)
    return res


if __name__ == "__main__":
    main()
