"""The paper's §4 experiment (Fig. 1a/1b and eq. (3)) on the port.

The torch counterpart of ``benchmarks/_deleda_experiment.py`` and of the
three drivers that print it (``fig1a_perplexity.py``,
``fig1b_beta_distance.py``, ``consensus.py``). Centralized G-OEM and
DELEDA {async, sync} x {complete, Watts-Strogatz} run on one synthetic
corpus; each is scored per record by

  * the relative held-out log-perplexity LP/LP* - 1 (Fig. 1a; DELEDA's LP
    is recorded inside the training loop, mean over the probe nodes),
  * the topic-matrix distance D(beta, beta*) (Fig. 1b; mean over the
    probe nodes' recorded statistics),
  * the consensus distance ||S - mean||_F against the lambda2 envelope of
    eq. (3) (share of records inside it),

and by the rounds per second of each run. :func:`claims` reduces the
trajectories to the numbers of claims C1-C3 of ``fig1a_perplexity.py``.

  PYTHONPATH=src python -m repro_torch.launch.deleda_experiment --scale paper
  PYTHONPATH=src python -m repro_torch.launch.deleda_experiment \\
      --scale reduced --device cpu

Runs on the GPU (the ``gossip_mix``, ``lda_gibbs`` and ``lda_l2r``
kernels); ``--device cpu`` runs the plain torch path instead.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import deleda
from repro_torch.core import threefry as tf3
from repro_torch.core.evaluation import (EvalSpec, log_perplexity,
                                         relative_perplexity_error)
from repro_torch.core.graph import complete_graph, watts_strogatz_graph
from repro_torch.core.lda import LDAConfig, beta_distance, eta_star
from repro_torch.core.oem import run_oem
from repro_torch.data.lda_synthetic import CorpusSpec, make_corpus

__all__ = ["ExperimentScale", "REDUCED", "PAPER", "get_scale",
           "make_eval_spec", "make_beta_evaluator", "run_experiment",
           "claims", "main"]

C1_TOL = 0.03     # C1 holds when a run ends within 0.03 of G-OEM's LP/LP*-1


@dataclasses.dataclass(frozen=True)
class ExperimentScale:
    lda: LDAConfig
    corpus: CorpusSpec
    n_steps: int
    record_every: int
    batch_size: int
    ws_k: int
    n_particles: int
    probe_nodes: int = 3


REDUCED = ExperimentScale(
    lda=LDAConfig(n_topics=5, vocab_size=50, alpha=0.5, doc_len_max=24,
                  n_gibbs=10, n_gibbs_burnin=5),
    corpus=CorpusSpec(n_nodes=20, docs_per_node=10, n_test=30),
    n_steps=150, record_every=15, batch_size=10, ws_k=4, n_particles=5)

# the exact §4 setup (src/repro/configs/lda_paper.py): n=50, 20 docs per
# node, V=100, K=5, complete graph and WS(k=4, p=0.3)
PAPER = ExperimentScale(
    lda=LDAConfig(n_topics=5, vocab_size=100, alpha=0.5, doc_len_max=32,
                  n_gibbs=30, n_gibbs_burnin=15),
    corpus=CorpusSpec(n_nodes=50, docs_per_node=20, n_test=100),
    n_steps=400, record_every=40, batch_size=20, ws_k=4, n_particles=10)


def get_scale(name: str) -> ExperimentScale:
    return {"reduced": REDUCED, "paper": PAPER}[name]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_eval_spec(scale: ExperimentScale, corpus, seed: int) -> EvalSpec:
    """The in-loop held-out request; the same key as the post-hoc
    evaluator, so in-loop and post-hoc LPs are one estimator stream."""
    dev = corpus.test_words.device
    return EvalSpec(words=corpus.test_words, mask=corpus.test_mask,
                    key=tf3.key(seed + 1, dev),
                    n_particles=scale.n_particles,
                    probe_nodes=scale.probe_nodes)


def make_beta_evaluator(scale: ExperimentScale, corpus, seed: int):
    """(eval_beta, lp_star): per-statistic (relative perplexity, D)."""
    k_eval = tf3.key(seed + 1, corpus.test_words.device)
    lp_star = float(log_perplexity(k_eval, corpus.test_words,
                                   corpus.test_mask, corpus.beta_star,
                                   scale.lda.alpha, scale.n_particles))

    def eval_beta(stats) -> tuple[float, float]:
        beta = eta_star(stats, scale.lda.tau)
        lp = float(log_perplexity(k_eval, corpus.test_words,
                                  corpus.test_mask, beta, scale.lda.alpha,
                                  scale.n_particles))
        return (relative_perplexity_error(lp, lp_star),
                float(beta_distance(beta, corpus.beta_star)))

    return eval_beta, lp_star


def run_experiment(scale: ExperimentScale, seed: int = 0,
                   device: str | torch.device = "cuda",
                   verbose: bool = True) -> dict:
    """G-OEM and every (mode, graph) DELEDA run; per-record metrics."""
    dev = resolve_device(device)
    corpus = make_corpus(scale.lda, tf3.key(seed, dev), scale.corpus)
    n = scale.corpus.n_nodes
    graph_objs = {"complete": complete_graph(n),
                  "watts_strogatz": watts_strogatz_graph(n, scale.ws_k, 0.3,
                                                         seed=seed)}

    eval_beta, lp_star = make_beta_evaluator(scale, corpus, seed)
    results = {"lp_star": lp_star, "runs": {}, "lambda2": {},
               "iterations": list(range(scale.record_every,
                                        scale.n_steps + 1,
                                        scale.record_every))}

    _sync(dev)
    t0 = time.perf_counter()
    oem = run_oem(scale.lda, tf3.key(seed + 2, dev), corpus.flat_words,
                  corpus.flat_mask, n_steps=scale.n_steps,
                  batch_size=scale.batch_size,
                  record_every=scale.record_every)
    _sync(dev)
    wall = time.perf_counter() - t0   # lint: allow(timer-no-barrier)
    rel, dist = zip(*[eval_beta(s) for s in oem.stats_history])
    results["runs"]["goem"] = {"rel_perplexity": list(rel),
                               "beta_distance": list(dist),
                               "wall_sec": wall,
                               "rounds_per_s": scale.n_steps / wall}
    if verbose:
        print(f"  goem: {wall:.1f}s  rel={rel[-1]:+.4f} D={dist[-1]:.4f}",
              flush=True)

    eval_spec = make_eval_spec(scale, corpus, seed)
    for gname, graph in graph_objs.items():
        results["lambda2"][gname] = graph.lambda2()
        for mode in ("async", "sync"):
            cfg = deleda.DeledaConfig(lda=scale.lda, mode=mode,
                                      batch_size=scale.batch_size,
                                      eval_every=scale.record_every)
            sched, degs = deleda.make_run_inputs(graph, scale.n_steps,
                                                 seed=seed)
            _sync(dev)
            t0 = time.perf_counter()
            trace = deleda.run_deleda(cfg, tf3.key(seed + 3, dev),
                                      corpus.words, corpus.mask, sched,
                                      degs, scale.n_steps,
                                      scale.record_every,
                                      eval_spec=eval_spec)
            _sync(dev)
            wall = time.perf_counter() - t0   # lint: allow(timer-no-barrier)
            rels = relative_perplexity_error(trace.eval_lp.mean(dim=1),
                                             lp_star).tolist()
            dists = [float(np.mean([float(beta_distance(
                eta_star(h[i], scale.lda.tau), corpus.beta_star))
                for i in range(scale.probe_nodes)]))
                for h in trace.history]
            rep = deleda.consensus_report(trace, graph, cfg, scale.n_steps,
                                          scale.record_every)
            results["runs"][f"{mode}_{gname}"] = {
                "rel_perplexity": rels,
                "beta_distance": dists,
                "consensus": rep["measured"].tolist(),
                "envelope": rep["envelope"].tolist(),
                "within_envelope_frac": rep["within_envelope_frac"],
                "wall_sec": wall,
                "rounds_per_s": scale.n_steps / wall,
            }
            if verbose:
                print(f"  {mode}_{gname}: {wall:.1f}s rel={rels[-1]:+.4f} "
                      f"D={dists[-1]:.4f} "
                      f"cons={rep['measured'][-1]:.4f}", flush=True)
    return results


def claims(results: dict, c1_tol: float = C1_TOL) -> dict:
    """Claims C1-C3 of ``benchmarks/fig1a_perplexity.py`` as numbers.

    C1: each DELEDA run's final LP/LP*-1 minus G-OEM's (the plateau gap;
    holds within ``c1_tol``). C2: per mode, the mean LP/LP*-1 over the
    records on Watts-Strogatz minus on the complete graph (>= 0: the
    complete graph converges no slower). C3: per graph, sync minus async
    (>= 0: async converges at least as fast).
    """
    runs = results["runs"]
    goem = runs["goem"]["rel_perplexity"][-1]
    out = {"c1_tol": c1_tol, "C1": {}, "C2_ws_minus_complete": {},
           "C3_sync_minus_async": {}}
    for name, run in runs.items():
        if name != "goem":
            gap = run["rel_perplexity"][-1] - goem
            out["C1"][name] = {"gap_to_goem": gap, "holds": gap <= c1_tol}

    def mean(name):
        return float(np.mean(runs[name]["rel_perplexity"]))

    for mode in ("async", "sync"):
        out["C2_ws_minus_complete"][mode] = (mean(f"{mode}_watts_strogatz")
                                             - mean(f"{mode}_complete"))
    for g in ("complete", "watts_strogatz"):
        out["C3_sync_minus_async"][g] = mean(f"sync_{g}") - mean(f"async_{g}")
    return out


def print_report(res: dict) -> None:
    """The tables the reference's Fig. 1 and consensus drivers print."""
    names = list(res["runs"])
    for title, key in (("Fig. 1a: LP/LP* - 1", "rel_perplexity"),
                       ("Fig. 1b: D(beta, beta*)", "beta_distance")):
        print(f"\n{title}\niter  " + "  ".join(f"{k:>22s}" for k in names))
        for i, it in enumerate(res["iterations"]):
            row = "  ".join(f"{res['runs'][k][key][i]:>22.4f}"
                            for k in names)
            print(f"{it:5d} {row}")
    print(f"\neq. (3) consensus\n{'run':>22s} {'final_cons':>11s} "
          f"{'envelope':>10s} {'within_env':>10s} {'rounds/s':>9s}")
    for k in names:
        run = res["runs"][k]
        if "consensus" in run:
            print(f"{k:>22s} {run['consensus'][-1]:11.4f} "
                  f"{run['envelope'][-1]:10.4f} "
                  f"{run['within_envelope_frac']:10.2f} "
                  f"{run['rounds_per_s']:9.2f}")
        else:
            print(f"{k:>22s} {'':>11s} {'':>10s} {'':>10s} "
                  f"{run['rounds_per_s']:9.2f}")
    print(f"\nLP* = {res['lp_star']:.3f}; lambda2 = {res['lambda2']}")
    print(f"claims: {json.dumps(res['claims'])}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", default="reduced",
                    choices=["reduced", "paper"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain torch path)")
    args = ap.parse_args(argv)
    print(f"deleda_experiment ({args.scale} scale, {args.device})",
          flush=True)
    res = run_experiment(get_scale(args.scale), seed=args.seed,
                         device=args.device)
    res["claims"] = claims(res)
    print_report(res)
    return res


if __name__ == "__main__":
    main()
