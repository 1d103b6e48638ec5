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

:func:`run_scenario_experiment` runs async DELEDA under the named
dynamic-network regimes of :mod:`repro_torch.core.scenario` (static,
rewiring, drops, churn, non-IID shards, a cold join) on one corpus family
and reports each regime's final metrics and its LP ratio against the
static graph (``launch/scenario_bench`` gates them). Both take ``seeds``:
one run per seed, and the mean and spread (min, max) over the seeds of
each claim C1-C3 or each regime's metrics.

  PYTHONPATH=src python -m repro_torch.launch.deleda_experiment --scale paper
  PYTHONPATH=src python -m repro_torch.launch.deleda_experiment \\
      --scale reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.deleda_experiment \\
      --scale paper --seeds 0 1 2

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
from repro_torch.core.scenario import SCENARIO_NAMES, paper_scenario
from repro_torch.data.lda_synthetic import CorpusSpec, make_corpus

__all__ = ["ExperimentScale", "REDUCED", "PAPER", "SCENARIO_PAPER",
           "SCENARIO_SMOKE", "get_scale", "make_eval_spec",
           "make_beta_evaluator", "run_experiment",
           "run_scenario_experiment", "claims", "spread", "main"]

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


# the scenario sweep keeps the paper's n=50, V=100, K=5 but fewer sweeps
# per E-step: it compares network regimes at fixed compute, not the
# paper's absolute numbers (the reference's values)
SCENARIO_PAPER = ExperimentScale(
    lda=LDAConfig(n_topics=5, vocab_size=100, alpha=0.5, doc_len_max=32,
                  n_gibbs=10, n_gibbs_burnin=5),
    corpus=CorpusSpec(n_nodes=50, docs_per_node=20, n_test=50),
    n_steps=300, record_every=50, batch_size=10, ws_k=4, n_particles=5)

SCENARIO_SMOKE = ExperimentScale(
    lda=LDAConfig(n_topics=3, vocab_size=24, alpha=0.5, doc_len_max=12,
                  n_gibbs=4, n_gibbs_burnin=2),
    corpus=CorpusSpec(n_nodes=10, docs_per_node=4, n_test=8),
    n_steps=20, record_every=10, batch_size=2, ws_k=4, n_particles=2)


def get_scale(name: str) -> ExperimentScale:
    return {"reduced": REDUCED, "paper": PAPER,
            "scenario_paper": SCENARIO_PAPER,
            "scenario_smoke": SCENARIO_SMOKE}[name]


def spread(values) -> dict:
    """The mean and the spread (min, max) of one metric over seeds."""
    vals = [float(v) for v in values]
    return {"mean": float(np.mean(vals)), "min": min(vals),
            "max": max(vals)}


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
                   verbose: bool = True, seeds=None) -> dict:
    """G-OEM and every (mode, graph) DELEDA run; per-record metrics.

    ``seeds`` (a sequence) runs the experiment once per seed instead and
    returns ``{"seeds", "per_seed": {seed: results with "claims"},
    "claims_over_seeds"}``: each claim number's mean and spread."""
    if seeds is not None:
        per_seed = {}
        for s in seeds:
            res = run_experiment(scale, s, device, verbose)
            res["claims"] = claims(res)
            per_seed[s] = res
        return {"seeds": list(seeds), "per_seed": per_seed,
                "claims_over_seeds": claims_over_seeds(
                    [r["claims"] for r in per_seed.values()])}
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


def claims_over_seeds(per_seed: list) -> dict:
    """Each claim number of :func:`claims` as its mean and spread over
    the seeds' claims; C1 also counts the seeds where it holds."""
    first = per_seed[0]
    out = {"c1_tol": first["c1_tol"], "C1": {}}
    for name in first["C1"]:
        gaps = [c["C1"][name]["gap_to_goem"] for c in per_seed]
        out["C1"][name] = dict(spread(gaps), holds=sum(
            c["C1"][name]["holds"] for c in per_seed), seeds=len(per_seed))
    for key in ("C2_ws_minus_complete", "C3_sync_minus_async"):
        out[key] = {k: spread([c[key][k] for c in per_seed])
                    for k in first[key]}
    return out


def run_scenario_experiment(scale: ExperimentScale,
                            scenario_names=SCENARIO_NAMES, seed: int = 0,
                            device: str | torch.device = "cuda",
                            verbose: bool = True, seeds=None) -> dict:
    """Async DELEDA across the dynamic-network regimes of
    :mod:`repro_torch.core.scenario`, as the reference's.

    One corpus family (the same beta* and held-out set; ``noniid``
    re-biases only the training shards); each regime's scenario is
    compiled from ``default_rng(seed + 17)`` and run from key ``seed +
    3``. Per regime: the probe nodes' mean final relative perplexity and
    D(beta, beta*), the consensus trace, rounds/s, the event counts, the
    segments and the LP ratio against ``static``; a regime with
    membership (``coldjoin``) also reports the member-masked consensus
    against the eq. (3) envelope over all records and over the last
    quarter (``tail_within_envelope``). ``seeds`` as in
    :func:`run_experiment`: ``{"seeds", "per_seed", "regimes_over_seeds"}``
    with each regime's metrics' mean and spread.
    """
    if seeds is not None:
        per_seed = {s: run_scenario_experiment(scale, scenario_names, s,
                                               device, verbose)
                    for s in seeds}
        over = {}
        for name in scenario_names:
            runs = [r["runs"][name] for r in per_seed.values()]
            over[name] = {k: spread([run[k] for run in runs])
                          for k in ("rel_perplexity", "beta_distance",
                                    "lp_ratio_vs_static") if k in runs[0]}
        return {"seeds": list(seeds), "per_seed": per_seed,
                "regimes_over_seeds": over}
    dev = resolve_device(device)
    n = scale.corpus.n_nodes
    base_corpus = make_corpus(scale.lda, tf3.key(seed, dev), scale.corpus)
    eval_beta, lp_star = make_beta_evaluator(scale, base_corpus, seed)
    results = {"lp_star": lp_star, "n_steps": scale.n_steps,
               "n_nodes": n, "runs": {}}
    for name in scenario_names:
        sc = paper_scenario(name, n=n, n_steps=scale.n_steps, seed=seed,
                            ws_k=scale.ws_k)
        corpus = base_corpus
        if sc.topic_skew is not None:
            corpus = make_corpus(scale.lda, tf3.key(seed, dev),
                                 dataclasses.replace(
                                     scale.corpus, topic_skew=sc.topic_skew))
            # the same key: the same beta* and held-out set
            if not torch.equal(corpus.test_words, base_corpus.test_words):
                raise AssertionError(f"{name}: the skewed corpus' held-out "
                                     f"set differs from the base corpus'")
        compiled = sc.compile(np.random.default_rng(seed + 17))
        sched, degs, alive, member = compiled.run_inputs()
        cfg = deleda.DeledaConfig(lda=scale.lda, mode="async",
                                  batch_size=scale.batch_size)
        _sync(dev)
        t0 = time.perf_counter()
        trace = deleda.run_deleda(cfg, tf3.key(seed + 3, dev), corpus.words,
                                  corpus.mask, sched, degs, scale.n_steps,
                                  scale.record_every, alive=alive,
                                  member=member)
        _sync(dev)
        wall = time.perf_counter() - t0   # lint: allow(timer-no-barrier)
        vals = [eval_beta(trace.stats[i]) for i in range(scale.probe_nodes)]
        run = {
            "rel_perplexity": float(np.mean([v[0] for v in vals])),
            "beta_distance": float(np.mean([v[1] for v in vals])),
            "consensus": trace.consensus.tolist(),
            "wall_sec": wall,
            "rounds_per_s": scale.n_steps / wall,
            "mean_steps_per_node": float(trace.steps.double().mean()),
            "events": {"drawn": compiled.n_events,
                       "dropped": compiled.n_dropped,
                       "churned": compiled.n_churned,
                       "excluded": compiled.n_excluded,
                       "sponsored": compiled.n_sponsored},
            "n_segments": compiled.schedule.n_segments,
        }
        if member is not None:
            # the cold-join gate: the member-masked consensus re-enters
            # the eq. (3) envelope once the joiner's statistic is mixed in
            rep = deleda.consensus_report(trace, sc.topology.graphs[0], cfg,
                                          scale.n_steps, scale.record_every)
            tail = max(1, len(rep["measured"]) // 4)
            run["within_envelope_frac"] = rep["within_envelope_frac"]
            run["tail_within_envelope"] = float(
                (rep["measured"][-tail:]
                 <= rep["envelope"][-tail:] + 1e-6).mean())
        results["runs"][name] = run
        if verbose:
            ev = run["events"]
            print(f"  {name:>9s}: {wall:6.2f}s rel={run['rel_perplexity']:+.4f}"
                  f" D={run['beta_distance']:.4f} events={ev['drawn']} "
                  f"dropped={ev['dropped']} churned={ev['churned']} "
                  f"sponsored={ev['sponsored']}", flush=True)
    if "static" in results["runs"]:
        lp_static = 1.0 + results["runs"]["static"]["rel_perplexity"]
        for run in results["runs"].values():
            run["lp_ratio_vs_static"] = ((1.0 + run["rel_perplexity"])
                                         / lp_static - 1.0)
    return results


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
    ap.add_argument("--seeds", type=int, nargs="+", default=None,
                    help="run once per seed and report each claim's mean "
                         "and spread (min, max) over them")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain torch path)")
    args = ap.parse_args(argv)
    print(f"deleda_experiment ({args.scale} scale, {args.device})",
          flush=True)
    if args.seeds is None:
        res = run_experiment(get_scale(args.scale), seed=args.seed,
                             device=args.device)
        res["claims"] = claims(res)
        print_report(res)
        return res
    res = run_experiment(get_scale(args.scale), device=args.device,
                         seeds=args.seeds)
    for seed, one in res["per_seed"].items():
        print(f"\nseed {seed}")
        print_report(one)
    print(f"\nclaims over seeds {res['seeds']}: "
          f"{json.dumps(res['claims_over_seeds'])}")
    return res


if __name__ == "__main__":
    main()
