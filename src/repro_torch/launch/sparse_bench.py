"""The unique-token (CSR) layout against the dense one, end to end.

The torch counterpart of ``benchmarks/sparse_bench.py``. On a
Zipf-shaped corpus a document of L positions holds far fewer distinct
words; the dense E-step draws once per position (the ``lda_gibbs``
kernel), the unique layout once per distinct word with its count as
weight (the ``lda_sparse`` kernel). Each regime (Zipf(2.2) word envelope,
lognormal(4.4, 0.4) lengths) generates a small pool of documents and
tiles it to an ``[n, b, L]`` minibatch fan, then:

* :func:`bench_estep_layouts` times the fused dense and unique E-steps on
  the same fan (``estep_batch_from_stats`` against
  ``estep_batch_from_stats_unique``), and their sweep stages alone, and
  asserts that both scatter the same word-marginal mass;
* :func:`check_stats_path_bitwise` (paper regime) asserts that the
  segmented scatter gives the dense scatter's bits for equal mass;
* :func:`check_trajectory_agreement` (paper regime) runs ``run_deleda``
  in both layouts from four run keys each and asserts that their mean
  recoveries of beta* agree within three standard errors (the
  reference's two-seed band fails on the reference itself; see there)
  and that the token mass agrees within 1e-4.

The JAX benchmark gates the unique layout at >= 3x the dense tokens/s
where mean L / mean unique >= 4; that is a figure of the JAX package on
its device. Here each row reports ``speedup``, ``sweeps_speedup``, the
``gate`` it applies to and ``gate_met``, and nothing raises on speed.

  PYTHONPATH=src python -m repro_torch.launch.sparse_bench
  PYTHONPATH=src python -m repro_torch.launch.sparse_bench \\
      --regimes toy --device cpu

Runs on the GPU (the ``lda_gibbs`` and ``lda_sparse`` kernels, and
``gossip_mix`` in the trajectory check); ``--device cpu`` runs the plain
torch path, at the toy regime in seconds.
"""

from __future__ import annotations

import argparse
import json
import time
import warnings

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import deleda
from repro_torch.core import estep as estep_mod
from repro_torch.core import threefry as tf3
from repro_torch.core.graph import watts_strogatz_graph
from repro_torch.core.lda import LDAConfig, beta_distance, eta_star, \
    init_stats
from repro_torch.data.lda_synthetic import CorpusSpec, make_corpus

__all__ = ["ZIPF", "REGIMES", "TOY", "MIN_SPEEDUP", "MIN_RATIO",
           "TRAJ_SEEDS",
           "regime_config", "regime_corpus", "tiled_batch",
           "bench_estep_layouts", "check_stats_path_bitwise",
           "check_trajectory_agreement", "trajectory_schedule", "main"]

# the Zipf-shaped corpus: power-law word envelope and lognormal lengths
# (mean length about 90 tokens, almost no clipping at doc_len_max=256)
ZIPF = dict(zipf_exponent=2.2, doc_len_lognormal=(4.4, 0.4))

# the reference's regimes; gate="full" reads the whole E-step call,
# gate="sweeps" the sweep stage alone (at V >= 50k the [K, V] scatter
# weighs on both layouts alike)
REGIMES = {
    "paper": dict(n=50, v=1000, k=5, b=8, l=256, n_gibbs=8, burnin=4,
                  gen_docs=64, iters=3, steps=8, gate="full"),
    "mid": dict(n=512, v=10_000, k=5, b=4, l=256, n_gibbs=6, burnin=3,
                gen_docs=64, iters=2, steps=0, gate="full"),
    "big": dict(n=1024, v=50_000, k=4, b=2, l=128, n_gibbs=4, burnin=2,
                gen_docs=32, iters=2, steps=0, gate="sweeps"),
}
# seconds on the CPU's plain path; every check of "paper" runs (at 8
# rounds on 8 nodes, so that the recoveries carry some signal)
TOY = dict(n=8, v=60, k=3, b=2, l=256, n_gibbs=4, burnin=2, gen_docs=16,
           iters=1, steps=8, gate="full")

MIN_SPEEDUP = 3.0       # the JAX bench's acceptance: unique >= 3x dense
MIN_RATIO = 4.0         # tokens/s wherever mean L / mean unique >= 4
TRAJ_SEEDS = 4          # run keys per layout in the trajectory check


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timeit(fn, dev, iters):
    """Best wall seconds of ``iters`` calls after one warm-up, and the
    last output; the card is drained around each call."""
    out = fn()
    best = float("inf")
    for _ in range(iters):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)   # lint: allow(timer-no-barrier)
    return best, out


def regime_config(rg: dict) -> LDAConfig:
    return LDAConfig(n_topics=rg["k"], vocab_size=rg["v"], alpha=0.5,
                     doc_len_max=rg["l"], n_gibbs=rg["n_gibbs"],
                     n_gibbs_burnin=rg["burnin"])


def regime_corpus(cfg: LDAConfig, rg: dict, dev: torch.device):
    """The regime's pool of ``gen_docs`` Zipf documents, on ``dev``."""
    pool_nodes = max(rg["gen_docs"] // 4, 1)
    return make_corpus(cfg, tf3.key(1, dev),
                       CorpusSpec(n_nodes=pool_nodes, docs_per_node=4,
                                  n_test=4, **ZIPF))


def tiled_batch(corpus, n: int, b: int):
    """The pool tiled to an ``[n, b, L]`` fan (words, mask)."""
    flat_w, flat_m = corpus.flat_words, corpus.flat_mask
    reps = -(-(n * b) // flat_w.shape[0])
    words = flat_w.repeat(reps, 1)[:n * b].reshape(n, b, -1)
    mask = flat_m.repeat(reps, 1)[:n * b].reshape(n, b, -1)
    return words, mask


def bench_estep_layouts(cfg: LDAConfig, rg: dict, corpus,
                        dev: torch.device) -> dict:
    """Dense against unique fused E-steps over one Zipf minibatch fan."""
    n, b = rg["n"], rg["b"]
    words, mask = tiled_batch(corpus, n, b)
    l = words.shape[-1]
    uw, counts = estep_mod.unique_view(words.reshape(-1, l),
                                       mask.reshape(-1, l))
    u_dim = uw.shape[-1]
    uw, counts = uw.reshape(n, b, u_dim), counts.reshape(n, b, u_dim)
    keys = tf3.fold_in_data(tf3.key(0, dev), torch.arange(n, device=dev))
    stats = init_stats(cfg, tf3.split(tf3.key(3, dev), n))

    t_d, out_d = _timeit(lambda: estep_mod.estep_batch_from_stats(
        cfg, keys, words, mask, stats), dev, rg["iters"])
    t_u, out_u = _timeit(lambda: estep_mod.estep_batch_from_stats_unique(
        cfg, keys, uw, counts, stats), dev, rg["iters"])
    # the per-word token mass (the sum over topics) does not depend on
    # the sampler: both layouts scatter the same word histogram
    marg_err = float((out_d.sum(1) - out_u.sum(1)).abs().max())
    assert marg_err < 1e-4, f"word-marginal mass diverged: {marg_err}"
    del out_d, out_u

    # the sweep stage alone, rows gathered up front
    bw_d = estep_mod.beta_w_from_stats_batch(stats, words, cfg.tau)
    bw_u = estep_mod.beta_w_from_stats_batch(stats, uw, cfg.tau)
    maskf, countf = mask.to(stats.dtype), counts.to(stats.dtype)
    t_sd, _ = _timeit(lambda: estep_mod.fused_sweeps(cfg, keys, bw_d,
                                                     maskf), dev,
                      rg["iters"])
    t_su, _ = _timeit(lambda: estep_mod.fused_sweeps_sparse(
        cfg, keys, bw_u, countf), dev, rg["iters"])

    tokens = float(mask.sum())
    mean_len = float(mask.sum(-1).double().mean())
    mean_uniq = float((counts > 0).sum(-1).double().mean())
    return dict(tokens=tokens, u_dim=u_dim, mean_len=mean_len,
                mean_unique=mean_uniq, unique_ratio=mean_len / mean_uniq,
                dense_s=t_d, unique_s=t_u, tokens_per_s_dense=tokens / t_d,
                tokens_per_s_unique=tokens / t_u, speedup=t_d / t_u,
                sweeps_dense_s=t_sd, sweeps_unique_s=t_su,
                sweeps_speedup=t_sd / t_su, word_marginal_err=marg_err)


def check_stats_path_bitwise(cfg: LDAConfig, corpus,
                             dev: torch.device) -> None:
    """Each slot's row at its word's first position, zeros at repeats:
    the segmented scatter must give the dense scatter's bits."""
    words, mask = corpus.flat_words[:64], corpus.flat_mask[:64]
    uw, counts = estep_mod.unique_view(words, mask)
    b, u_dim = uw.shape
    gen = torch.Generator(device=dev).manual_seed(5)
    per_unique = torch.rand((b, u_dim, cfg.n_topics), generator=gen,
                            device=dev) * (counts > 0)[..., None]
    w_h, m_h, uw_h = (words.cpu().numpy(), mask.cpu().numpy(),
                      uw.cpu().numpy())
    eq = (w_h[:, None, :] == uw_h[:, :, None]) & m_h[:, None, :]
    first = eq.argmax(-1)                                    # [B, U]
    bi, ui = np.nonzero(counts.cpu().numpy() > 0)
    per_pos = torch.zeros((b, words.shape[1], cfg.n_topics), device=dev)
    per_pos[torch.as_tensor(bi, device=dev),
            torch.as_tensor(first[bi, ui], device=dev)] = per_unique[
        torch.as_tensor(bi, device=dev), torch.as_tensor(ui, device=dev)]
    s_u = estep_mod.stats_from_unique(uw, per_unique, cfg.vocab_size,
                                      counts.float())
    s_d = estep_mod.stats_from_per_pos(words, per_pos, cfg.vocab_size,
                                       mask.float())
    if not torch.equal(s_u, s_d):
        raise AssertionError("stats_from_unique != stats_from_per_pos")


def trajectory_schedule(rg: dict):
    """The matching schedule and degrees of the trajectory check."""
    g = watts_strogatz_graph(rg["n"], 4, 0.3, seed=0)
    return deleda.make_run_inputs(g, rg["steps"], seed=0, kind="matching")


def check_trajectory_agreement(cfg: LDAConfig, rg: dict, corpus,
                               u_dim: int, dev: torch.device) -> dict:
    """``run_deleda`` in the dense and the unique layouts.

    The count-weighted chain is another valid sampler, so the statistics
    are compared by what they recover and by their mass. Each layout runs
    from ``TRAJ_SEEDS`` run keys; the mean beta distances to beta* must
    agree within three standard errors of their difference (or 15% of
    the dense mean, or 0.01, whichever is larger), and every unique run
    must carry its dense twin's token mass within 1e-4.

    The reference compares one unique run with one dense run in a band of
    three times two dense runs' spread. After 8 rounds a run's distance
    moves from key to key by more than that spread shows, so that gate
    rejects correct runs, the reference's own included: on the
    reference's corpus and streams the port reproduces the reference's
    distances, and the reference's gate rejects them
    (``tests/test_torch_sparse.py``).
    """
    n, steps = rg["n"], rg["steps"]
    words, mask = tiled_batch(corpus, n, 8)
    sched, degs = trajectory_schedule(rg)

    def final_stats(layout, seed):
        dcfg = deleda.DeledaConfig(
            lda=cfg, mode="sync", batch_size=4, corpus_layout=layout,
            max_unique=u_dim if layout == "unique" else 0)
        tr = deleda.run_deleda(dcfg, tf3.key(seed, dev), words, mask,
                               sched, degs, steps, record_every=steps)
        return tr.stats.double()                          # [n, K, V]

    def recovery(stats):
        beta = eta_star(stats.mean(0).float(), cfg.tau)
        return float(beta_distance(beta, corpus.beta_star))

    dist = {"dense": [], "unique": []}
    mass_rel = 0.0
    for seed in range(TRAJ_SEEDS):
        d, u = final_stats("dense", seed), final_stats("unique", seed)
        mass_rel = max(mass_rel, abs(float(u.sum()) - float(d.sum()))
                       / abs(float(d.sum())))
        dist["dense"].append(recovery(d))
        dist["unique"].append(recovery(u))
    assert mass_rel < 1e-4, f"layout mass drift: {mass_rel:.2e}"
    bd_d, bd_u = (float(np.mean(dist[k])) for k in ("dense", "unique"))
    se = float(np.sqrt((np.var(dist["dense"], ddof=1)
                        + np.var(dist["unique"], ddof=1)) / TRAJ_SEEDS))
    band = max(3.0 * se, 0.15 * bd_d, 0.01)
    assert abs(bd_u - bd_d) <= band, (
        f"the layouts recover beta* differently: mean beta distance "
        f"unique {bd_u:.4f} vs dense {bd_d:.4f} (band {band:.4f}, runs "
        f"{dist})")
    return dict(traj_beta_dist_dense=bd_d, traj_beta_dist_unique=bd_u,
                traj_beta_dist_dense_seeds=dist["dense"],
                traj_beta_dist_unique_seeds=dist["unique"],
                traj_gate_band=band, traj_mass_rel_err=mass_rel)


def run_regime(name: str, rg: dict, dev: torch.device) -> dict:
    """One regime's row: E-step layouts, and the checks where asked."""
    cfg = regime_config(rg)
    print(f"--- {name}: n={rg['n']} V={rg['v']} K={rg['k']} L={rg['l']} "
          f"(Zipf {ZIPF['zipf_exponent']}, pool {rg['gen_docs']} docs "
          f"tiled to {rg['n'] * rg['b']}) on {dev}", flush=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the row records the clipping
        corpus = regime_corpus(cfg, rg, dev)
    ep = bench_estep_layouts(cfg, rg, corpus, dev)
    gated = ep["speedup"] if rg["gate"] == "full" else ep["sweeps_speedup"]
    gate_met = (bool(gated >= MIN_SPEEDUP)
                if ep["unique_ratio"] >= MIN_RATIO else None)
    print(f"    mean len {ep['mean_len']:.1f}  mean unique "
          f"{ep['mean_unique']:.1f}  ratio {ep['unique_ratio']:.2f}  (U="
          f"{ep['u_dim']}, trunc {corpus.length_truncation_frac:.3f})")
    print(f"    estep  dense {ep['dense_s'] * 1e3:.3f} ms  unique "
          f"{ep['unique_s'] * 1e3:.3f} ms  speedup {ep['speedup']:.3f}x")
    print(f"    sweeps dense {ep['sweeps_dense_s'] * 1e3:.3f} ms  unique "
          f"{ep['sweeps_unique_s'] * 1e3:.3f} ms  speedup "
          f"{ep['sweeps_speedup']:.3f}x  (the JAX bench's {MIN_SPEEDUP}x "
          f"on {rg['gate']}: {gate_met})", flush=True)
    row = dict(regime=name, n=rg["n"], v=rg["v"], k=rg["k"], l=rg["l"],
               n_gibbs=rg["n_gibbs"], doc_pool=rg["gen_docs"],
               docs_tiled_to=rg["n"] * rg["b"],
               zipf_exponent=ZIPF["zipf_exponent"],
               length_truncation_frac=corpus.length_truncation_frac,
               gate=rg["gate"], gate_met=gate_met,
               device=(torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"), **ep)
    if rg["steps"]:
        check_stats_path_bitwise(cfg, corpus, dev)
        print("    stats path: segmented scatter == dense scatter, bitwise")
        row.update(check_trajectory_agreement(cfg, rg, corpus, ep["u_dim"],
                                              dev))
        print(f"    run_deleda: mean beta distance unique "
              f"{row['traj_beta_dist_unique']:.4f} vs dense "
              f"{row['traj_beta_dist_dense']:.4f} over {TRAJ_SEEDS} keys "
              f"(band {row['traj_gate_band']:.4f}), mass rel "
              f"{row['traj_mass_rel_err']:.2e}", flush=True)
    return row


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--regimes", nargs="*", default=list(REGIMES),
                    choices=[*REGIMES, "toy"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain torch path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = [run_regime(name, TOY if name == "toy" else REGIMES[name], dev)
            for name in args.regimes]
    print(json.dumps({"sparse_bench": rows}))
    return rows


if __name__ == "__main__":
    main()
