"""The scenario sweep held at the North star's level 3, on the CPU.

Two runs of ``run_scenario_experiment`` per seed, regime by regime:

* the reference's (``benchmarks/_deleda_experiment.py``), inside
  :func:`torch_parity.reference_mode`, on its own corpus;
* the port's (``repro_torch.launch.deleda_experiment``, ``device="cpu"``)
  on the reference's corpus arrays: the same seed, scenario, keys and
  evaluator as the port's own run, only the corpus drawn by the
  reference. Where the port's own sweep (on the card, PERF.md §6) misses
  the reference's range, this run says whether the trajectory or the
  corpus draw moves it.

``tests/test_torch_scenario.py`` holds both at ``SCENARIO_SMOKE``; the
paper scale takes a few minutes a seed on one CPU:

  PYTHONPATH=src:tests:. JAX_PLATFORMS=cpu python tests/torch_level3.py \\
      --scale scenario_paper --seeds 0 1 2
"""

from __future__ import annotations

import argparse
import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from benchmarks import _deleda_experiment as ref_exp
from repro.core import lda as ref_lda
from repro.data import lda_synthetic as ref_synth
from repro_torch.data.lda_synthetic import SyntheticCorpus
from repro_torch.launch import deleda_experiment as dexp
from torch_parity import reference_mode

METRICS = ("rel_perplexity", "beta_distance", "lp_ratio_vs_static")


def reference_sweep(scale_name: str, seed: int, names=None) -> dict:
    """The reference's ``run_scenario_experiment`` for one seed."""
    kw = {} if names is None else {"scenario_names": names}
    with reference_mode():
        return ref_exp.run_scenario_experiment(
            ref_exp.get_scale(scale_name), seed=seed, verbose=False, **kw)


def _reference_corpus(config, key: torch.Tensor, spec) -> SyntheticCorpus:
    """The reference's corpus for the port's (config, key, spec), as the
    port's ``SyntheticCorpus`` on the CPU (the key words are jax's)."""
    fields = ("n_topics", "vocab_size", "alpha", "doc_len_max", "n_gibbs",
              "n_gibbs_burnin")
    ref_cfg = ref_lda.LDAConfig(**{f: getattr(config, f) for f in fields})
    ref_spec = ref_synth.CorpusSpec(
        n_nodes=spec.n_nodes, docs_per_node=spec.docs_per_node,
        n_test=spec.n_test, topic_skew=spec.topic_skew)
    jkey = jax.random.wrap_key_data(
        jnp.asarray(key.cpu().numpy().astype(np.uint32)))
    with reference_mode():
        rc = ref_synth.make_corpus(ref_cfg, jkey, ref_spec)

    def t(x, dtype=None):
        out = torch.from_numpy(np.array(x))
        return out if dtype is None else out.to(dtype)

    return SyntheticCorpus(
        words=t(rc.words, torch.int64), mask=t(rc.mask),
        test_words=t(rc.test_words, torch.int64), test_mask=t(rc.test_mask),
        beta_star=t(rc.beta_star), alpha_star=config.alpha,
        length_truncation_frac=float(rc.length_truncation_frac))


@contextlib.contextmanager
def reference_corpora():
    """Within: the port's experiment draws the reference's corpora."""
    real = dexp.make_corpus
    dexp.make_corpus = _reference_corpus
    try:
        yield
    finally:
        dexp.make_corpus = real


def port_sweep_on_reference_corpus(scale_name: str, seed: int,
                                   names=None) -> dict:
    """The port's ``run_scenario_experiment`` for one seed on the CPU, on
    the reference's corpus."""
    kw = {} if names is None else {"scenario_names": names}
    with reference_corpora():
        return dexp.run_scenario_experiment(
            dexp.get_scale(scale_name), seed=seed, device="cpu",
            verbose=False, **kw)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", default="scenario_smoke",
                    choices=["scenario_smoke", "scenario_paper"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = ap.parse_args(argv)
    out = {}
    for seed in args.seeds:
        ref = reference_sweep(args.scale, seed)
        port = port_sweep_on_reference_corpus(args.scale, seed)
        out[seed] = {"lp_star": [ref["lp_star"], port["lp_star"]],
                     "runs": {name: {m: [ref["runs"][name][m],
                                         port["runs"][name][m]]
                                     for m in METRICS}
                              for name in ref["runs"]}}
        for name, run in out[seed]["runs"].items():
            print(f"seed {seed} {name:>9s} (reference, port on its "
                  f"corpus): " + "  ".join(
                      f"{m} {a:+.5f} {b:+.5f}" for m, (a, b) in run.items()),
                  flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
