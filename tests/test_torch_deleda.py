"""The port's DELEDA against the JAX package's, end to end on the CPU.

The port replays the reference's random streams, takes the reference's
corpus arrays and starts from the reference's initial statistic, so it
reproduces the pinned fingerprints of ``tests/golden_deleda.json`` at
``tests/test_golden.py``'s own tolerances and a synchronous run of the
reference (the goldens are asynchronous only), in the dense layout and
in the unique-token layout (``sparse:…`` and ``eval:…:l2r:unique``). Gibbs draws may differ
only at ulp ties (``test_torch_estep.py``); none occurs at these seeds.
"""

import dataclasses
import json
import pathlib

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import deleda as ref_deleda  # noqa: E402
from repro.core import estep as ref_estep  # noqa: E402
from repro.core import evaluation as ref_eval  # noqa: E402
from repro.core import lda as ref_lda  # noqa: E402
from repro.core.graph import watts_strogatz_graph as ref_ws  # noqa: E402
from repro.data.lda_synthetic import CorpusSpec, make_corpus  # noqa: E402
from repro_torch.core import comm, deleda, estep, evaluation, lda  # noqa: E402
from repro_torch.core.graph import (complete_graph,  # noqa: E402
                                    watts_strogatz_graph)
from repro_torch.data.lda_synthetic import (  # noqa: E402
    CorpusSpec as PortCorpusSpec)
from repro_torch.kernels.gossip_mix import ops as mix_ops  # noqa: E402
from repro_torch.kernels.lda_gibbs import ops as gibbs_ops  # noqa: E402
from repro_torch.launch import deleda_experiment  # noqa: E402
from torch_parity import port_key, reference_mode, to_torch  # noqa: E402

GOLDEN = json.loads((pathlib.Path(__file__).parent
                     / "golden_deleda.json").read_text())
# tests/test_golden.py's run: CFG, N, T, the WS graph and the keys
KW = dict(n_topics=3, vocab_size=20, alpha=0.5, doc_len_max=8, n_gibbs=4,
          n_gibbs_burnin=2)
N, T = 8, 20


@pytest.fixture(scope="module")
def ref_inputs():
    """The reference's corpus and its initial statistic for key(1)."""
    with reference_mode():
        corpus = make_corpus(ref_lda.LDAConfig(**KW), jax.random.key(0),
                             CorpusSpec(n_nodes=N, docs_per_node=4,
                                        n_test=4))
        cfg = ref_deleda.DeledaConfig(lda=ref_lda.LDAConfig(**KW))
        stats0 = np.array(ref_deleda.init_state(cfg, jax.random.key(1),
                                                N).stats)
    return corpus, stats0


def _port_run(ref_inputs, kind, mode="async", eval_every=0, n_steps=T,
              layout="dense"):
    corpus, stats0 = ref_inputs
    cfg = deleda.DeledaConfig(lda=lda.LDAConfig(**KW), mode=mode,
                              batch_size=2, eval_every=eval_every,
                              corpus_layout=layout)
    g = watts_strogatz_graph(N, 4, 0.3, seed=0)
    sched, degs = deleda.make_run_inputs(g, n_steps, seed=0, kind=kind)
    spec = None
    if eval_every:
        spec = evaluation.EvalSpec(
            words=to_torch(corpus.test_words, torch.int64),
            mask=to_torch(corpus.test_mask), key=port_key(jax.random.key(7)),
            n_particles=4, probe_nodes=2, layout=layout)
    key = port_key(jax.random.key(1))
    init = dataclasses.replace(deleda.init_state(cfg, key, N),
                               stats=torch.from_numpy(stats0))
    return deleda.run_deleda(cfg, key, to_torch(corpus.words, torch.int64),
                             to_torch(corpus.mask), sched, degs, n_steps,
                             record_every=10, eval_spec=spec, init=init), cfg


def _fingerprint(trace):
    """tests/test_golden.py's fingerprint of a port trace."""
    stats = trace.stats.double().numpy()
    return {"mass": float(stats.sum()), "sumsq": float((stats ** 2).sum()),
            "probe": [float(v) for v in stats[::3, 1, ::7].reshape(-1)],
            "steps": [int(s) for s in trace.steps],
            "consensus_final": float(trace.consensus[-1])}


@pytest.mark.parametrize("kind,layout,golden", [
    ("edge", "dense", "edge:dense:dense"),
    ("matching", "dense", "matching:dense:dense"),
    ("matching", "unique", "sparse:matching:dense:dense")],
    ids=["edge", "matching", "sparse-matching"])
def test_trace_matches_golden(ref_inputs, kind, layout, golden):
    """Dense runs and the unique-token (count-weighted) run."""
    trace, _cfg = _port_run(ref_inputs, kind, layout=layout)
    got, want = _fingerprint(trace), GOLDEN[golden]
    assert got["steps"] == want["steps"]
    np.testing.assert_allclose(got["mass"], want["mass"], rtol=1e-4)
    np.testing.assert_allclose(got["sumsq"], want["sumsq"], rtol=1e-4)
    np.testing.assert_allclose(got["probe"], want["probe"], rtol=3e-3,
                               atol=1e-5)
    np.testing.assert_allclose(got["consensus_final"],
                               want["consensus_final"], rtol=1e-3,
                               atol=1e-5)


def _check_eval_golden(ref_inputs, layout, golden):
    trace, _cfg = _port_run(ref_inputs, "matching", eval_every=10,
                            layout=layout)
    want = GOLDEN[golden]
    assert list(trace.eval_lp.shape) == want["shape"]
    np.testing.assert_allclose(trace.eval_lp.double().numpy().reshape(-1),
                               want["eval_lp"], rtol=1e-5)
    # the in-loop evaluator leaves the training trajectory as it was
    plain, _ = _port_run(ref_inputs, "matching", layout=layout)
    assert torch.equal(trace.stats, plain.stats)


def test_eval_trace_matches_golden(ref_inputs):
    _check_eval_golden(ref_inputs, "dense", "eval:matching:dense:dense:vs1")


def test_unique_eval_trace_matches_golden(ref_inputs):
    """Unique-layout training with the count-weighted in-loop evaluator."""
    _check_eval_golden(ref_inputs, "unique",
                       "eval:matching:dense:dense:l2r:unique")


@pytest.fixture(scope="module", params=[("edge", "dense"),
                                        ("matching", "dense"),
                                        ("matching", "unique")],
                ids=["edge", "matching", "matching-unique"])
def sync_runs(request, ref_inputs):
    """(reference trace, port trace, graph, port config) of a sync run."""
    corpus, _stats0 = ref_inputs
    kind, layout = request.param
    with reference_mode():
        cfg = ref_deleda.DeledaConfig(lda=ref_lda.LDAConfig(**KW),
                                      mode="sync", batch_size=2,
                                      corpus_layout=layout)
        sched, degs = ref_deleda.make_run_inputs(ref_ws(N, 4, 0.3, seed=0),
                                                 T, seed=0, kind=kind)
        ref = ref_deleda.run_deleda(cfg, jax.random.key(1), corpus.words,
                                    corpus.mask, sched, degs, T,
                                    record_every=10)
        rep = ref_deleda.consensus_report(ref, ref_ws(N, 4, 0.3, seed=0),
                                          cfg, T, 10)
    port, pcfg = _port_run(ref_inputs, kind, mode="sync", layout=layout)
    return ref, rep, port, pcfg


def test_sync_run_matches_reference(sync_runs):
    ref, _rep, port, _cfg = sync_runs
    assert port.steps.tolist() == np.asarray(ref.steps).tolist() == [T] * N
    np.testing.assert_allclose(port.history.numpy(), np.asarray(ref.history),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(port.consensus.numpy(),
                               np.asarray(ref.consensus), rtol=1e-5)


def test_consensus_report_matches_reference(sync_runs):
    _ref, rep, port, cfg = sync_runs
    got = deleda.consensus_report(port, watts_strogatz_graph(N, 4, 0.3, 0),
                                  cfg, T, 10)
    assert got["lambda2"] == rep["lambda2"]
    assert got["spectral_gap"] == rep["spectral_gap"]
    assert got["within_envelope_frac"] == rep["within_envelope_frac"]
    np.testing.assert_allclose(got["measured"], rep["measured"], rtol=1e-5)
    np.testing.assert_allclose(got["envelope"], rep["envelope"], rtol=1e-5)


def _batch_inputs(seed, a=3, b=4, l=8, k=5, v=30):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, v, (a, b, l)).astype(np.int32)
    mask = np.arange(l)[None, None, :] < rng.integers(1, l + 1, (a, b, 1))
    stats = rng.random((a, k, v), dtype=np.float32)
    return words, mask, stats


@pytest.mark.parametrize("seed", [0, 1])
def test_estep_batch_matches_reference(seed):
    words, mask, stats = _batch_inputs(seed)
    a, _b, _l = words.shape
    k, v = stats.shape[1:]
    kw = dict(n_topics=k, vocab_size=v, n_gibbs=6, n_gibbs_burnin=3)
    with reference_mode():
        keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed),
                                                     i))(jnp.arange(a))
        backend, rcfg = ref_estep.get_estep("dense"), ref_lda.LDAConfig(**kw)
        want = ref_estep.estep_batch_from_stats(
            backend, rcfg, keys, jnp.asarray(words), jnp.asarray(mask),
            jnp.asarray(stats))
        want_beta = ref_estep.estep_batch(
            backend, rcfg, keys, jnp.asarray(words), jnp.asarray(mask),
            jax.vmap(lambda s: ref_lda.eta_star(s, rcfg.tau))(
                jnp.asarray(stats)))
        pkeys = torch.from_numpy(
            np.asarray(jax.random.key_data(keys)).astype(np.int64))
    cfg = lda.LDAConfig(**kw)
    args = (pkeys, torch.from_numpy(words).long(), torch.from_numpy(mask))
    got = estep.estep_batch_from_stats(cfg, *args, torch.from_numpy(stats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    got_beta = estep.estep_batch(cfg, *args,
                                 lda.eta_star(torch.from_numpy(stats)))
    np.testing.assert_allclose(got_beta.numpy(), np.asarray(want_beta),
                               rtol=1e-5, atol=1e-6)
    # fusing the nodes into one sweep call changes no bits
    for i in range(a):
        one = estep.estep_batch_from_stats(
            cfg, pkeys[i:i + 1], args[1][i:i + 1], args[2][i:i + 1],
            torch.from_numpy(stats[i:i + 1]))
        assert torch.equal(one[0], got[i])


def test_heldout_lp_matches_reference(ref_inputs):
    corpus, stats0 = ref_inputs
    tw, tm = np.asarray(corpus.test_words), np.asarray(corpus.test_mask)
    with reference_mode():
        key = jax.random.key(7)
        want = [float(ref_eval.heldout_lp_from_stats(
            key, jnp.asarray(tw), jnp.asarray(tm), jnp.asarray(s), 1e-2, 0.5,
            4)) for s in stats0[:3]]
        beta = ref_lda.eta_star(jnp.asarray(stats0[0]))
        want_lp = float(ref_eval.log_perplexity(key, jnp.asarray(tw),
                                                jnp.asarray(tm), beta, 0.5,
                                                4))
        want_st = float(ref_eval.log_perplexity_from_stats(
            key, jnp.asarray(tw), jnp.asarray(tm), jnp.asarray(stats0[1]),
            tau=1e-2, alpha=0.5, n_particles=4, chunk_docs=3))
    pkey, w, m = port_key(key), torch.from_numpy(tw).long(), \
        torch.from_numpy(tm)
    s = torch.from_numpy(stats0)
    before = evaluation.heldout_lp_from_stats(pkey, w, m, s[:3], 1e-2, 0.5, 4)
    np.testing.assert_allclose(before.numpy(), want, rtol=1e-5)
    one = evaluation.heldout_lp_from_stats(pkey, w, m, s[1], 1e-2, 0.5, 4)
    assert one.dim() == 0 and float(one) == float(before[1])
    np.testing.assert_allclose(
        float(evaluation.log_perplexity(pkey, w, m, lda.eta_star(s[0]), 0.5,
                                        4)), want_lp, rtol=1e-5)
    np.testing.assert_allclose(
        float(evaluation.log_perplexity_from_stats(
            pkey, w, m, s[1], tau=1e-2, alpha=0.5, n_particles=4,
            chunk_docs=3)), want_st, rtol=1e-5)
    assert evaluation.relative_perplexity_error(3.0, 2.0) == \
        float(ref_eval.relative_perplexity_error(3.0, 2.0)) == 0.5


def test_init_state_within_one_ulp_of_reference(ref_inputs):
    _corpus, stats0 = ref_inputs
    cfg = deleda.DeledaConfig(lda=lda.LDAConfig(**KW))
    st = deleda.init_state(cfg, port_key(jax.random.key(1)), N)
    np.testing.assert_allclose(st.stats.numpy(), stats0, rtol=3e-7, atol=0)
    with reference_mode():
        k_run = jax.random.split(jax.random.key(1))[1]
    assert st.key.tolist() == port_key(k_run).tolist()
    assert st.steps.dtype == torch.int32 and st.t == 0


def test_segments_equal_one_run(ref_inputs):
    """Two train_steps segments give the bits of one (absolute-step keys)."""
    corpus, stats0 = ref_inputs
    cfg = deleda.DeledaConfig(lda=lda.LDAConfig(**KW), mode="async",
                              batch_size=2)
    sched, degs = deleda.make_run_inputs(complete_graph(N), T, seed=3,
                                         kind="matching")
    words = to_torch(corpus.words, torch.int64)
    mask = to_torch(corpus.mask)
    corr = torch.ones((T, N))
    state = dataclasses.replace(
        deleda.init_state(cfg, port_key(jax.random.key(1)), N),
        stats=torch.from_numpy(stats0))
    first = comm.GossipSchedule(sched.kind, sched.data[:10], N)
    second = comm.GossipSchedule(sched.kind, sched.data[10:], N)
    whole, tw = deleda.train_steps(cfg, state, words, mask, sched, corr,
                                   record_every=5)
    half, t1 = deleda.train_steps(cfg, state, words, mask, first,
                                  corr[:10], record_every=5)
    half, t2 = deleda.train_steps(cfg, half, words, mask, second,
                                  corr[10:], record_every=5)
    assert torch.equal(whole.stats, half.stats)
    assert torch.equal(whole.steps, half.steps)
    assert whole.t == half.t == T and half.stats_version == T
    assert torch.equal(tw.history, torch.cat([t1.history, t2.history]))
    assert torch.equal(state.stats, torch.from_numpy(stats0))  # not mutated


def test_dead_edge_event_changes_nothing(ref_inputs):
    """The (i, i) sentinel neither mixes nor wakes a node (async edge)."""
    corpus, stats0 = ref_inputs
    cfg = deleda.DeledaConfig(lda=lda.LDAConfig(**KW), batch_size=2)
    state = dataclasses.replace(
        deleda.init_state(cfg, port_key(jax.random.key(1)), N),
        stats=torch.from_numpy(stats0))
    sched = comm.GossipSchedule(comm.EDGE, np.array([[3, 3], [1, 5]]), N)
    g0 = gibbs_ops.launches
    out, trace = deleda.train_steps(cfg, state, to_torch(corpus.words,
                                                         torch.int64),
                                    to_torch(corpus.mask), sched,
                                    torch.ones((2, N)), record_every=1)
    assert torch.equal(trace.history[0], state.stats)
    assert out.steps.tolist() == [0, 1, 0, 0, 0, 1, 0, 0]
    assert gibbs_ops.launches == g0   # the CPU runs the plain version


def test_experiment_cli_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        deleda_experiment.main(["--scale", "reduced"])


def test_experiment_runs_on_cpu(capsys):
    """The §4 driver end to end on the plain path at a toy scale."""
    scale = deleda_experiment.ExperimentScale(
        lda=lda.LDAConfig(n_topics=3, vocab_size=24, alpha=0.5,
                          doc_len_max=10, n_gibbs=4, n_gibbs_burnin=2),
        corpus=PortCorpusSpec(n_nodes=6, docs_per_node=4, n_test=6),
        n_steps=12, record_every=6, batch_size=2, ws_k=2, n_particles=3,
        probe_nodes=2)
    m0 = mix_ops.launches
    res = deleda_experiment.run_experiment(scale, seed=1, device="cpu",
                                           verbose=False)
    assert mix_ops.launches == m0
    assert set(res["runs"]) == {"goem", "async_complete", "sync_complete",
                                "async_watts_strogatz",
                                "sync_watts_strogatz"}
    assert res["iterations"] == [6, 12]
    for run in res["runs"].values():
        assert len(run["rel_perplexity"]) == len(run["beta_distance"]) == 2
        assert np.all(np.isfinite(run["rel_perplexity"]))
        assert run["rounds_per_s"] > 0
    res["claims"] = deleda_experiment.claims(res)
    assert set(res["claims"]["C1"]) == set(res["runs"]) - {"goem"}
    assert set(res["claims"]["C3_sync_minus_async"]) == {
        "complete", "watts_strogatz"}
    deleda_experiment.print_report(res)
    out = capsys.readouterr().out
    assert "Fig. 1a" in out and "Fig. 1b" in out and "within_env" in out
    assert deleda_experiment.PAPER.corpus.n_nodes == 50
    assert deleda_experiment.PAPER.lda.vocab_size == 100
