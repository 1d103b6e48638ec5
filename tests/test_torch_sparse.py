"""The port's unique-token (CSR) layout against the JAX package's.

The counterpart of ``tests/test_sparse.py``: the (word_id, count) view,
the segmented scatter, the count-weighted sweeps, their fused multi-node
front end, the realistic-corpus options and ``launch/sparse_bench``. The
same numpy inputs go through the reference (inside ``reference_mode``)
and the port. Sweeps agree draw for draw (``m`` equal): the reference's
``jnp.cumsum`` and the port's sequential sums could part only at an ulp
tie, and none occurs at these seeds.
"""

import warnings

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import estep as ref_estep  # noqa: E402
from repro.core import lda as ref_lda  # noqa: E402
from repro_torch.core import deleda, estep, lda  # noqa: E402
from repro_torch.data.lda_synthetic import (  # noqa: E402
    LENGTH_TRUNCATION_WARN_FRAC, CorpusSpec, make_corpus)
from repro_torch.kernels.lda_sparse import ops as sparse_ops  # noqa: E402
from repro_torch.launch import sparse_bench  # noqa: E402
from torch_parity import reference_mode, to_torch  # noqa: E402

ALPHA = 0.5


def _dup_docs(seed, b=6, l=20, v=12):
    """Documents with many repeated words (a small vocabulary)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, v, (b, l)).astype(np.int32)
    lengths = rng.integers(1, l + 1, b)
    lengths[0] = l
    mask = np.arange(l)[None, :] < lengths[:, None]
    return np.where(mask, words, 0).astype(np.int32), mask


def _dup_free_docs(seed, b=6, l=12, v=60):
    """Sorted documents without repeats, padding at the tail."""
    rng = np.random.default_rng(seed)
    words = np.stack([np.sort(rng.choice(v, l, replace=False))
                      for _ in range(b)]).astype(np.int32)
    lengths = np.array([l, l - 3, l - 7, 1, l, l - 1])[:b]
    mask = np.arange(l)[None, :] < lengths[:, None]
    return np.where(mask, words, 0).astype(np.int32), mask


def _port_view(words, mask, max_unique=None, fn=estep.dense_to_unique):
    return fn(torch.from_numpy(words).long(), torch.from_numpy(mask),
              max_unique)


@pytest.mark.parametrize("max_unique", [None, 4, 20])
def test_dense_to_unique_matches_reference(max_unique):
    """Equal ids and counts, overflow past max_unique dropped alike."""
    words, mask = _dup_docs(0)
    with reference_mode():
        ru, rc = ref_estep.dense_to_unique(jnp.asarray(words),
                                           jnp.asarray(mask), max_unique)
    pu, pc = _port_view(words, mask, max_unique)
    assert pu.shape == pc.shape == ru.shape
    np.testing.assert_array_equal(pu.numpy(), np.asarray(ru))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
    if max_unique == 4:      # the first document has more distinct words
        assert int(pc.sum()) < int(mask.sum())


def test_unique_view_matches_reference_and_keeps_the_multiset():
    words, mask = _dup_docs(1, b=5, l=16, v=9)
    with reference_mode():
        ru, rc = ref_estep.unique_view(jnp.asarray(words), jnp.asarray(mask))
    pu, pc = _port_view(words, mask, fn=estep.unique_view)
    np.testing.assert_array_equal(pu.numpy(), np.asarray(ru))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
    assert pu.shape[1] == int((pc > 0).sum(-1).max())
    for d in range(words.shape[0]):
        dense = np.bincount(words[d][mask[d]], minlength=9)
        uniq = np.bincount(pu[d].numpy(), weights=pc[d].numpy(),
                           minlength=9)
        np.testing.assert_array_equal(dense, uniq)
    # ascending ids, padding only at the tail
    pos = (pc > 0).numpy()
    assert (pos == (pos[:, ::-1].cumsum(-1)[:, ::-1] > 0)).all()
    leading = (pc > 0).sum(-1)
    for d in range(words.shape[0]):
        ids = pu[d, :leading[d]].numpy()
        assert (np.diff(ids) > 0).all()
    # leading dims are kept
    u3, c3 = estep.dense_to_unique(torch.from_numpy(words).long()[None],
                                   torch.from_numpy(mask)[None])
    assert u3.shape == c3.shape == (1,) + words.shape


def _per_unique(seed, counts, k):
    rng = np.random.default_rng(seed)
    pu = rng.random(counts.shape + (k,), dtype=np.float32)
    return pu * (counts > 0)[..., None]


def test_stats_from_unique_equals_the_dense_scatter():
    """Each slot's row at its word's first position, zeros at repeats:
    both layouts scatter the same mass into the same bits."""
    words, mask = _dup_docs(3)
    b, l = words.shape
    uw, counts = _port_view(words, mask, fn=estep.unique_view)
    k, v = 4, 12
    per_unique = _per_unique(4, counts.numpy(), k)
    per_pos = np.zeros((b, l, k), np.float32)
    for d in range(b):
        for s in range(uw.shape[1]):
            if counts[d, s] == 0:
                continue
            first = int(np.argmax((words[d] == int(uw[d, s])) & mask[d]))
            per_pos[d, first] = per_unique[d, s]
    s_u = estep.stats_from_unique(uw, torch.from_numpy(per_unique), v,
                                  counts.float())
    s_d = estep.stats_from_per_pos(torch.from_numpy(words).long(),
                                   torch.from_numpy(per_pos), v,
                                   torch.from_numpy(mask).float())
    assert torch.equal(s_u, s_d)


def test_stats_from_unique_matches_reference():
    words, mask = _dup_docs(5)
    uw, counts = _port_view(words, mask, fn=estep.unique_view)
    per_unique = _per_unique(6, counts.numpy(), 4)
    with reference_mode():
        want = ref_estep.stats_from_unique(
            jnp.asarray(uw.numpy().astype(np.int32)),
            jnp.asarray(per_unique), 12,
            jnp.asarray(counts.numpy().astype(np.float32)))
    got = estep.stats_from_unique(uw, torch.from_numpy(per_unique), 12,
                                  counts.float())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def _sweep_inputs(seed, counts, k, s):
    rng = np.random.default_rng(seed)
    b, u = counts.shape
    beta_w = rng.random((b, u, k), dtype=np.float32) + np.float32(1e-3)
    uniforms = rng.random((s, b, u), dtype=np.float32)
    z0 = rng.integers(0, k, (b, u)).astype(np.int32)
    return beta_w, counts.astype(np.float32), uniforms, z0


@pytest.mark.parametrize("seed,k", [(0, 5), (1, 16), (2, 3)])
def test_gibbs_sweeps_sparse_match_reference(seed, k):
    """Counts in {0, 1, >1}: the same draws (m equal), per_unique and
    ndk_mean within rtol 1e-5."""
    words, mask = _dup_docs(10 + seed, b=8, l=24, v=10)
    _uw, counts = _port_view(words, mask, fn=estep.unique_view)
    counts = counts.numpy()
    assert {0, 1} <= set(np.unique(counts)) and counts.max() > 1
    s, burnin = 6, 3
    args = _sweep_inputs(seed, counts, k, s)
    kw = dict(alpha=ALPHA, n_sweeps=s, burnin=burnin)
    with reference_mode():
        want = ref_estep.gibbs_sweeps_sparse(*map(jnp.asarray, args), **kw)
    got = estep.gibbs_sweeps_sparse(*map(torch.from_numpy, args), **kw)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in (got[0], want[0]), (got[2], want[2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7)


def test_sparse_sweeps_equal_dense_sweeps_on_binary_counts():
    """Counts in {0, 1} on sorted documents: the sparse sweeps are the
    dense sweeps, bit for bit."""
    words, mask = _dup_free_docs(20)
    uw, counts = _port_view(words, mask)
    assert torch.equal(uw, torch.from_numpy(words).long())
    assert torch.equal(counts, torch.from_numpy(mask).long())
    k, s, burnin = 5, 6, 2
    bw, cf, u, z0 = map(torch.from_numpy,
                        _sweep_inputs(21, counts.numpy(), k, s))
    kw = dict(alpha=ALPHA, n_sweeps=s, burnin=burnin)
    per_pos, z, ndk = estep.gibbs_sweeps_dense(bw, cf, u, z0, **kw)
    per_unique, m, ndk_s = sparse_ops.sparse_sweeps(bw, cf, u, z0, **kw)
    assert torch.equal(per_unique, per_pos)
    assert torch.equal(ndk_s, ndk)
    onehot = torch.nn.functional.one_hot(z, k).float() * cf[..., None]
    assert torch.equal(m, onehot)


def test_sparse_ops_dispatches_cpu_to_plain():
    counts = np.array([[2, 1, 0], [3, 0, 0]])
    args = [torch.from_numpy(x) for x in _sweep_inputs(0, counts, 4, 3)]
    before = sparse_ops.launches
    got = sparse_ops.sparse_sweeps(*args, alpha=ALPHA, n_sweeps=3, burnin=1)
    assert sparse_ops.launches == before
    want = estep.gibbs_sweeps_sparse(*args, alpha=ALPHA, n_sweeps=3,
                                     burnin=1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got[1].sum(-1), args[1])     # m splits the counts
    with pytest.raises(ValueError, match="burnin"):
        sparse_ops.sparse_sweeps(*args, alpha=ALPHA, n_sweeps=3, burnin=3)


def test_sparse_estep_matches_reference():
    """The front end: stats, splits, n_dk and theta."""
    words, mask = _dup_docs(30, b=5, l=16, v=15)
    kw = dict(n_topics=4, vocab_size=15, n_gibbs=5, n_gibbs_burnin=2)
    rng = np.random.default_rng(31)
    beta = rng.random((4, 15), dtype=np.float32)
    beta /= beta.sum(-1, keepdims=True)
    with reference_mode():
        uw, counts = ref_estep.unique_view(jnp.asarray(words),
                                           jnp.asarray(mask))
        key = jax.random.key(32)
        want = ref_estep.get_sparse_estep("dense")(
            ref_lda.LDAConfig(**kw), key, uw, counts, jnp.asarray(beta))
        pkey = torch.from_numpy(
            np.asarray(jax.random.key_data(key)).astype(np.int64))
    got = estep.SparseEStep()(
        lda.LDAConfig(**kw), pkey, to_torch(uw, torch.int64),
        to_torch(counts, torch.int64), torch.from_numpy(beta))
    np.testing.assert_array_equal(got.m.numpy(), np.asarray(want.m))
    np.testing.assert_array_equal(got.n_dk.numpy(), np.asarray(want.n_dk))
    np.testing.assert_allclose(got.stats.numpy(), np.asarray(want.stats),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta),
                               rtol=1e-5)


def _batch_unique(seed, a=3, b=4, l=8, k=5, v=9):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, v, (a, b, l)).astype(np.int32)
    mask = np.arange(l)[None, None, :] < rng.integers(1, l + 1, (a, b, 1))
    stats = rng.random((a, k, v), dtype=np.float32)
    return words, mask, stats


@pytest.mark.parametrize("seed", [0, 1])
def test_estep_batch_from_stats_unique_matches_reference(seed):
    words, mask, stats = _batch_unique(seed)
    a = words.shape[0]
    k, v = stats.shape[1:]
    kw = dict(n_topics=k, vocab_size=v, n_gibbs=6, n_gibbs_burnin=3)
    with reference_mode():
        uw, counts = ref_estep.dense_to_unique(jnp.asarray(words),
                                               jnp.asarray(mask))
        keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed),
                                                     i))(jnp.arange(a))
        want = ref_estep.estep_batch_from_stats_unique(
            ref_estep.get_sparse_estep("dense"), ref_lda.LDAConfig(**kw),
            keys, uw, counts, jnp.asarray(stats))
        pkeys = torch.from_numpy(
            np.asarray(jax.random.key_data(keys)).astype(np.int64))
    cfg = lda.LDAConfig(**kw)
    puw, pc = to_torch(uw, torch.int64), to_torch(counts, torch.int64)
    got = estep.estep_batch_from_stats_unique(cfg, pkeys, puw, pc,
                                              torch.from_numpy(stats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # fusing the nodes into one sweep call changes no bits
    for i in range(a):
        one = estep.estep_batch_from_stats_unique(
            cfg, pkeys[i:i + 1], puw[i:i + 1], pc[i:i + 1],
            torch.from_numpy(stats[i:i + 1]))
        assert torch.equal(one[0], got[i])


def _top_frac(c, v):
    w = c.words[c.mask].numpy()
    hist = np.sort(np.bincount(w, minlength=v))
    return hist[-10:].sum() / hist.sum()


def test_zipf_exponent_skews_word_frequencies():
    """The reference test's own: ten words take more than twice the
    share, and a document holds far fewer distinct words than tokens."""
    cfg = lda.LDAConfig(n_topics=4, vocab_size=200, alpha=0.5,
                        doc_len_max=64, n_gibbs=2, n_gibbs_burnin=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        c0 = make_corpus(cfg, torch.tensor([0, 37]),
                         CorpusSpec(n_nodes=8, docs_per_node=8))
        c1 = make_corpus(cfg, torch.tensor([0, 37]),
                         CorpusSpec(n_nodes=8, docs_per_node=8,
                                    zipf_exponent=2.0))
    assert _top_frac(c1, 200) > 2.0 * _top_frac(c0, 200)
    _uw, counts = c1.unique_view()
    mean_len = float(c1.mask.sum(-1).float().mean())
    mean_uniq = float((counts > 0).sum(-1).float().mean())
    assert mean_len / mean_uniq > 1.5
    tu, tc = c1.test_unique_view()
    assert tu.shape[0] == c1.test_words.shape[0]
    assert torch.equal(tc.sum(-1), c1.test_mask.sum(-1))


def test_lognormal_lengths_and_truncation_warning():
    cfg = lda.LDAConfig(n_topics=3, vocab_size=50, alpha=0.5,
                        doc_len_max=16, n_gibbs=2, n_gibbs_burnin=1)
    spec = CorpusSpec(n_nodes=4, docs_per_node=8,
                      doc_len_lognormal=(5.0, 0.3))
    with pytest.warns(UserWarning, match="clipped"):
        c = make_corpus(cfg, torch.tensor([0, 38]), spec)
    assert c.length_truncation_frac > LENGTH_TRUNCATION_WARN_FRAC
    ok = CorpusSpec(n_nodes=4, docs_per_node=8,
                    doc_len_lognormal=(1.5, 0.3))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        c2 = make_corpus(cfg, torch.tensor([0, 38]), ok)
    assert c2.length_truncation_frac <= LENGTH_TRUNCATION_WARN_FRAC
    lens = c2.mask.sum(-1).float()
    assert 2 <= float(lens.min()) and float(lens.max()) <= 16
    # exp(1.5) ~ 4.5: the lognormal lengths, not Poisson(10)'s
    assert 3.0 < float(lens.mean()) < 7.0


def test_corpus_spec_validates_options():
    with pytest.raises(ValueError, match="zipf_exponent"):
        CorpusSpec(n_nodes=2, docs_per_node=2, zipf_exponent=-1.0)
    with pytest.raises(ValueError, match="doc_len_lognormal"):
        CorpusSpec(n_nodes=2, docs_per_node=2,
                   doc_len_lognormal=(1.0, 0.0))


def test_config_validates_corpus_layout():
    cfg = lda.LDAConfig(n_topics=4, vocab_size=60)
    with pytest.raises(ValueError, match="corpus_layout"):
        deleda.DeledaConfig(lda=cfg, corpus_layout="csr")
    with pytest.raises(ValueError, match="max_unique"):
        deleda.DeledaConfig(lda=cfg, corpus_layout="dense", max_unique=8)
    with pytest.raises(ValueError, match="max_unique"):
        deleda.DeledaConfig(lda=cfg, corpus_layout="unique", max_unique=-1)
    assert deleda.DeledaConfig(lda=cfg, corpus_layout="unique",
                               max_unique=8).max_unique == 8


def test_sparse_bench_runs_on_cpu_at_the_toy_regime(capsys):
    rows = sparse_bench.main(["--regimes", "toy", "--device", "cpu"])
    (row,) = rows
    assert row["regime"] == "toy" and row["device"] == "cpu"
    assert row["word_marginal_err"] < 1e-4
    assert row["traj_mass_rel_err"] < 1e-4
    assert row["u_dim"] < row["l"]
    for key in ("speedup", "sweeps_speedup", "gate", "gate_met"):
        assert key in row
    assert "toy" in capsys.readouterr().out


def test_sparse_bench_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sparse_bench.main(["--regimes", "toy"])


def test_trajectory_runs_match_reference_on_its_corpus():
    """``sparse_bench``'s paper-regime runs on the reference's corpus:
    the port reproduces the reference's beta distances in both layouts,
    and the reference's one-against-one gate (unique key 0 against dense
    key 0, in three times the spread of dense keys 0 and 1) rejects these
    correct runs, which is why the port's check compares means over
    ``TRAJ_SEEDS`` keys. The corpus and the fan are the reference
    bench's (``benchmarks/sparse_bench.py``)."""
    from repro.core import deleda as ref_deleda
    from repro.core.graph import watts_strogatz_graph
    from repro.core.lda import beta_distance, eta_star
    from repro.data import lda_synthetic as ref_data

    def tiled(c, n, b):
        reps = -(-(n * b) // (c.words.shape[0] * c.words.shape[1]))
        return tuple(jnp.tile(x.reshape(-1, x.shape[-1]), (reps, 1))[
            :n * b].reshape(n, b, -1) for x in (c.words, c.mask))

    rg = sparse_bench.REGIMES["paper"]
    rcfg = ref_lda.LDAConfig(n_topics=rg["k"], vocab_size=rg["v"],
                             alpha=0.5, doc_len_max=rg["l"],
                             n_gibbs=rg["n_gibbs"],
                             n_gibbs_burnin=rg["burnin"])
    runs = (("dense", 0), ("dense", 1), ("unique", 0))
    with reference_mode(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        corpus = ref_data.make_corpus(
            rcfg, jax.random.key(1),
            ref_data.CorpusSpec(n_nodes=16, docs_per_node=4, n_test=4,
                                **sparse_bench.ZIPF))
        fw, fm = tiled(corpus, rg["n"], rg["b"])
        u_dim = ref_estep.unique_view(fw.reshape(-1, rg["l"]),
                                      fm.reshape(-1, rg["l"]))[0].shape[-1]
        words, mask = tiled(corpus, rg["n"], 8)
        sched, degs = ref_deleda.make_run_inputs(
            watts_strogatz_graph(rg["n"], 4, 0.3, seed=0), rg["steps"],
            seed=0, kind="matching")
        want = []
        for layout, seed in runs:
            cfg = ref_deleda.DeledaConfig(
                lda=rcfg, mode="sync", batch_size=4, corpus_layout=layout,
                max_unique=u_dim if layout == "unique" else 0)
            st = ref_deleda.run_deleda(cfg, jax.random.key(seed), words,
                                       mask, sched, degs, rg["steps"],
                                       record_every=rg["steps"]).stats
            want.append(float(beta_distance(
                eta_star(jnp.asarray(np.asarray(st, np.float64).mean(0),
                                     jnp.float32), rcfg.tau),
                corpus.beta_star)))
    psched, pdegs = sparse_bench.trajectory_schedule(rg)
    np.testing.assert_array_equal(psched.data, np.asarray(sched))
    pcfg = sparse_bench.regime_config(rg)
    got = []
    for layout, seed in runs:
        cfg = deleda.DeledaConfig(
            lda=pcfg, mode="sync", batch_size=4, corpus_layout=layout,
            max_unique=u_dim if layout == "unique" else 0)
        st = deleda.run_deleda(cfg, torch.tensor([0, seed]),
                               to_torch(words, torch.int64), to_torch(mask),
                               psched, pdegs, rg["steps"],
                               record_every=rg["steps"]).stats
        got.append(float(lda.beta_distance(
            lda.eta_star(st.double().mean(0).float(), pcfg.tau),
            to_torch(corpus.beta_star))))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    d0, d1, u0 = want
    assert abs(u0 - d0) > max(3.0 * abs(d1 - d0), 0.15 * d0, 0.01)
