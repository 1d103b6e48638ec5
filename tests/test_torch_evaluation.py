"""The port's left-to-right evaluator against the JAX package's.

Same doc ids, keys and likelihood rows on both sides: per-document LLs
agree at rtol 1e-5 (the resample draws share one association with the
reference's ``sample_from_unnormalized_seq``; the z_n draw and the sums
may differ in the last ulp), in the dense layout and in the
count-weighted unique one. Within the port, every chunking of
``evaluate_heldout`` gives the same bits.
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import estep as ref_estep  # noqa: E402
from repro.core import evaluation as ref_eval  # noqa: E402
from repro.core import threefry as ref_tf3  # noqa: E402
from repro_torch.core import evaluation  # noqa: E402
from repro_torch.kernels.lda_l2r import ops as l2r_ops  # noqa: E402
from torch_parity import port_key, reference_mode, to_torch  # noqa: E402

ALPHA = 0.5


def _inputs(seed, b=8, l=12, k=5, v=40):
    rng = np.random.default_rng(seed)
    stats = rng.random((k, v), dtype=np.float32)
    words = rng.integers(0, v, (b, l)).astype(np.int32)
    lengths = rng.integers(2, l + 1, b)
    mask = np.arange(l)[None, :] < lengths[:, None]
    return stats, words, mask


@pytest.mark.parametrize("seed,p", [(0, 4), (1, 3)])
def test_left_to_right_fused_matches_reference(seed, p):
    stats, words, mask = _inputs(seed)
    beta = stats / stats.sum(-1, keepdims=True)
    beta_w = np.take(beta.T, words, axis=0)
    doc_ids = np.arange(5, 5 + words.shape[0], dtype=np.int32)
    key = jax.random.key(seed + 30)
    with reference_mode():
        want = np.asarray(ref_eval.left_to_right_fused(
            key, jnp.asarray(doc_ids), jnp.asarray(beta_w),
            jnp.asarray(mask), ALPHA, p))
    got = evaluation.left_to_right_fused(
        port_key(key), to_torch(doc_ids), to_torch(beta_w),
        to_torch(mask), ALPHA, p).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_fused_core_matches_reference_core():
    stats, words, mask = _inputs(2, b=6, l=10, k=4)
    beta = stats / stats.sum(-1, keepdims=True)
    beta_w = np.take(beta.T, words, axis=0)
    key = jax.random.key(8)
    ids = jnp.arange(6, dtype=jnp.int32)
    with reference_mode():
        kd = ref_tf3.key_data(
            jax.vmap(lambda d: jax.random.fold_in(key, d))(ids))
        want = np.asarray(ref_eval._l2r_fused_core(
            kd, jnp.asarray(beta_w), jnp.asarray(mask, jnp.float32), ALPHA,
            3, count_weighted=False))
    got = evaluation._l2r_fused_core(
        to_torch(np.asarray(kd).astype(np.int64)), to_torch(beta_w),
        to_torch(mask.astype(np.float32)), ALPHA, 3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_ll_slab_from_stats_matches_reference():
    stats, words, mask = _inputs(3)
    key = jax.random.key(4)
    ids = np.arange(words.shape[0], dtype=np.int32)
    with reference_mode():
        want = np.asarray(ref_eval.ll_slab_from_stats(
            key, jnp.asarray(ids), jnp.asarray(words), jnp.asarray(mask),
            jnp.asarray(stats), 1e-2, ALPHA, 4))
    got = evaluation.ll_slab_from_stats(
        port_key(key), to_torch(ids), to_torch(words), to_torch(mask),
        to_torch(stats), 1e-2, ALPHA, 4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("seed,p", [(5, 4), (6, 3)])
def test_public_left_to_right_entries_match_reference(seed, p):
    """The reference's public serial estimator and its words-and-beta
    entry (global doc ids and the default arange)."""
    stats, words, mask = _inputs(seed)
    beta = stats / stats.sum(-1, keepdims=True)
    beta_w = np.take(beta.T, words, axis=0)
    ids = np.arange(9, 9 + words.shape[0], dtype=np.int32)
    key = jax.random.key(seed + 40)
    with reference_mode():
        want_bw = np.asarray(ref_eval.left_to_right_from_beta_w(
            key, jnp.asarray(ids), jnp.asarray(beta_w), jnp.asarray(mask),
            ALPHA, p))
        want_ll = np.asarray(ref_eval.left_to_right_log_likelihood(
            key, jnp.asarray(words), jnp.asarray(mask), jnp.asarray(beta),
            ALPHA, p, doc_ids=jnp.asarray(ids)))
        want_def = np.asarray(ref_eval.left_to_right_log_likelihood(
            key, jnp.asarray(words), jnp.asarray(mask), jnp.asarray(beta),
            ALPHA, p))
    got_bw = evaluation.left_to_right_from_beta_w(
        port_key(key), to_torch(ids), to_torch(beta_w), to_torch(mask),
        ALPHA, p).numpy()
    got_ll = evaluation.left_to_right_log_likelihood(
        port_key(key), to_torch(words).long(), to_torch(mask),
        to_torch(beta), ALPHA, p, doc_ids=to_torch(ids)).numpy()
    got_def = evaluation.left_to_right_log_likelihood(
        port_key(key), to_torch(words).long(), to_torch(mask),
        to_torch(beta), ALPHA, p).numpy()
    np.testing.assert_allclose(got_bw, want_bw, rtol=1e-5)
    np.testing.assert_allclose(got_ll, want_ll, rtol=1e-5)
    np.testing.assert_allclose(got_def, want_def, rtol=1e-5)


def test_public_unique_entry_matches_reference():
    stats, words, mask = _inputs(7, b=7, l=14, k=4, v=9)
    key = jax.random.key(47)
    with reference_mode():
        uw, counts = ref_estep.unique_view(jnp.asarray(words),
                                           jnp.asarray(mask))
        beta = jnp.asarray(stats / stats.sum(-1, keepdims=True))
        beta_w = jnp.take(beta.T, uw, axis=0)
        ids = jnp.arange(words.shape[0], dtype=jnp.int32)
        want = np.asarray(ref_eval.left_to_right_unique_from_beta_w(
            key, ids, beta_w, counts, ALPHA, 4))
    assert int(np.asarray(counts).max()) > 1
    got = evaluation.left_to_right_unique_from_beta_w(
        port_key(key), to_torch(ids), to_torch(beta_w), to_torch(counts),
        ALPHA, 4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("layout", ["dense", "unique"])
def test_heldout_lp_from_vocab_sharded_stats_matches_reference(layout):
    """Probe statistics [P, K, S, V/S] (the Scale layer's carry) give the
    reference's per-statistic LP from [K, S, V/S], and the dense [P, K, V]
    LP bit for bit."""
    rng = np.random.default_rng(11)
    p, k, s, v = 3, 4, 4, 32
    stats = rng.random((p, k, s, v // s), dtype=np.float32)
    _st, words, mask = _inputs(12, b=6, l=8, k=k, v=v)
    key = jax.random.key(13)
    with reference_mode():
        w, m = jnp.asarray(words), jnp.asarray(mask)
        if layout == "unique":
            w, m = ref_estep.dense_to_unique(w, m)
        want = np.array([float(ref_eval.heldout_lp_from_stats(
            key, w, m, jnp.asarray(stats[i]), 1e-2, ALPHA, 4, layout))
            for i in range(p)])
    tw, tm = to_torch(np.asarray(w)), to_torch(np.asarray(m))
    got = evaluation.heldout_lp_from_stats(
        port_key(key), tw, tm, to_torch(stats), 1e-2, ALPHA, 4, layout)
    dense = evaluation.heldout_lp_from_stats(
        port_key(key), tw, tm, to_torch(stats.reshape(p, k, v)), 1e-2,
        ALPHA, 4, layout)
    assert torch.equal(got, dense)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_evaluate_heldout_chunk_invariant():
    """Chunks of 1, 7 and B give the same bits, via stats or beta."""
    stats, words, mask = _inputs(4, b=11, l=9, k=4)
    key = port_key(jax.random.key(5))
    args = (key, to_torch(words), to_torch(mask))
    full = evaluation.evaluate_heldout(*args, stats=to_torch(stats),
                                       alpha=ALPHA, n_particles=3,
                                       chunk_docs=11)
    for c in (1, 7, None):
        got = evaluation.evaluate_heldout(*args, stats=to_torch(stats),
                                          alpha=ALPHA, n_particles=3,
                                          chunk_docs=c)
        assert torch.equal(got, full), c
    beta = to_torch(stats) + 1e-2
    beta = beta / beta.sum(-1, keepdim=True)
    via_beta = evaluation.evaluate_heldout(*args, beta=beta, alpha=ALPHA,
                                           n_particles=3, chunk_docs=4)
    assert torch.equal(via_beta, full)


def test_evaluate_heldout_matches_reference():
    stats, words, mask = _inputs(6, b=9)
    key = jax.random.key(12)
    with reference_mode():
        want = np.asarray(ref_eval.evaluate_heldout(
            key, jnp.asarray(words), jnp.asarray(mask),
            stats=jnp.asarray(stats), alpha=ALPHA, n_particles=4,
            chunk_docs=4))
    got = evaluation.evaluate_heldout(
        port_key(key), to_torch(words), to_torch(mask),
        stats=to_torch(stats), alpha=ALPHA, n_particles=4,
        chunk_docs=4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("n,l,p,k", [(10**9, 16, 10, 100), (50, 64, 10, 5),
                                     (7, 32, 3, 128)])
def test_auto_chunk_docs_matches_reference(n, l, p, k):
    assert (evaluation.auto_chunk_docs(n, l, p, k)
            == ref_eval.auto_chunk_docs(n, l, p, k))


def test_l2r_ops_dispatches_cpu_to_plain():
    stats, words, mask = _inputs(7, b=3, l=6, k=3)
    beta_w = to_torch(np.take(stats.T, words, axis=0))
    kd = port_key(jax.random.key(1)).expand(3, 2)
    before = l2r_ops.launches
    scores = l2r_ops.l2r_scores(kd, beta_w, to_torch(mask).float(), ALPHA,
                                n_particles=2)
    assert l2r_ops.launches == before
    assert scores.shape == (6, 3)
    assert torch.equal(scores, evaluation.l2r_position_scores(
        kd, beta_w, to_torch(mask).float(), ALPHA, 2))


def _dup_inputs(seed, b=7, l=14, k=4, v=9):
    """Held-out documents with repeated words (a small vocabulary)."""
    return _inputs(seed, b=b, l=l, k=k, v=v)


def test_left_to_right_unique_fused_matches_reference():
    stats, words, mask = _dup_inputs(20)
    key = jax.random.key(21)
    with reference_mode():
        uw, counts = ref_estep.unique_view(jnp.asarray(words),
                                           jnp.asarray(mask))
        beta = jnp.asarray(stats / stats.sum(-1, keepdims=True))
        beta_w = jnp.take(beta.T, uw, axis=0)
        ids = jnp.arange(3, 3 + words.shape[0], dtype=jnp.int32)
        want = np.asarray(ref_eval.left_to_right_unique_fused(
            key, ids, beta_w, counts, ALPHA, 4))
    assert int(np.asarray(counts).max()) > 1
    got = evaluation.left_to_right_unique_fused(
        port_key(key), to_torch(ids), to_torch(beta_w), to_torch(counts),
        ALPHA, 4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_evaluate_heldout_unique_matches_reference():
    stats, words, mask = _dup_inputs(22, b=9)
    key = jax.random.key(23)
    with reference_mode():
        want = np.asarray(ref_eval.evaluate_heldout(
            key, jnp.asarray(words), jnp.asarray(mask),
            stats=jnp.asarray(stats), alpha=ALPHA, n_particles=3,
            chunk_docs=4, layout="unique"))
    got = evaluation.evaluate_heldout(
        port_key(key), to_torch(words), to_torch(mask),
        stats=to_torch(stats), alpha=ALPHA, n_particles=3, chunk_docs=4,
        layout="unique").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    with pytest.raises(ValueError, match="layout"):
        evaluation.evaluate_heldout(port_key(key), to_torch(words),
                                    to_torch(mask), stats=to_torch(stats),
                                    alpha=ALPHA, layout="csr")


def test_evaluate_heldout_unique_chunk_invariant():
    """Chunks of 1, 3 and B give the same bits in the unique layout."""
    stats, words, mask = _dup_inputs(24, b=8)
    args = (port_key(jax.random.key(25)), to_torch(words), to_torch(mask))
    full = evaluation.evaluate_heldout(*args, stats=to_torch(stats),
                                       alpha=ALPHA, n_particles=2,
                                       chunk_docs=8, layout="unique")
    for c in (1, 3):
        got = evaluation.evaluate_heldout(*args, stats=to_torch(stats),
                                          alpha=ALPHA, n_particles=2,
                                          chunk_docs=c, layout="unique")
        assert torch.equal(got, full), c


def test_unique_layout_equals_dense_on_distinct_words():
    """Sorted documents without repeats: counts are the mask, and the
    count-weighted estimator gives the dense one's bits."""
    rng = np.random.default_rng(26)
    b, l, v = 5, 10, 40
    words = np.sort(np.stack([rng.choice(v, l, replace=False)
                              for _ in range(b)]), -1).astype(np.int32)
    mask = np.arange(l)[None, :] < np.array([l, 7, 2, 9, l])[:, None]
    words = np.where(mask, words, 0)
    stats = rng.random((4, v), dtype=np.float32)
    args = (port_key(jax.random.key(27)), to_torch(words), to_torch(mask))
    dense = evaluation.evaluate_heldout(*args, stats=to_torch(stats),
                                        alpha=ALPHA, n_particles=3)
    unique = evaluation.evaluate_heldout(*args, stats=to_torch(stats),
                                         alpha=ALPHA, n_particles=3,
                                         layout="unique")
    assert torch.equal(dense, unique)


def test_count_weighted_scores_on_cpu_are_the_plain_version():
    stats, words, mask = _dup_inputs(28, b=3, l=6, k=3)
    beta_w = to_torch(np.take(stats.T, words, axis=0))
    counts = to_torch(mask.astype(np.float32) * 2)
    kd = port_key(jax.random.key(2)).expand(3, 2)
    before = l2r_ops.launches
    got = l2r_ops.l2r_scores(kd, beta_w, counts, ALPHA, n_particles=2,
                             count_weighted=True)
    assert l2r_ops.launches == before
    assert torch.equal(got, evaluation.l2r_position_scores(
        kd, beta_w, counts, ALPHA, 2, count_weighted=True))
    plain = evaluation.l2r_position_scores(kd, beta_w, counts, ALPHA, 2)
    assert torch.equal(got, torch.where(counts.T > 0, 2 * plain, plain))


def _chip_smoke():
    """``chip_smoke.py``'s module (its K3 chain bound), without running it."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_l2r", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _scan_steps(w):
    """The K-add chains one particle of the plain scan makes on a document
    of weights ``w``: at every position n up to the last weighted one, a
    resample of each weighted i < n, and the draw of z_n where w[n] > 0."""
    act = [x > 0 for x in w]
    end = max((i + 1 for i, a in enumerate(act) if a), default=0)
    return sum(sum(act[:n]) for n in range(end)) + sum(act)


@pytest.mark.parametrize("case,weights,chains", [
    # dense prefixes of 0, 1, 5 and 12 positions: E(E+1)/2 at E = 12
    ("dense", [[1] * e + [0] * (12 - e) for e in (0, 1, 5, 12)], 78),
    # the unique layout's counts, padding slots at the end: E = 3
    ("counts", [[3, 1, 2, 0, 0, 0], [1, 0, 0, 0, 0, 0]], 6),
    # a weight-0 slot inside: never resampled, no draw, but position 0 is
    # resampled there (1 + 1 + 2 + 3 chains)
    ("gap", [[1, 0, 1, 1, 0, 0]], 7),
])
def test_l2r_chain_bound_counts_the_scans_chains(case, weights, chains):
    smoke = _chip_smoke()
    w = torch.tensor(weights, dtype=torch.float32)
    assert max(_scan_steps(row) for row in weights) == chains
    rt = type("Rt", (), {"t_add_ns": 2.0})()
    assert smoke._l2r_chain_ms(rt, w, 100) == pytest.approx(
        chains * 100 * 2.0e-6)
