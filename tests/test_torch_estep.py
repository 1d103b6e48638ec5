"""The port's E-step against the JAX package's, on the same numpy inputs.

Gibbs draws may differ only at counted ulp ties: the reference samples
with ``jnp.cumsum`` (association chosen by XLA), the port with one fixed
sequential association. A document whose chain differs must have had a
draw within 1e-6 of a CDF step, and such documents are at most one per
10^4 draws; every other document agrees at the stated tolerances.
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import estep as ref_estep  # noqa: E402
from repro.core import lda as ref_lda  # noqa: E402
from repro_torch.core import estep  # noqa: E402
from repro_torch.core import lda  # noqa: E402
from repro_torch.kernels.lda_gibbs import ops as gibbs_ops  # noqa: E402
from torch_parity import (gibbs_inputs, port_key,  # noqa: E402
                          reference_mode, to_torch)

ALPHA = 0.5
TIE = 1e-6


def _flipped_docs(got, want, rtol, atol):
    """Documents (leading axis) where any output disagrees."""
    bad = np.zeros(got[0].shape[0], bool)
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        close = np.isclose(g, w, rtol=rtol, atol=atol)
        bad |= ~close.reshape(close.shape[0], -1).all(-1)
    return bad


def _assert_ties_only(bad, margins, n_draws):
    flips = int(bad.sum())
    assert flips * 10_000 <= n_draws, (flips, n_draws)
    assert np.all(margins[bad] <= TIE), margins[bad]


@pytest.mark.parametrize("seed,k", [(0, 5), (1, 8), (2, 2)])
def test_gibbs_sweeps_match_reference(seed, k):
    b, l, s, burnin = 16, 16, 6, 3
    beta_w, maskf, uniforms, z0 = gibbs_inputs(seed, b, l, k, s)
    want = ref_estep.gibbs_sweeps_dense(
        jnp.asarray(beta_w), jnp.asarray(maskf), jnp.asarray(uniforms),
        jnp.asarray(z0), alpha=ALPHA, n_sweeps=s, burnin=burnin)
    args = [to_torch(x) for x in (beta_w, maskf, uniforms, z0)]
    got = estep.gibbs_sweeps_dense(*args, alpha=ALPHA, n_sweeps=s,
                                   burnin=burnin)
    got = [x.numpy() for x in got]
    bad = _flipped_docs(got, [np.asarray(w) for w in want], 1e-5, 1e-6)
    margins = estep.gibbs_tie_margins(*args, alpha=ALPHA,
                                      n_sweeps=s).numpy()
    _assert_ties_only(bad, margins, int(maskf.sum()) * s)
    np.testing.assert_array_equal(got[1][~bad], np.asarray(want[1])[~bad])


def test_gibbs_ops_dispatches_cpu_to_plain():
    beta_w, maskf, uniforms, z0 = gibbs_inputs(3, 5, 7, 4, 4)
    args = [to_torch(x) for x in (beta_w, maskf, uniforms, z0)]
    before = gibbs_ops.launches
    a = gibbs_ops.gibbs_sweeps(*args, alpha=ALPHA, n_sweeps=4, burnin=2)
    b = estep.gibbs_sweeps_dense(*args, alpha=ALPHA, n_sweeps=4, burnin=2)
    assert gibbs_ops.launches == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_draw_gibbs_randoms_match_reference():
    cfg = ref_lda.LDAConfig(n_topics=6, vocab_size=20, n_gibbs=5,
                            n_gibbs_burnin=2)
    pcfg = lda.LDAConfig(n_topics=6, vocab_size=20, n_gibbs=5,
                         n_gibbs_burnin=2)
    key = jax.random.key(9)
    with reference_mode():
        u_ref, z_ref = ref_estep.draw_gibbs_randoms(cfg, key, 4, 7,
                                                    jnp.float32)
    u, z0 = estep.draw_gibbs_randoms(pcfg, port_key(key), 4, 7)
    np.testing.assert_array_equal(u.numpy(), np.asarray(u_ref))
    np.testing.assert_array_equal(z0.numpy(), np.asarray(z_ref))


def test_stats_and_beta_helpers_match_reference():
    rng = np.random.default_rng(4)
    k, v, b, l = 5, 30, 6, 9
    stats = rng.random((k, v), dtype=np.float32)
    words = rng.integers(0, v, (b, l)).astype(np.int32)
    per_pos = rng.random((b, l, k), dtype=np.float32)
    maskf = (rng.random((b, l)) < 0.7).astype(np.float32)
    maskf[2] = 0.0                                      # an empty doc
    tau = 1e-2
    pairs = [
        (estep.stats_from_per_pos(to_torch(words), to_torch(per_pos), v,
                                  to_torch(maskf)),
         ref_estep.stats_from_per_pos(jnp.asarray(words),
                                      jnp.asarray(per_pos), v,
                                      jnp.asarray(maskf))),
        (estep.stats_from_per_pos(to_torch(words), to_torch(per_pos), v),
         ref_estep.stats_from_per_pos(jnp.asarray(words),
                                      jnp.asarray(per_pos), v)),
        (estep.beta_w_from_stats(to_torch(stats), to_torch(words), tau),
         ref_estep.beta_w_from_stats(jnp.asarray(stats), jnp.asarray(words),
                                     tau)),
        (lda.eta_star(to_torch(stats), tau),
         ref_lda.eta_star(jnp.asarray(stats), tau)),
        (lda.eta_star_denom(to_torch(stats), tau),
         ref_lda.eta_star_denom(jnp.asarray(stats), tau)),
        (lda.log_eta_star(to_torch(stats), tau),
         ref_lda.log_eta_star(jnp.asarray(stats), tau)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)


def test_stats_from_per_pos_is_deterministic():
    rng = np.random.default_rng(5)
    words = to_torch(rng.integers(0, 7, (8, 12)))       # many duplicates
    per_pos = to_torch(rng.random((8, 12, 4), dtype=np.float32))
    a = estep.stats_from_per_pos(words, per_pos, 7)
    b = estep.stats_from_per_pos(words, per_pos, 7)
    assert torch.equal(a, b)
    assert not torch.are_deterministic_algorithms_enabled()


def test_theta_slab_matches_reference():
    b, l, k, s, burnin = 12, 10, 5, 6, 3
    beta_w, maskf, _u, _z = gibbs_inputs(6, b, l, k, s)
    doc_ids = np.arange(100, 100 + b, dtype=np.int32)
    key = jax.random.key(21)
    with reference_mode():
        want = np.asarray(ref_estep.theta_slab(
            key, jnp.asarray(doc_ids), jnp.asarray(beta_w),
            jnp.asarray(maskf), alpha=ALPHA, n_sweeps=s, burnin=burnin))
    got = estep.theta_slab(port_key(key), to_torch(doc_ids),
                           to_torch(beta_w), to_torch(maskf), alpha=ALPHA,
                           n_sweeps=s, burnin=burnin).numpy()
    bad = _flipped_docs([got], [want], 1e-5, 1e-6)
    if bad.any():       # replay the port's per-document streams for margins
        from repro_torch.core import threefry as tf3
        ks = tf3.split(tf3.fold_in_data(port_key(key), to_torch(doc_ids)))
        u = tf3.uniform(ks[:, 1], (s, l)).transpose(0, 1)
        z0 = tf3.randint(ks[:, 0], (l,), 0, k)
        margins = estep.gibbs_tie_margins(to_torch(beta_w), to_torch(maskf),
                                          u, z0, alpha=ALPHA,
                                          n_sweeps=s).numpy()
        _assert_ties_only(bad, margins, int(maskf.sum()) * s)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-6)


def test_theta_slab_is_slab_invariant():
    """A document alone and inside any slab gets the same bits."""
    b, l, k, s = 9, 8, 4, 5
    beta_w, maskf, _u, _z = gibbs_inputs(7, b, l, k, s)
    key = port_key(jax.random.key(2))
    doc_ids = torch.arange(b) * 3 + 1
    full = estep.theta_slab(key, doc_ids, to_torch(beta_w),
                            to_torch(maskf), alpha=ALPHA, n_sweeps=s,
                            burnin=2)
    perm = torch.tensor([4, 0, 8, 2])
    part = estep.theta_slab(key, doc_ids[perm], to_torch(beta_w)[perm],
                            to_torch(maskf)[perm], alpha=ALPHA, n_sweeps=s,
                            burnin=2)
    assert torch.equal(part, full[perm])
    for d in range(b):
        one = estep.theta_slab(key, doc_ids[d:d + 1],
                               to_torch(beta_w)[d:d + 1],
                               to_torch(maskf)[d:d + 1], alpha=ALPHA,
                               n_sweeps=s, burnin=2)
        assert torch.equal(one[0], full[d])


def test_estep_call_matches_reference():
    cfg = ref_lda.LDAConfig(n_topics=4, vocab_size=25, n_gibbs=6,
                            n_gibbs_burnin=3, doc_len_max=10)
    pcfg = lda.LDAConfig(n_topics=4, vocab_size=25, n_gibbs=6,
                         n_gibbs_burnin=3, doc_len_max=10)
    rng = np.random.default_rng(8)
    words = rng.integers(0, 25, (8, 10)).astype(np.int32)
    mask = np.arange(10)[None, :] < rng.integers(2, 11, 8)[:, None]
    beta = rng.random((4, 25), dtype=np.float32)
    beta /= beta.sum(-1, keepdims=True)
    key = jax.random.key(13)
    with reference_mode():
        want = ref_estep.get_estep("dense")(cfg, key, jnp.asarray(words),
                                            jnp.asarray(mask),
                                            jnp.asarray(beta))
    got = estep.get_estep()(pcfg, port_key(key), to_torch(words),
                            to_torch(mask), to_torch(beta))
    np.testing.assert_array_equal(got.z.numpy(), np.asarray(want.z))
    np.testing.assert_allclose(got.stats.numpy(), np.asarray(want.stats),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.n_dk.numpy(), np.asarray(want.n_dk))


def test_init_stats_and_beta_distance_match_reference():
    cfg = ref_lda.LDAConfig(n_topics=4, vocab_size=30)
    pcfg = lda.LDAConfig(n_topics=4, vocab_size=30)
    key = jax.random.key(17)
    with reference_mode():
        want = np.asarray(ref_lda.init_stats(cfg, key))
    got = lda.init_stats(pcfg, port_key(key)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-6)
    rng = np.random.default_rng(3)
    beta = rng.random((4, 30), dtype=np.float32)
    beta_star = rng.random((4, 30), dtype=np.float32)
    want = float(ref_lda.beta_distance(jnp.asarray(beta),
                                       jnp.asarray(beta_star)))
    got = float(lda.beta_distance(to_torch(beta), to_torch(beta_star)))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    perm = [2, 0, 3, 1]
    assert lda.beta_distance(to_torch(beta[perm]), to_torch(beta)) < 1e-5


def test_sample_document_follows_the_model():
    pcfg = lda.LDAConfig(n_topics=3, vocab_size=12, doc_len_max=10)
    key = port_key(jax.random.key(6))
    beta = torch.zeros((3, 12))
    beta[0, :4] = beta[1, 4:8] = beta[2, 8:] = 0.25
    words, mask = lda.sample_document(pcfg, key, beta, 7)
    assert words.shape == mask.shape == (10,)
    assert mask.tolist() == [True] * 7 + [False] * 3
    assert words[7:].eq(0).all() and words.lt(12).all()
    again, _ = lda.sample_document(pcfg, key, beta, 7)
    assert torch.equal(words, again)
