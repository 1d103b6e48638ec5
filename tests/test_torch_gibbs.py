"""The port's ``core.gibbs.gibbs_estep`` against the JAX package's.

The reference's wrapper runs its dense E-step backend; the port's runs
``estep.DenseEStep`` (the ``lda_gibbs`` kernel on the card, its plain
version here) on the same key, documents and beta.
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import gibbs as ref_gibbs  # noqa: E402
from repro.core import lda as ref_lda  # noqa: E402
from repro_torch.core import gibbs, lda  # noqa: E402
from torch_parity import port_key, reference_mode, to_torch  # noqa: E402

KW = dict(n_topics=4, vocab_size=30, alpha=0.5, doc_len_max=8, n_gibbs=6,
          n_gibbs_burnin=2)


def _inputs(seed, b=5, l=8, k=4, v=30):
    rng = np.random.default_rng(seed)
    beta = rng.random((k, v), dtype=np.float32) + np.float32(1e-3)
    beta /= beta.sum(-1, keepdims=True)
    words = rng.integers(0, v, (b, l)).astype(np.int32)
    lengths = rng.integers(1, l + 1, b)
    mask = np.arange(l)[None, :] < lengths[:, None]
    return beta, words, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gibbs_estep_matches_reference(seed):
    beta, words, mask = _inputs(seed)
    key = jax.random.key(100 + seed)
    with reference_mode():
        want = ref_gibbs.gibbs_estep(ref_lda.LDAConfig(**KW), key,
                                     jnp.asarray(words), jnp.asarray(mask),
                                     jnp.asarray(beta))
    got = gibbs.gibbs_estep(lda.LDAConfig(**KW), port_key(key),
                            to_torch(words).long(), to_torch(mask),
                            to_torch(beta))
    np.testing.assert_array_equal(got.z.numpy(), np.asarray(want.z))
    np.testing.assert_allclose(got.stats.numpy(), np.asarray(want.stats),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.n_dk.numpy(), np.asarray(want.n_dk),
                               rtol=1e-6)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta),
                               rtol=1e-5)


def test_gibbs_estep_sampled_estimator_is_refused():
    beta, words, mask = _inputs(3)
    with pytest.raises(NotImplementedError, match="Rao-Blackwell"):
        gibbs.gibbs_estep(lda.LDAConfig(**KW),
                          torch.zeros(2, dtype=torch.int64),
                          to_torch(words).long(), to_torch(mask),
                          to_torch(beta), rao_blackwell=False)
