"""The port's gossip mixing, K1 plain version and communicator against the
JAX package's, on the same numpy inputs.

Mixing is one add and one multiply per element, so the port's results
equal the reference's bit for bit, self-partners included. The consensus
distance is a float32 norm whose summation order XLA chooses; it agrees
to a few ulp (rtol 1e-6), not bitwise.
"""

import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import comm as ref_comm  # noqa: E402
from repro.core import gossip as ref_gossip  # noqa: E402
from repro.kernels.gossip_mix import ref as ref_mix  # noqa: E402
from repro_torch.core import comm, gossip  # noqa: E402
from repro_torch.kernels.gossip_mix import ops as mix_ops  # noqa: E402
from repro_torch.kernels.gossip_mix import ref as mix_ref  # noqa: E402

SEEDS = (0, 1, 2, 3)


def _stats(seed, n=9, shape=(4, 13)):
    rng = np.random.default_rng(seed)
    return (rng.random((n,) + shape, dtype=np.float32)
            * np.float32(10.0 ** rng.integers(-3, 3)))


def _partners(seed, n=9):
    """An involution with matched pairs and self-partners."""
    rng = np.random.default_rng(seed + 100)
    order = rng.permutation(n)
    p = np.arange(n, dtype=np.int32)
    for a, b in zip(order[0:6:2], order[1:6:2]):
        p[a], p[b] = b, a
    return p


@pytest.mark.parametrize("seed", SEEDS)
def test_mix_matching_and_edge_bitwise(seed):
    s = _stats(seed)
    p = _partners(seed)
    want = np.asarray(ref_gossip.mix_matching(jnp.asarray(s),
                                              jnp.asarray(p)))
    np.testing.assert_array_equal(
        gossip.mix_matching(torch.from_numpy(s), p).numpy(), want)
    np.testing.assert_array_equal(
        mix_ref.mix_matching_ref(torch.from_numpy(s), p).numpy(),
        np.asarray(ref_mix.mix_matching_ref(jnp.asarray(s),
                                            jnp.asarray(p))))
    i, j = 2, 7
    np.testing.assert_array_equal(
        gossip.mix_edge(torch.from_numpy(s), i, j).numpy(),
        np.asarray(ref_gossip.mix_edge(jnp.asarray(s), i, j)))


@pytest.mark.parametrize("seed", SEEDS)
def test_kernel_plain_version_matches_reference_ref(seed):
    """The wrapper's CPU path (the in-place pair form) equals the
    reference kernel's oracle, self-partners included, and launches
    nothing."""
    s = _stats(seed)
    p = _partners(seed)
    pairs = mix_ops.pairs_of(p)
    assert len(pairs) == 3 and (pairs[:, 0] < pairs[:, 1]).all()
    before = mix_ops.launches
    got = torch.from_numpy(s.copy())
    out = mix_ops.mix_pairs_(got, pairs)
    assert out is got and mix_ops.launches == before
    want = np.asarray(ref_mix.mix_matching_ref(jnp.asarray(s),
                                               jnp.asarray(p)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_comm_matches_reference_backends(seed):
    """SimComm equals DenseSimComm, and its two-row ``mix_edge`` equals
    PallasSimComm.mix_edge (its full n-vector of partners) taken through
    the kernel's oracle ``ref.py``."""
    s = _stats(seed)
    p = _partners(seed)
    c = comm.SimComm()
    got = c.mix_matching(torch.from_numpy(s.copy()), p)
    want = ref_comm.DenseSimComm().mix_matching(jnp.asarray(s), p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    class OracleComm(ref_comm.PallasSimComm):
        def mix_matching(self, stats, partners):
            return ref_mix.mix_matching_ref(stats, partners)

    for i, j in [(0, 8), (5, 3), (4, 4)]:
        got = c.mix_edge(torch.from_numpy(s.copy()), i, j)
        want = OracleComm().mix_edge(jnp.asarray(s), i, j)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        dense = ref_comm.DenseSimComm().mix_edge(jnp.asarray(s), i, j)
        np.testing.assert_array_equal(got.numpy(), np.asarray(dense))
    assert c.bytes_per_round(s.shape, 4, p) == \
        ref_comm.DenseSimComm().bytes_per_round(s.shape, 4, p)


def test_mix_edge_touches_only_its_rows():
    s = torch.from_numpy(_stats(5))
    before = s.clone()
    comm.SimComm().mix_edge(s, 1, 6)
    others = [r for r in range(s.shape[0]) if r not in (1, 6)]
    assert torch.equal(s[others], before[others])
    assert torch.equal(s[1], s[6])
    assert not torch.equal(s[1], before[1])


def test_mix_pairs_rejects_bad_pairs():
    s = torch.zeros(4, 3)
    for bad, msg in (([[0, 4]], "out of range"), ([[2, 2]], "itself"),
                     ([[0, 1], [1, 2]], "two pairs")):
        with pytest.raises(ValueError, match=msg):
            mix_ops.mix_pairs_(s, np.array(bad))
    with pytest.raises(ValueError, match="CUDA"):
        mix_ops.mix_pairs_(torch.empty(4, 3, device="meta"),
                           np.array([[0, 1]]))


@pytest.mark.parametrize("seed", SEEDS)
def test_consensus_distance_and_envelope(seed):
    s = _stats(seed, n=7, shape=(5, 30))
    want = float(ref_gossip.consensus_distance(jnp.asarray(s)))
    got = float(gossip.consensus_distance(torch.from_numpy(s)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    rhos = (10.0 + np.arange(1, 51)) ** -0.6
    for lam2 in (0.5, 0.99, -0.1):
        np.testing.assert_array_equal(
            gossip.consensus_envelope(lam2, rhos, 3.5),
            ref_gossip.consensus_envelope(lam2, rhos, 3.5))
