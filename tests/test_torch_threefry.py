"""The port's threefry equals the JAX package's replica and jax.random
bit for bit (in jax's non-partitionable mode), so the port replays the
reference's training, serving and evaluation streams."""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import threefry as ref_tf3  # noqa: E402
from repro_torch.core import threefry as tf3  # noqa: E402
from torch_parity import port_key, reference_mode  # noqa: E402


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_key_matches_jax(seed):
    np.testing.assert_array_equal(
        tf3.key(seed).numpy(), _np(jax.random.key_data(jax.random.key(seed))))


@pytest.mark.parametrize("data", [0, 1, 7, 2**31, 2**32 - 1])
def test_fold_in_matches_replica(data):
    kd = ref_tf3.key_data(jax.random.key(3))
    want = ref_tf3.fold_in_data(kd, jnp.uint32(data))
    got = tf3.fold_in_data(port_key(jax.random.key(3)), data)
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_fold_in_batched_matches_replica():
    key = jax.random.key(11)
    ids = jnp.arange(37, dtype=jnp.uint32)
    want = ref_tf3.fold_in_data(
        jnp.broadcast_to(ref_tf3.key_data(key), (37, 2)), ids)
    got = tf3.fold_in_data(port_key(key), torch.arange(37))
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("seed", [0, 5, 123456])
def test_split2_matches_replica(seed):
    key = jax.random.key(seed)
    w0, w1 = ref_tf3.split2_data(ref_tf3.key_data(key))
    g0, g1 = tf3.split2_data(port_key(key))
    np.testing.assert_array_equal(g0.numpy(), _np(w0))
    np.testing.assert_array_equal(g1.numpy(), _np(w1))


@pytest.mark.parametrize("n", [1, 2, 3, 7, 10, 33])
def test_uniform_halves_matches_replica(n):
    key = jax.random.key(n * 7 + 1)
    want = ref_tf3.uniform_halves(ref_tf3.key_data(key), n)
    got = tf3.uniform_halves(port_key(key), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("p,l", [(3, 5), (4, 6), (1, 7), (10, 16)])
def test_uniform_column_matches_replica(p, l):
    """Odd and even p*l; every column of a batch of two keys."""
    kd_ref = jnp.stack([ref_tf3.key_data(jax.random.key(p)),
                        ref_tf3.key_data(jax.random.key(l))])
    kd = torch.stack([port_key(jax.random.key(p)),
                      port_key(jax.random.key(l))])
    for i in range(l):
        want = ref_tf3.uniform_column(kd_ref, p, l, jnp.uint32(i))
        got = tf3.uniform_column(kd, p, l, i)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed,n", [(0, 2), (5, 3), (99, 8)])
def test_split_matches_jax(seed, n):
    key = jax.random.key(seed)
    with reference_mode():
        want = jax.random.key_data(jax.random.split(key, n))
    np.testing.assert_array_equal(tf3.split(port_key(key), n).numpy(),
                                  _np(want))


@pytest.mark.parametrize("shape", [(7,), (3, 5), (2, 3, 4)])
def test_uniform_matches_jax(shape):
    key = jax.random.key(17)
    with reference_mode():
        want = jax.random.uniform(key, shape)
    np.testing.assert_array_equal(tf3.uniform(port_key(key), shape).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("lo,hi", [(0, 5), (0, 8), (3, 200001),
                                   (0, 2**31 - 1)])
def test_randint_matches_jax(lo, hi):
    key = jax.random.key(23)
    with reference_mode():
        want = jax.random.randint(key, (4, 9), lo, hi)
    got = tf3.randint(port_key(key), (4, 9), lo, hi)
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_batched_keys_match_per_key_draws():
    """One call over [B, 2] keys draws each key's own stream."""
    keys = jax.random.split(jax.random.key(4), 3)
    kd = torch.stack([port_key(k) for k in keys])
    with reference_mode():
        for j, k in enumerate(keys):
            np.testing.assert_array_equal(
                tf3.uniform(kd, (2, 5))[j].numpy(),
                np.asarray(jax.random.uniform(k, (2, 5))))
            np.testing.assert_array_equal(
                tf3.randint(kd, (6,), 0, 5)[j].numpy(),
                _np(jax.random.randint(k, (6,), 0, 5)))


def test_exponential_matches_jax():
    """Same uniforms, log1p correctly rounded: within one ulp of jax.

    XLA's float32 log1p is not correctly rounded (ROADMAP.md section 3),
    so bitwise equality is not reachable; every draw is within one ulp
    and most are equal.
    """
    key = jax.random.key(3)
    with reference_mode():
        want = np.asarray(jax.random.exponential(key, (4000,)))
    got = tf3.exponential(port_key(key), (4000,)).numpy()
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.all(np.abs(got - want) <= ulp)
    assert np.mean(got != want) < 0.15
