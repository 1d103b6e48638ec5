"""Helpers shared by the port's parity tests (tests/test_torch_*.py).

The same numpy inputs go to the JAX package and to the port. The
reference runs inside :func:`reference_mode`: its goldens and its
threefry replica assume jax's non-partitionable threefry, and the mode
is scoped per call because xdist reuses workers across files.
"""

import jax
import numpy as np
import torch


def reference_mode():
    return jax.threefry_partitionable(False)


def port_key(key) -> torch.Tensor:
    """A jax key's words as the port's key ([2] int64)."""
    return torch.from_numpy(
        np.asarray(jax.random.key_data(key)).astype(np.int64))


def to_torch(x, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def gibbs_inputs(seed, b, l, k, s):
    """Seeded numpy inputs of a Gibbs sweep call."""
    rng = np.random.default_rng(seed)
    beta_w = rng.random((b, l, k), dtype=np.float32) + np.float32(1e-3)
    lengths = rng.integers(1, l + 1, size=b)
    lengths[0] = l
    maskf = (np.arange(l)[None, :] < lengths[:, None]).astype(np.float32)
    uniforms = rng.random((s, b, l), dtype=np.float32)
    z0 = rng.integers(0, k, size=(b, l)).astype(np.int32)
    return beta_w, maskf, uniforms, z0
