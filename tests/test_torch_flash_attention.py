"""The port's attention (K5's plain version and its CPU dispatch) against
the JAX package's.

The same seeded numpy inputs go to the reference's Pallas kernel (in
interpret mode) and ``attention_ref``, and to the port's
``attention_ref`` and ``ops.flash_attention`` on CPU tensors, at the
reference kernel test's seven cases (``tests/test_kernels.py``) and one
bf16 case: float32 within 2e-5 and bf16 within 3e-2, the reference
test's own tolerances. The CUDA kernel itself is held by
``tests/test_torch_device.py`` on the card and by ``chip_smoke.py``.
"""

import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention import flash_attention as ref_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as ref_dense  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from torch_parity import reference_mode  # noqa: E402

# (name, b, sq, sk, h, hkv, d, kwargs, dtype, atol)
CASES = [
    ("causal", 2, 128, 128, 4, 2, 64, {}, "float32", 2e-5),
    ("unaligned", 1, 100, 100, 2, 2, 32, {}, "float32", 2e-5),
    ("mha", 1, 64, 64, 2, 2, 16, {}, "float32", 2e-5),
    ("window", 1, 192, 192, 4, 1, 64, {"window": 64}, "float32", 2e-5),
    ("softcap", 1, 128, 128, 2, 2, 64, {"softcap": 30.0}, "float32", 2e-5),
    ("decode", 2, 1, 192, 4, 2, 64, {"q_offset": 191}, "float32", 2e-5),
    ("win+cap", 1, 128, 128, 4, 4, 32, {"window": 32, "softcap": 50.0},
     "float32", 2e-5),
    ("bf16", 1, 64, 64, 2, 2, 32, {}, "bfloat16", 3e-2),
]


def _inputs(seed, b, sq, sk, h, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, sk, hkv, d), dtype=np.float32),
            rng.standard_normal((b, sk, hkv, d), dtype=np.float32))


def _heads_first(x):
    """[B, S, H, D] -> [B*H, S, D], the layout of both ``attention_ref``s."""
    b, s, h, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * h, s, d)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_port_attention_matches_reference(case):
    name, b, sq, sk, h, hkv, d, kw, dtype, atol = case
    q, k, v = _inputs(CASES.index(case), b, sq, sk, h, hkv, d)
    jq, jk, jv = (jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype))
                  for x in (q, k, v))
    with reference_mode():
        want_kernel = np.asarray(ref_flash(jq, jk, jv, blk_q=64, blk_k=64,
                                           causal=True, **kw), np.float32)
        want = np.asarray(ref_dense(*map(_heads_first, (jq, jk, jv)),
                                    causal=True, **kw), np.float32)
    want = want.reshape(b, h, sq, d).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(want_kernel, want, atol=atol)

    got = ops.flash_attention(tq, tk, tv, causal=True, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol)
    dense = attention_ref(*(x.transpose(1, 2).reshape(-1, x.shape[1], d)
                            for x in (tq, tk, tv)), causal=True, **kw)
    dense = dense.float().reshape(b, h, sq, d).transpose(1, 2).numpy()
    np.testing.assert_allclose(dense, want, atol=atol)


def test_fully_masked_row_gives_zero():
    """A window of 0 hides every key: the row is 0, not NaN."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(9, 1, 8, 8, 2, 1, 16))
    out = ops.flash_attention(q, k, v, window=0)
    assert torch.equal(out, torch.zeros_like(out))


def test_cpu_dispatch_counts_no_launch():
    q, k, v = (torch.from_numpy(x) for x in _inputs(3, 1, 16, 16, 2, 1, 16))
    before, shapes = ops.launches, dict(ops.launches_by_shape)
    ops.flash_attention(q, k, v, window=8, softcap=50.0)
    assert ops.launches == before
    assert ops.launches_by_shape == shapes
    assert ops.shape_key(q, k, 8, 50.0) == (1, 16, 16, 2, 1, 16, "f32",
                                            "local", 50.0)
    assert ops.shape_key(q, k, ops.GLOBAL_WINDOW, None)[7] == "global"
