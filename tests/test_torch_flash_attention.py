"""The port's attention (K5's plain version and its CPU dispatch) against
the JAX package's.

The same seeded numpy inputs go to the reference's Pallas kernel (in
interpret mode) and ``attention_ref``, and to the port's
``attention_ref`` and ``ops.flash_attention`` on CPU tensors, at the
reference kernel test's seven cases (``tests/test_kernels.py``) and one
bf16 case: float32 within 2e-5 and bf16 within 3e-2, the reference
test's own tolerances. The CUDA kernel itself is held by
``tests/test_torch_device.py`` on the card and by ``chip_smoke.py``.
Here too: the wrapper's choice of kernel variant over every shape
``chip_smoke.py`` holds and the rule's edges, the decode variant's key
splits, and that a tensor off the CPU reaches the kernel's loader for
every variant and never the plain version; and that the plain forward
and the backward, each one custom op, have fake implementations that
give the real outputs' shapes, dtypes and strides.
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


def _chip_smoke():
    """``chip_smoke.py``'s module (its K5 cases), without running it."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _held_cases():
    import types
    from repro_torch.configs import get_config
    smoke = _chip_smoke()
    rt = types.SimpleNamespace(get_config=get_config, flash_ops=ops)
    return [(c["phase"], c["dtype"], c["sq"], c["d"], c["h"] // c["hkv"],
             c["variant"]) for c in smoke._flash_cases(rt)]


# (dtype, Sq, D, group, variant): the edges of the rule
VARIANT_EDGES = [
    (torch.bfloat16, 1, 256, 2, "decode"),
    (torch.float32, 1, 16, 1, "decode"),
    (torch.bfloat16, 32, 256, 2, "decode"),
    (torch.bfloat16, 33, 256, 2, "wgmma"),
    (torch.bfloat16, 64, 64, 1, "decode"),
    (torch.bfloat16, 65, 64, 1, "wgmma"),
    (torch.bfloat16, 8, 128, 8, "decode"),
    (torch.bfloat16, 9, 128, 8, "wgmma"),
    (torch.bfloat16, 300, 32, 2, "fma"),
    (torch.bfloat16, 300, 16, 1, "fma"),
    (torch.float32, 8192, 256, 2, "fma"),
    (torch.float32, 65, 64, 1, "fma"),
    (torch.float32, 8, 128, 8, "decode"),
    (torch.float32, 9, 128, 8, "fma"),
]


@pytest.mark.parametrize("case", [c[1:] for c in _held_cases()] + VARIANT_EDGES,
                         ids=[c[0] for c in _held_cases()]
                         + [f"edge{i}" for i in range(len(VARIANT_EDGES))])
def test_variant_choice(case):
    """The variant is a function of (dtype, Sq, D, group): "decode" up to
    64 rows per KV head, "wgmma" for bf16 at D >= 64 above that, else
    "fma"; every shape chip_smoke.py holds takes the variant it names."""
    dtype, sq, d, group, want = case
    assert ops.variant(dtype, sq, d, group) == want
    assert want in ops.VARIANTS


@pytest.mark.parametrize("sq, sk, window, q_offset, want", [
    (1, 192, ops.GLOBAL_WINDOW, 95, 1),
    (1, 512, ops.GLOBAL_WINDOW, 511, 1),
    (1, 513, ops.GLOBAL_WINDOW, 512, 2),
    (1, 8192, ops.GLOBAL_WINDOW, 8191, 16),
    (1, 8192, 4096, 8191, 8),
    (1, 8192, 0, 8191, 1),
    (16, 4096, 1500, 4000, 3),
    (1, 8192, ops.GLOBAL_WINDOW, 100, 1),
])
def test_decode_splits(sq, sk, window, q_offset, want):
    """One "decode" split per 512 visible keys, at least one."""
    assert ops.n_splits(sq, sk, True, window, q_offset) == want


@pytest.mark.parametrize("sq, sk, window, control", [
    (1, 2048, None, "split"),
    (1, 2048, 1000, "split"),
    (128, 512, None, "tile"),
    (128, 512, 200, "tile"),
])
def test_row_check_separates_rounding_from_a_dropped_split(sq, sk, window,
                                                           control):
    """chip_smoke.py's K5 row check, on the plain version at gemma2-2b's
    heads: the output's own rounding to bf16 sits under a quarter of
    ``ROW_TOL``, and dropping the last query row's first key split (or
    64-key tile) moves some row by over four times it."""
    smoke = _chip_smoke()
    tol = smoke.ROW_TOL[torch.bfloat16]
    b, h, hkv, d, off = 2, 8, 4, 256, sk - sq
    rng = np.random.default_rng(sk + sq)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(torch.bfloat16)
               for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d)))

    def plain(qkv, win):
        out = attention_ref(*(x.transpose(1, 2).reshape(-1, x.shape[1], d)
                              for x in qkv), window=win, softcap=50.0,
                            scale=1 / 16, q_offset=off)
        return out.reshape(b, h, sq, d).transpose(1, 2)

    seen = min(window or sk, off + sq)
    drop = (-(-seen // ops.n_splits(sq, sk, True, window or ops.GLOBAL_WINDOW,
                                    off)) if control == "split" else 64)
    want = plain((q, k, v), window)
    assert smoke._row_err(want, plain((q.float(), k.float(), v.float()),
                                      window)) < tol / 4
    assert smoke._row_err(plain((q, k, v), seen - drop), want) > 4 * tol


@pytest.mark.parametrize("shape", [
    ((1, 300, 8, 256), (1, 300, 4, 256), torch.bfloat16, 0),      # wgmma
    ((4, 1, 8, 256), (4, 192, 4, 256), torch.bfloat16, 95),       # decode
    ((1, 1, 2, 64), (1, 5000, 1, 64), torch.bfloat16, 4999),      # 5 splits
    ((2, 128, 4, 64), (2, 128, 2, 64), torch.float32, 0),         # fma
])
def test_no_path_from_a_device_tensor_to_the_plain_version(monkeypatch,
                                                            shape):
    """A tensor off the CPU goes to the kernel, whichever variant its
    shape takes, and never to ``attention_ref``: with the device check
    passed, the call reaches the kernel's loader (which raises here, where
    nothing is built); without it, it raises for the device."""
    qs, ks, dtype, q_offset = shape

    def plain(*a, **k):
        raise AssertionError("the plain version ran for a device tensor")

    class Loaded(Exception):
        pass

    def load(name):
        raise Loaded(name)

    q = torch.empty(qs, dtype=dtype, device="meta")
    k = torch.empty(ks, dtype=dtype, device="meta")
    monkeypatch.setattr(ops, "attention_ref", plain)
    before = dict(ops.launches_by_variant), ops.launches
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, k, q_offset=q_offset)
    monkeypatch.setattr(ops.common, "require_cuda", lambda *a: None)
    monkeypatch.setattr(ops.common, "load", load)
    with pytest.raises(Loaded, match="flash_attention"):
        ops.flash_attention(q, k, k, softcap=50.0, q_offset=q_offset)
    assert (dict(ops.launches_by_variant), ops.launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv", [1, 2, 4])
def test_custom_ops_fake_implementations_match_the_real(dtype, hkv):
    """The plain forward and the backward are custom ops whose fake
    implementations (the dry run's) give the real outputs' shapes,
    dtypes and strides, and whose schemas hold (``opcheck``)."""
    g = torch.Generator().manual_seed(hkv)
    q = torch.randn((2, 24, 4, 32), generator=g).to(dtype)
    k, v = (torch.randn((2, 40, hkv, 32), generator=g).to(dtype)
            for _ in range(2))
    checks = ("test_schema", "test_faketensor")
    for op, args in (
            (torch.ops.repro_torch.flash_attention_plain.default,
             (q, k, v, True, None, 30.0, 0.17, 0)),
            (torch.ops.repro_torch.flash_attention_bwd.default,
             (q, k, v, q, True, 16, None, 0.17, 3))):
        assert torch.library.opcheck(op, args, test_utils=checks) == {
            c: "SUCCESS" for c in checks}
