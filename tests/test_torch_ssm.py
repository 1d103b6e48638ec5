"""The port's Mamba2 and xLSTM blocks against the JAX package's, on the
CPU.

The same seeded numpy inputs (and the reference's own parameters, carried
across as numpy) go through both: the chunked SSD scan ``_ssd_chunked``
(its output and final state), ``apply_mamba2`` over a sequence and step
by step through its decode recurrence, mLSTM in its parallel, chunked
and one-step forms, and the sLSTM scan over time and step by step. All
in float32, each within 1e-5 of the largest magnitude of the
reference's output (``_close``): the two sides sum the same products in
different orders, which moves a float32 result by a few ulp of the
largest term. The caches carried by decode agree at the same bound.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.models import mamba2 as ref_m2  # noqa: E402
from repro.models import xlstm as ref_xl  # noqa: E402
from repro_torch.models import mamba2 as m2  # noqa: E402
from repro_torch.models import xlstm as xl  # noqa: E402
from torch_parity import reference_mode  # noqa: E402

B, D = 2, 64
REL = 1e-5


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()) + 1e-30, err


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _ref_params(init, dims):
    with reference_mode():
        p = init(jax.random.key(0), dims, jnp.float32)
    return jax.tree.map(np.asarray, p)


def _port(tree):
    return {k: _t(v) for k, v in tree.items()}


def _cache_close(got, want):
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_ssd_chunked_matches_reference(chunk):
    """The chunked scan's y [B, L, H, P] and final state [B, H, P, N],
    with and without an initial state; ``L % chunk`` is asserted."""
    h, p, n, length = 4, 16, 8, 32
    x = _normal(0, (B, length, h, p))
    dt = np.log1p(np.exp(_normal(1, (B, length, h))))
    a = -np.exp(_normal(2, (h,)) * 0.3)
    b_in, c_in = _normal(3, (B, length, n)), _normal(4, (B, length, n))
    s0 = _normal(5, (B, h, p, n))
    for init in (None, s0):
        with reference_mode():
            want_y, want_s = ref_m2._ssd_chunked(
                *map(jnp.asarray, (x, dt, a, b_in, c_in)), chunk,
                None if init is None else jnp.asarray(init))
        got_y, got_s = m2._ssd_chunked(*map(_t, (x, dt, a, b_in, c_in)),
                                       chunk,
                                       None if init is None else _t(init))
        _close(got_y.numpy(), want_y)
        _close(got_s.numpy(), want_s)
    with pytest.raises(AssertionError):
        m2._ssd_chunked(*map(_t, (x[:, :30], dt[:, :30], a, b_in[:, :30],
                                  c_in[:, :30])), chunk)


def test_segsum_and_gated_norm_match_reference():
    x = _normal(6, (3, 8))
    with reference_mode():
        want = np.asarray(ref_m2._segsum(jnp.asarray(x)))
    got = m2._segsum(_t(x)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    _close(np.where(np.isinf(got), 0, got), np.where(np.isinf(want), 0,
                                                       want))
    y, z, scale = _normal(7, (2, 5, 32)), _normal(8, (2, 5, 32)), \
        _normal(9, (32,))
    with reference_mode():
        want = ref_m2._gated_norm(*map(jnp.asarray, (y, z, scale)))
    _close(m2._gated_norm(*map(_t, (y, z, scale))).numpy(), want)


def test_mamba2_sequence_and_decode_match_reference():
    """``apply_mamba2`` over 16 positions (chunk 8), and the same input
    one token at a time through the decode recurrence: outputs and the
    (conv, ssm) cache after each step."""
    dims = ref_m2.Mamba2Dims(d_model=D, d_state=16, head_dim=32, chunk=8)
    pdims = m2.Mamba2Dims(d_model=D, d_state=16, head_dim=32, chunk=8)
    ref = _ref_params(ref_m2.init_mamba2, dims)
    port = _port(ref)
    x = _normal(10, (B, 16, D))
    with reference_mode():
        want, _ = ref_m2.apply_mamba2(jax.tree.map(jnp.asarray, ref), dims,
                                      jnp.asarray(x))
        cache = ref_m2.init_mamba_cache(dims, B, jnp.float32)
        step = jax.jit(ref_m2.apply_mamba2, static_argnums=1)
        steps = []
        for t in range(16):
            y, cache = step(jax.tree.map(jnp.asarray, ref), dims,
                            jnp.asarray(x[:, t:t + 1]), cache=cache)
            steps.append(np.asarray(y[:, 0]))
    got, none = m2.apply_mamba2(port, pdims, _t(x))
    assert none is None
    _close(got.numpy(), want)
    pc = m2.init_mamba_cache(pdims, B, torch.float32, "cpu")
    got_steps = []
    for t in range(16):
        y, pc = m2.apply_mamba2(port, pdims, _t(x[:, t:t + 1]), cache=pc)
        got_steps.append(y[:, 0].numpy())
    _close(np.stack(got_steps, 1), np.stack(steps, 1))
    _cache_close(pc, cache)
    # the recurrence computes the chunked scan's function (the
    # reference's own decode-vs-prefill bound)
    np.testing.assert_allclose(np.stack(got_steps, 1), got.numpy(),
                               atol=1e-4)


@pytest.mark.parametrize("length", [12, 64])
def test_mlstm_parallel_and_step_match_reference(length):
    """mLSTM's parallel form over the sequence, and its one-step form
    token by token (the (C, n, m) state and the conv window carried)."""
    dims = ref_xl.XLSTMDims(d_model=D, n_heads=2)
    pdims = xl.XLSTMDims(d_model=D, n_heads=2)
    ref = _ref_params(ref_xl.init_mlstm, dims)
    port = _port(ref)
    x = _normal(11, (B, length, D))
    with reference_mode():
        rp = jax.tree.map(jnp.asarray, ref)
        want, _ = ref_xl.apply_mlstm(rp, dims, jnp.asarray(x))
        cache = ref_xl.init_mlstm_cache(dims, B, jnp.float32)
        step = jax.jit(ref_xl.apply_mlstm, static_argnums=1)
        steps = []
        for t in range(length):
            y, cache = step(rp, dims, jnp.asarray(x[:, t:t + 1]),
                            cache=cache)
            steps.append(np.asarray(y[:, 0]))
    got, _ = xl.apply_mlstm(port, pdims, _t(x))
    _close(got.numpy(), want)
    pc = xl.init_mlstm_cache(pdims, B, torch.float32, "cpu")
    got_steps = []
    for t in range(length):
        y, pc = xl.apply_mlstm(port, pdims, _t(x[:, t:t + 1]), cache=pc)
        got_steps.append(y[:, 0].numpy())
    _close(np.stack(got_steps, 1), np.stack(steps, 1))
    _cache_close(pc, cache)


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_mlstm_chunked_matches_reference(chunk):
    """The chunked form (a loop carrying (C, n, m) across chunks)
    against the reference's chunked form, through ``apply_mlstm`` and
    directly."""
    dims = ref_xl.XLSTMDims(d_model=D, n_heads=2, chunk=chunk)
    pdims = xl.XLSTMDims(d_model=D, n_heads=2, chunk=chunk)
    ref = _ref_params(ref_xl.init_mlstm, dims)
    x = _normal(12, (B, 64, D))
    with reference_mode():
        want, _ = ref_xl.apply_mlstm(jax.tree.map(jnp.asarray, ref), dims,
                                     jnp.asarray(x))
    got, _ = xl.apply_mlstm(_port(ref), pdims, _t(x))
    _close(got.numpy(), want)
    q, k, v = (_normal(13 + i, (B, 64, 2, 16)) for i in range(3))
    log_i = _normal(16, (B, 64, 2))
    log_f = -np.log1p(np.exp(-_normal(17, (B, 64, 2))))
    with reference_mode():
        want = ref_xl._mlstm_chunked(*map(jnp.asarray,
                                          (q, k, v, log_i, log_f)), chunk)
    got = xl._mlstm_chunked(*map(_t, (q, k, v, log_i, log_f)), chunk)
    _close(got.numpy(), want)
    par, _ = xl._mlstm_parallel(*map(_t, (q, k, v, log_i, log_f)))
    np.testing.assert_allclose(got.numpy(), par.numpy(), atol=1e-4)


def test_slstm_scan_and_step_match_reference():
    """sLSTM over time (a Python loop here, ``lax.scan`` there) and
    step by step: the output and the (c, n, h, m) state."""
    dims = ref_xl.XLSTMDims(d_model=D, n_heads=4)
    pdims = xl.XLSTMDims(d_model=D, n_heads=4)
    ref = _ref_params(ref_xl.init_slstm, dims)
    port = _port(ref)
    x = _normal(18, (B, 12, D))
    with reference_mode():
        rp = jax.tree.map(jnp.asarray, ref)
        want, none = ref_xl.apply_slstm(rp, dims, jnp.asarray(x))
        cache = ref_xl.init_slstm_cache(dims, B, jnp.float32)
        step = jax.jit(ref_xl.apply_slstm, static_argnums=1)
        steps = []
        for t in range(12):
            y, cache = step(rp, dims, jnp.asarray(x[:, t:t + 1]),
                            cache=cache)
            steps.append(np.asarray(y[:, 0]))
    got, pnone = xl.apply_slstm(port, pdims, _t(x))
    assert none is None and pnone is None
    _close(got.numpy(), want)
    pc = xl.init_slstm_cache(pdims, B, torch.float32, "cpu")
    got_steps = []
    for t in range(12):
        y, pc = xl.apply_slstm(port, pdims, _t(x[:, t:t + 1]), cache=pc)
        got_steps.append(y[:, 0].numpy())
    _close(np.stack(got_steps, 1), np.stack(steps, 1))
    _cache_close(pc, cache)


def test_slstm_in_bf16_promotes_like_the_reference():
    """A bf16 activation through the float32 sLSTM block: the FFN runs
    in float32 (the reference's einsum promotion) and the output comes
    back in bf16."""
    pdims = xl.XLSTMDims(d_model=D, n_heads=4)
    port = _port(_ref_params(ref_xl.init_slstm, ref_xl.XLSTMDims(
        d_model=D, n_heads=4)))
    x = _t(_normal(19, (B, 5, D))).to(torch.bfloat16)
    y, _ = xl.apply_slstm(port, pdims, x)
    y32, _ = xl.apply_slstm(port, pdims, x.float())
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), y32, rtol=2e-2, atol=2e-2)


def test_block_inits_have_the_reference_trees():
    """Leaf names, shapes and dtypes of the port's inits (a bf16 model
    keeps the reference's float32 leaves: A_log, D, dt_bias, w_if, b_if
    and the whole sLSTM block)."""
    mdims = ref_m2.Mamba2Dims(d_model=D, d_state=16, head_dim=32)
    xdims = ref_xl.XLSTMDims(d_model=D, n_heads=4)
    g = torch.Generator().manual_seed(0)
    pairs = [
        (ref_m2.init_mamba2, mdims,
         m2.init_mamba2(g, m2.Mamba2Dims(**dataclasses.asdict(mdims)),
                        torch.bfloat16)),
        (ref_xl.init_mlstm, xdims,
         xl.init_mlstm(g, xl.XLSTMDims(**dataclasses.asdict(xdims)),
                       torch.bfloat16)),
        (ref_xl.init_slstm, xdims,
         xl.init_slstm(g, xl.XLSTMDims(**dataclasses.asdict(xdims)),
                       torch.bfloat16))]
    for init, dims, got in pairs:
        with reference_mode():
            want = init(jax.random.key(0), dims, jnp.bfloat16)
        assert set(got) == set(want)
        for k, w in want.items():
            assert tuple(got[k].shape) == w.shape, k
            assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k
    dt = torch.nn.functional.softplus(pairs[0][2]["dt_bias"])
    assert float(dt.min()) >= 1e-3 - 1e-7 and float(dt.max()) <= 0.1 + 1e-6
