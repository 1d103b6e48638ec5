"""The port's MoE block (``repro_torch.models.moe``) against the JAX
package's, on the CPU.

The reference's parameters are carried across as numpy, the same seeded
inputs go through both ``apply_moe``s, in float32: the output within
rtol 1e-5 (atol 1e-5 of an O(1) output: the products sum 16-64 terms in
another order), the aux loss and the router entropy within 1e-6, for
both dispatches (``ragged``, ``capacity``), with kimi's shared expert
and arctic's dense residual. Capacity equals ragged when no expert
overflows, and stays finite (dropped slots give 0) when one does.
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from torch_parity import reference_mode  # noqa: E402

D, E, FF, K = 16, 4, 32, 2


def _params(shared=0, dense=0, seed=0, n_experts=E, top_k=K):
    with reference_mode():
        ref = ref_moe.init_moe(jax.random.key(seed), D, n_experts, FF, top_k,
                               jnp.float32, shared_d_ff=shared,
                               dense_d_ff=dense)
    ref = jax.tree.map(np.asarray, ref)
    port = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), ref)
    return ref, port


def _x(b, s, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, D), dtype=np.float32)


def _both(ref, port, x, impl, top_k=K, capacity_factor=1.25):
    with reference_mode():
        want = ref_moe.apply_moe(jax.tree.map(jnp.asarray, ref),
                                 jnp.asarray(x), top_k, impl=impl,
                                 capacity_factor=capacity_factor)
    got = moe.apply_moe(port, torch.from_numpy(x), top_k, impl=impl,
                        capacity_factor=capacity_factor)
    return want, got


@pytest.mark.parametrize("branches", [(0, 0), (FF, 0), (0, FF)],
                         ids=["plain", "shared", "dense"])
@pytest.mark.parametrize("impl", ["ragged", "capacity"])
def test_apply_moe_matches_reference(impl, branches):
    ref, port = _params(*branches)
    want, got = _both(ref, port, _x(2, 8), impl)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss),
                               rtol=1e-6)
    np.testing.assert_allclose(float(got.router_entropy),
                               float(want.router_entropy), rtol=1e-6)
    assert got.y.dtype == torch.float32 and got.aux_loss.dtype == \
        torch.float32


def test_capacity_equals_ragged_without_overflow():
    """At capacity factor E / k every expert has room for every token:
    no slot is dropped, and the two dispatches agree."""
    _, port = _params()
    x = torch.from_numpy(_x(2, 8, seed=3))
    ragged = moe.apply_moe(port, x, K, impl="ragged")
    cap = moe.apply_moe(port, x, K, impl="capacity",
                        capacity_factor=E / K)
    assert moe.capacity(16, K, E, E / K) >= 16
    torch.testing.assert_close(cap.y, ragged.y, rtol=1e-5, atol=1e-6)
    assert float(cap.aux_loss) == float(ragged.aux_loss)


def test_capacity_overflow_is_finite_and_matches_reference():
    """A router that sends every token to experts 0 and 1 overflows
    their 40 slots: the dropped slots give 0, the output stays finite,
    and the port drops the same slots as the reference (the stable sort
    keeps the lowest token indices)."""
    ref, port = _params()
    ref = dict(ref, router=np.zeros_like(ref["router"]))
    ref["router"][:, 0], ref["router"][:, 1] = 5.0, 2.0
    port = dict(port, router=torch.from_numpy(ref["router"]))
    x = np.abs(_x(4, 16, seed=4))          # positive: experts 0, 1 win
    want, got = _both(ref, port, x, "capacity")
    assert moe.capacity(64, K, E, 1.25) < 64
    assert bool(torch.isfinite(got.y).all())
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y),
                               rtol=1e-5, atol=1e-5)
    ragged = moe.apply_moe(port, torch.from_numpy(x), K, impl="ragged")
    assert not torch.allclose(ragged.y, got.y)


def test_aux_loss_of_a_uniform_router_is_one():
    """The reference test's check: a zero router gives uniform
    probabilities and an aux loss near 1; the entropy is log E."""
    _, port = _params()
    port = dict(port, router=torch.zeros_like(port["router"]))
    x = torch.from_numpy(_x(4, 64, seed=5))
    out = moe.apply_moe(port, x, K)
    assert 0.9 < float(out.aux_loss) < 1.1
    assert abs(float(out.router_entropy) - np.log(E)) < 1e-5


def test_init_moe_tree_and_laws():
    """The port's init has the reference's leaves, shapes and dtypes
    (the router float32 in a bf16 model), each expert drawn at the
    truncated normal's law."""
    ref, _ = _params(shared=FF, dense=FF)
    got = moe.init_moe(torch.Generator().manual_seed(0), D, E, FF, K,
                       torch.bfloat16, shared_d_ff=FF, dense_d_ff=FF)
    assert jax.tree.structure(jax.tree.map(lambda a: 0, ref)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, got))
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        keys = [p.key for p in path]
        t = got
        for k in keys:
            t = t[k]
        assert tuple(t.shape) == leaf.shape, keys
        assert t.dtype == (torch.float32 if keys == ["router"]
                           else torch.bfloat16), keys
    w = got["w_gate"].float()
    assert float(w.abs().max()) <= 2.0 / D ** 0.5
    assert not torch.equal(w[0], w[1])


@pytest.mark.parametrize("impl", ["ragged", "capacity"])
def test_topk_8_of_32_matches_reference(impl):
    """kimi's routing shape cut down: top-8 of 32 experts."""
    ref, port = _params(shared=FF, seed=2, n_experts=32, top_k=8)
    want, got = _both(ref, port, _x(2, 4, seed=6), impl, top_k=8)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss),
                               rtol=1e-6)
