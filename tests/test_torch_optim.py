"""The port's optimizers and LR schedules against the JAX package's.

Schedules at every step 0..1,200 (float32, rtol 1e-6). ``sgd``, ``adamw``
and ``adafactor`` take 3 updates of a converted smoke param tree
(gemma2-2b's: sandwich norms give stacked ``[L, d]`` scales) from the
same seeded numpy gradients: new params and state within rtol 1e-6 /
atol 1e-7 of the reference's. A per-layer Adafactor (each layer its own
tree) is shown to miss that bound, so the test sees the stacked view.
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke_variant as ref_smoke  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.optim import make_lr_schedule as ref_schedule  # noqa: E402
from repro.optim import make_optimizer as ref_make_optimizer  # noqa: E402
from repro_torch.convert import decoder_lm_from_numpy, decoder_lm_to_numpy  # noqa: E402
from repro_torch.optim import make_lr_schedule, make_optimizer  # noqa: E402
from torch_parity import reference_mode  # noqa: E402

RTOL, ATOL = 1e-6, 1e-7
STEPS = 3


@pytest.mark.parametrize("kind,kw", [
    ("constant", dict(peak=3e-4)),
    ("cosine", dict(peak=3e-4, warmup=100, total=1000)),
    ("cosine", dict(peak=1e-3, warmup=0, total=1)),
    ("rsqrt", dict(peak=1e-3, warmup=100)),
    ("rsqrt", dict(peak=1e-3, warmup=0))])
def test_schedules_match_reference(kind, kw):
    ref, port = ref_schedule(kind, **kw), make_lr_schedule(kind, **kw)
    steps = np.arange(1201, dtype=np.int32)
    want = np.asarray(jax.vmap(ref)(jnp.asarray(steps)))
    got = np.array([float(port(int(s))) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert float(port(torch.tensor(7))) == float(port(7))


def test_unknown_schedule_and_optimizer_raise():
    with pytest.raises(ValueError, match="lr schedule"):
        make_lr_schedule("linear", 1e-3)
    with pytest.raises(ValueError, match="optimizer"):
        make_optimizer("lion", make_lr_schedule("constant", 1e-3))


@pytest.fixture(scope="module")
def tree():
    """Reference params of gemma2-2b's smoke variant, and 3 gradients."""
    cfg = ref_smoke(ref_get_config("gemma2_2b"))
    with reference_mode():
        params = jax.tree.map(np.asarray,
                              ref_tf.init_decoder_lm(cfg, jax.random.key(0)))
    rng = np.random.default_rng(11)
    grads = [jax.tree.map(
        lambda x: (rng.standard_normal(x.shape) * 10.0 ** rng.integers(
            -3, 1)).astype(np.float32), params) for _ in range(STEPS)]
    # a few exact zeros: the eps paths
    grads[0]["final_norm"]["scale"][:3] = 0.0
    return params, grads


def _ref_run(kind, params, grads):
    opt = ref_make_optimizer(kind, ref_schedule("cosine", 1e-2, warmup=2,
                                                total=10))
    p = jax.tree.map(jnp.asarray, params)
    state = opt.init(p)
    for t, g in enumerate(grads):
        p, state = opt.update(jax.tree.map(jnp.asarray, g), state, p,
                              jnp.asarray(t, jnp.int32))
    return jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, state)


def _port_run(kind, params, grads):
    opt = make_optimizer(kind, make_lr_schedule("cosine", 1e-2, warmup=2,
                                                total=10))
    p = decoder_lm_from_numpy(params)
    state = opt.init(p)
    for t, g in enumerate(grads):
        p, state = opt.update(decoder_lm_from_numpy(g), state, p, t)
    return p, state


def _assert_tree_close(got, want, rtol=RTOL, atol=ATOL):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, w in flat_w:
        g = got
        for k in path:
            g = g[k.key]
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("kind", ["sgd", "adamw", "adafactor"])
def test_optimizer_updates_match_reference(tree, kind):
    params, grads = tree
    want_p, want_s = _ref_run(kind, params, grads)
    got_p, got_s = _port_run(kind, params, grads)
    _assert_tree_close(decoder_lm_to_numpy(got_p), want_p)
    _assert_tree_close(got_s, want_s)       # the state is held stacked
    if kind == "adafactor":
        vr = got_s["layers"]["ln1"]["scale"]["vr"]
        vc = got_s["layers"]["ln1"]["scale"]["vc"]
        assert tuple(vr.shape) == (2,) and tuple(vc.shape) == (256,)


def test_adafactor_per_layer_misses_the_bound(tree):
    """Each layer as a tree of its own factors a [d] scale as a vector
    and clips layer by layer: not the reference's update."""
    params, grads = tree
    want_p, _ = _ref_run("adafactor", params, grads)
    opt = make_optimizer("adafactor", make_lr_schedule("cosine", 1e-2,
                                                       warmup=2, total=10))
    port = decoder_lm_from_numpy(params)
    layers = {str(i): lp for i, lp in enumerate(port["layers"])}
    states = {}
    for t, g in enumerate(grads):
        gl = decoder_lm_from_numpy(g)["layers"]
        for i, lp in layers.items():
            if i not in states:
                states[i] = opt.init(lp)
            opt.update(gl[int(i)], states[i], lp, t)
    got = decoder_lm_to_numpy(port)
    with pytest.raises(AssertionError):
        _assert_tree_close(got, want_p)


def test_adamw_chunks_equal_one_pass(tree, monkeypatch):
    """The elementwise update in chunks gives the one-pass bits."""
    from repro_torch.optim import optimizers

    params, grads = tree
    whole_p, whole_s = _port_run("adamw", params, grads)
    monkeypatch.setattr(optimizers, "CHUNK", 1000)
    chunk_p, chunk_s = _port_run("adamw", params, grads)
    for a, b in zip(torch.utils._pytree.tree_leaves((whole_p, whole_s)),
                    torch.utils._pytree.tree_leaves((chunk_p, chunk_s))):
        assert torch.equal(a, b)


def test_bf16_params_round_once(tree):
    """A bf16 leaf's new value is the float32 update rounded once."""
    params, grads = tree
    opt = make_optimizer("sgd", make_lr_schedule("constant", 1e-2))
    p32 = decoder_lm_from_numpy(params)
    p16 = {k: v for k, v in decoder_lm_from_numpy(params).items()}
    p16["embed"] = {"table": p32["embed"]["table"].to(torch.bfloat16)}
    g = decoder_lm_from_numpy(grads[0])
    s = opt.init(p16)
    opt.update(g, s, p16, 0)
    want = (p32["embed"]["table"].to(torch.bfloat16).float()
            - 1e-2 * g["embed"]["table"]).to(torch.bfloat16)
    assert p16["embed"]["table"].dtype == torch.bfloat16
    assert torch.equal(p16["embed"]["table"], want)
    assert s["mu"]["embed"]["table"].dtype == torch.float32
