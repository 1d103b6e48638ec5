"""The port's LM training path against the JAX package's, on the CPU.

``TokenPipeline`` batches bit for bit; ``lm_loss`` within rtol 1e-5 and
every gradient leaf within 1e-4 of that leaf's max |g| against
``jax.value_and_grad`` of the reference's ``lm_loss`` (gemma2-2b smoke:
softcaps, window, GQA, sandwich norms; granite smoke: gated MLP, no
softcap), float32; the gradient equal with remat "full", "dots" and off;
``make_train_step`` for 3 steps against the reference's (loss and
grad_norm rtol 1e-5; params: AdamW's bound in the test); ``main --device
cpu`` from the reference's own initial params against the reference's
``train_standard`` (losses rtol 1e-5); the port's ``--ckpt`` restored by
the reference's ``restore_checkpoint`` and the reference's by the port;
a full ``TrainState`` (params, stacked optimizer state, step) both ways;
and the default device raising without a GPU.
"""

import argparse
import dataclasses

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import restore_checkpoint as ref_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as ref_save  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke_variant as ref_smoke  # noqa: E402
from repro.data.lm_pipeline import TokenPipeline as RefPipeline  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.launch.mesh import make_host_mesh as ref_host_mesh  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.data.lm_pipeline import TokenPipeline  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from torch_parity import reference_mode  # noqa: E402

ARCHS = ["gemma2_2b", "granite_3_8b"]
B, S = 2, 24            # S > 16: the gemma2 smoke window bites
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4         # of each leaf's max |g|


def _pair(arch):
    return ref_smoke(ref_get_config(arch)), smoke_variant(get_config(arch))


def _ref_params(ref_cfg, seed=0):
    with reference_mode():
        return jax.tree.map(np.asarray, ref_tf.init_decoder_lm(
            ref_cfg, jax.random.key(seed)))


def _batch(vocab, seed=3, b=B, s=S):
    ref = next(RefPipeline(vocab, s, b, seed=seed).batches())
    port = next(TokenPipeline(vocab, s, b, seed=seed).batches())
    return ({"tokens": ref.tokens, "targets": ref.targets,
             "mask": ref.mask},
            {"tokens": port.tokens, "targets": port.targets,
             "mask": port.mask})


def _leaf_errs(got_tree, want_tree):
    """(path, max|got - want| / max|want|) of every reference leaf."""
    out = []
    for path, w in jax.tree_util.tree_flatten_with_path(want_tree)[0]:
        g = got_tree
        for k in path:
            g = g[k.key]
        w = np.asarray(w)
        out.append((jax.tree_util.keystr(path),
                    float(np.abs(g - w).max() / (np.abs(w).max() + 1e-30))))
    return out


@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (512, 24, 2, 3), (50, 7, 5, 0), (256_000, 16, 3, 9)])
def test_token_pipeline_bit_for_bit(vocab, seq, batch, seed):
    ref = RefPipeline(vocab, seq, batch, seed=seed).batches()
    port = TokenPipeline(vocab, seq, batch, seed=seed).batches()
    for _ in range(3):
        r, p = next(ref), next(port)
        for name in ("tokens", "targets", "mask"):
            got, want = getattr(p, name), np.asarray(getattr(r, name))
            assert got.dtype == {"tokens": torch.int32,
                                 "targets": torch.int32,
                                 "mask": torch.bool}[name]
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch):
    ref_cfg, cfg = _pair(arch)
    params = _ref_params(ref_cfg)
    ref_b, port_b = _batch(cfg.vocab_size)
    ref_b["mask"] = ref_b["mask"].at[1, -5:].set(False)
    port_b["mask"][1, -5:] = False
    with reference_mode():
        loss, grads = jax.value_and_grad(
            lambda p: ref_tf.lm_loss(ref_cfg, p, ref_b))(
            jax.tree.map(jnp.asarray, params))
    got_loss, got_grads = steps.value_and_grad(
        lambda p: tf.lm_loss(cfg, p, port_b),
        convert.decoder_lm_from_numpy(params))
    np.testing.assert_allclose(float(got_loss), float(loss),
                               rtol=LOSS_RTOL)
    errs = _leaf_errs(convert.decoder_lm_to_numpy(got_grads), grads)
    worst = max(errs, key=lambda e: e[1])
    assert worst[1] < GRAD_REL, worst


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_the_same_gradient(arch):
    ref_cfg, cfg = _pair(arch)
    params = convert.decoder_lm_from_numpy(_ref_params(ref_cfg))
    _, batch = _batch(cfg.vocab_size)
    out = {}
    for name, kw in (("off", dict(remat=False)),
                     ("full", dict(remat=True, remat_policy="full")),
                     ("dots", dict(remat=True, remat_policy="dots")),
                     ("none", dict(remat=True, remat_policy="none"))):
        c = dataclasses.replace(cfg, **kw)
        out[name] = steps.value_and_grad(
            lambda p: tf.lm_loss(c, p, batch), params)
    leaves = {k: torch.utils._pytree.tree_leaves(v) for k, v in out.items()}
    for name in ("full", "dots", "none"):
        for a, b in zip(leaves["off"], leaves[name]):
            assert torch.equal(a, b), name


def test_remat_full_recomputes_the_attention_forward(monkeypatch):
    """With remat ("full" or "dots") every layer's attention forward runs
    once more in the backward; without remat once."""
    ref_cfg, cfg = _pair("gemma2_2b")
    params = convert.decoder_lm_from_numpy(_ref_params(ref_cfg))
    _, batch = _batch(cfg.vocab_size)
    calls = []
    real = flash_ops._forward

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(flash_ops, "_forward", counted)
    for kw, want in ((dict(remat=False), 2),
                     (dict(remat=True, remat_policy="full"), 4),
                     (dict(remat=True, remat_policy="dots"), 4)):
        calls.clear()
        c = dataclasses.replace(cfg, **kw)
        steps.value_and_grad(lambda p: tf.lm_loss(c, p, batch), params)
        assert len(calls) == want, (kw, len(calls))


@pytest.mark.parametrize("causal,window,softcap,hkv,dtype", [
    (True, 5, 50.0, 2, torch.float32), (True, None, None, 4, torch.float32),
    (True, 3, None, 1, torch.float32), (False, None, 30.0, 2, torch.float32),
    (True, 6, 50.0, 2, torch.bfloat16)])
def test_attention_backward_matches_autograd_of_plain(causal, window,
                                                      softcap, hkv, dtype):
    """The wrapper's dQ/dK/dV against torch.autograd of the plain version
    (float32: 2e-5 of each tensor's max; bf16: the same float32
    arithmetic, so only the rounding of the results, 1e-2)."""
    rng = np.random.default_rng(4)
    b, s, h, d = 2, 11, 4, 16
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype) for shape in ((b, s, h, d), (b, s, hkv, d),
                                             (b, s, hkv, d), (b, s, h, d)))
    kw = dict(causal=causal, window=window, softcap=softcap, scale=0.3)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_ops.flash_attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, do)

    plain = [x.clone().float().requires_grad_() for x in (q, k, v)]

    def bh(x):
        return x.transpose(1, 2).reshape(-1, s, d)
    ref_out = flash_ref.attention_ref(*map(bh, plain), **kw)
    want = torch.autograd.grad(
        ref_out.reshape(b, h, s, d).transpose(1, 2), plain, do.float())
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    for g, w in zip(got, want):
        assert g.dtype == dtype
        err = (g.float() - w).abs().max() / w.abs().max()
        assert err < tol, float(err)


def test_make_train_step_matches_reference():
    ref_cfg, cfg = _pair("gemma2_2b")
    params = _ref_params(ref_cfg)
    ref_step, ref_opt = ref_steps.make_train_step(ref_cfg, 1e-2)
    step, opt = steps.make_train_step(cfg, 1e-2)
    with reference_mode():
        rp = jax.tree.map(jnp.asarray, params)
        rs = ref_steps.TrainState(rp, ref_opt.init(rp),
                                  jnp.zeros((), jnp.int32))
    pp = convert.decoder_lm_from_numpy(params)
    ps = steps.TrainState(pp, opt.init(pp), 0)
    ref_it = RefPipeline(cfg.vocab_size, S, B, seed=5).batches()
    port_it = TokenPipeline(cfg.vocab_size, S, B, seed=5).batches()
    for _ in range(3):
        r, p = next(ref_it), next(port_it)
        with reference_mode():
            rs, rm = ref_step(rs, r._asdict())
        ps, pm = step(ps, p._asdict())
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=LOSS_RTOL)
    assert ps.step == int(rs.step) == 3
    # AdamW moves an element by about lr whatever |g| is, so an element
    # whose gradient is ~0 in both packages (their float32 sums differ in
    # the last bits) may move differently: every element within a tenth
    # of the summed lr, and at most 1e-4 of a leaf's elements beyond 1e-6
    lr_sum = sum(float(ref_opt_lr(t)) for t in range(3))
    got = convert.decoder_lm_to_numpy(ps.params)
    for path, w in jax.tree_util.tree_flatten_with_path(rs.params)[0]:
        g = got
        for k in path:
            g = g[k.key]
        d = np.abs(g - np.asarray(w))
        name = jax.tree_util.keystr(path)
        assert d.max() < 0.1 * lr_sum, (name, d.max())
        assert (d > 1e-6).mean() <= 1e-4, (name, (d > 1e-6).sum())


def ref_opt_lr(step):
    from repro.optim import make_lr_schedule as ref_schedule
    return ref_schedule("cosine", 1e-2)(jnp.asarray(step, jnp.int32))


def _ref_args(tmp, **kw):
    a = dict(arch="granite_3_8b", steps=3, batch=2, seq=16, lr=1e-2,
             seed=0, log_every=5, ckpt=None, full=False)
    a.update(kw)
    return argparse.Namespace(**a)


@pytest.fixture(scope="module")
def standard_runs(tmp_path_factory):
    """The reference's train_standard, and the port's main from the
    reference's initial params, both saving --ckpt."""
    tmp = tmp_path_factory.mktemp("train")
    ref_cfg = ref_smoke(ref_get_config("granite_3_8b"))
    ref_ckpt, port_ckpt, init = (str(tmp / n) for n in ("ref", "port",
                                                        "init"))
    with reference_mode():
        ref_save(init, ref_tf.init_decoder_lm(ref_cfg, jax.random.key(0)),
                 0)
        ref_losses = ref_train.train_standard(
            ref_cfg, _ref_args(tmp, ckpt=ref_ckpt), ref_host_mesh())
    log = train.main(["--device", "cpu", "--arch", "granite_3_8b",
                      "--steps", "3", "--batch", "2",
                      "--seq", "16", "--lr", "1e-2", "--init-from", init,
                      "--ckpt", port_ckpt])
    return dict(ref_losses=ref_losses, log=log, ref_ckpt=ref_ckpt,
                port_ckpt=port_ckpt, ref_cfg=ref_cfg)


def test_main_standard_matches_reference_train_standard(standard_runs):
    log = standard_runs["log"]
    np.testing.assert_allclose(log.losses, standard_runs["ref_losses"],
                               rtol=LOSS_RTOL)
    assert all(np.isfinite(log.grad_norms)) and len(log.step_seconds) == 3


def test_checkpoints_restore_both_ways(standard_runs):
    ref_cfg = standard_runs["ref_cfg"]
    cfg = smoke_variant(get_config("granite_3_8b"))
    port_final = standard_runs["log"].state.params
    with reference_mode():
        like = ref_tf.init_decoder_lm(ref_cfg, jax.random.key(1))
    # the port's --ckpt through the reference's restore
    got = ref_restore(standard_runs["port_ckpt"], like)
    for path, x in jax.tree_util.tree_flatten_with_path(
            convert.decoder_lm_to_numpy(port_final))[0]:
        y = got
        for k in path:
            y = y[k.key]
        np.testing.assert_array_equal(np.asarray(y), x)
    # the reference's --ckpt through the port's restore
    ref_final = ref_restore(standard_runs["ref_ckpt"], like)
    port = train.load_params(standard_runs["ref_ckpt"], cfg, "cpu")
    errs = _leaf_errs(convert.decoder_lm_to_numpy(port),
                      jax.tree.map(np.asarray, ref_final))
    assert max(e for _, e in errs) == 0.0
    with pytest.raises(ValueError, match="do not fit"):
        train.load_params(standard_runs["ref_ckpt"],
                          dataclasses.replace(cfg, n_layers=3), "cpu")


def test_bf16_params_and_train_state_both_ways(tmp_path):
    """bf16 leaves in the reference's uint16 layout, and a TrainState with
    its stacked optimizer state, through each package's checkpoint."""
    ref_cfg = dataclasses.replace(ref_smoke(ref_get_config("gemma2_2b")),
                                  dtype="bfloat16")
    cfg = dataclasses.replace(smoke_variant(get_config("gemma2_2b")),
                              dtype="bfloat16")
    with reference_mode():
        rp = ref_tf.init_decoder_lm(ref_cfg, jax.random.key(0))
    params = convert.decoder_lm_from_numpy(jax.tree.map(np.asarray, rp))
    assert params["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    _, batch = _batch(cfg.vocab_size)
    step, opt = steps.make_train_step(cfg, 1e-2)
    state, _ = step(steps.TrainState(params, opt.init(params), 0), batch)
    save_checkpoint(str(tmp_path / "p"), convert.lm_train_state_to_numpy(
        state), 1)
    with reference_mode():
        _, ref_opt = ref_steps.make_train_step(ref_cfg, 1e-2)
        like = ref_steps.TrainState(rp, ref_opt.init(rp),
                                    jnp.zeros((), jnp.int32))
    got = ref_restore(str(tmp_path / "p"), like)
    assert int(got.step) == 1
    want = convert.decoder_lm_to_numpy(state.params)
    np.testing.assert_array_equal(
        np.asarray(got.params["layers"]["mlp"]["w_up"]).view(np.uint16),
        want["layers"]["mlp"]["w_up"].view(np.uint16))
    np.testing.assert_array_equal(np.asarray(got.opt["v"]["embed"]["table"]),
                                  state.opt["v"]["embed"]["table"].numpy())
    # and back: the reference's save of that state, restored by the port
    ref_save(str(tmp_path / "r"), got, 1)
    from repro_torch.checkpoint import restore_checkpoint, stored_shapes
    flat = restore_checkpoint(str(tmp_path / "r"),
                              stored_shapes(str(tmp_path / "r")))
    back = convert.lm_train_state_from_numpy(flat)
    assert back.step == 1
    _assert_same_tree(back.params["layers"][1], state.params["layers"][1])
    _assert_same_tree(back.params["embed"], state.params["embed"])
    _assert_same_tree(back.opt, state.opt)


def _assert_same_tree(a, b):
    """Equal keys, dtypes and bits, whatever the key order."""
    assert isinstance(a, dict) == isinstance(b, dict)
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_same_tree(a[k], b[k])
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_prefill_and_decode_steps():
    ref_cfg, cfg = _pair("gemma2_2b")
    params = convert.decoder_lm_from_numpy(_ref_params(ref_cfg))
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, 6)).astype(np.int32))
    last = steps.make_prefill_step(cfg)(params, {"tokens": tokens})
    decode = steps.make_decode_step(cfg)
    caches = tf.init_caches(cfg, B, 6, "cpu")
    for i in range(6):
        logits, caches = decode(params, {"tokens": tokens[:, i:i + 1],
                                         "caches": caches, "index": i})
    assert last.shape == logits.shape == (B, cfg.vocab_size)
    rel = (logits - last).abs().max() / last.abs().max()
    assert rel < 2e-3, float(rel)


def test_main_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--steps", "1"])
