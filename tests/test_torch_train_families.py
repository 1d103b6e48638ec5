"""Every LM family's training step in the port against the JAX package's,
on the CPU.

For each arch of ``list_archs()`` at its smoke variant (float32), the
reference's parameters carried across with the converter and the same
numpy inputs in the shapes of the reference's
``tests/test_models_smoke.py::_batch`` (B=2, S=16; pixtral's image
embeddings, whisper's 16 stub frames; a masked tail):

- ``steps.loss_fn`` (``encdec_loss`` for whisper) within ``LOSS_RTOL``
  and every gradient leaf within ``GRAD_REL`` of that leaf's max |g|
  against ``jax.value_and_grad`` of the reference's ``loss_fn`` (a key
  bias without RoPE, whose gradient the softmax cancels, below 1e-6 of
  the largest gradient on both sides); the ssm family's idle-block slices zero on
  both sides; whisper's encoder gets its gradient through the
  cross-attention;
- one ``make_train_step`` against the reference's under ``jax.jit``:
  loss within ``LOSS_RTOL``, ``grad_norm`` within 1e-4 relative, and
  the parameters within AdamW's bound (``tests/test_torch_train.py``)
  or Adafactor's where the gradient test fixes the gradient, and within
  twice the lr where it is rounding noise (argued at
  ``_assert_params_close``);
- xlstm's idle-block leaves after the step equal the reference's
  weight-decay-only update within 1e-6 relative, and moved;
- Adafactor in pieces of one matrix (``CHUNK`` cut) within the same
  bound; remat "full" gives each family the gradient of remat off, bit
  for bit; the MoE block (both dispatches), the chunked SSD scan, the
  chunked mLSTM and the sLSTM loop under autograd against
  ``jax.grad`` of the reference's; the prefill and decode steps of a
  vlm and an encoder-decoder; a trained TrainState of three families
  through the reference's restore; ``sync_tree_sim`` over 4 nodes of
  xlstm's and whisper's trees bit for bit.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro.checkpoint import restore_checkpoint as ref_restore  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke_variant as ref_smoke  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import encdec as ref_ed  # noqa: E402
from repro.models import mamba2 as ref_m2  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.models import xlstm as ref_xl  # noqa: E402
from repro.optim import make_lr_schedule as ref_schedule  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.configs import get_config, list_archs, smoke_variant  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import encdec as ed  # noqa: E402
from repro_torch.models import mamba2 as m2  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models import xlstm as xl  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from torch_parity import reference_mode  # noqa: E402

B, S, FRAMES = 2, 16, 16       # the reference smoke test's _batch
LR = 1e-2
LOSS_RTOL = 1e-5               # tests/test_torch_train.py
GRAD_REL = 1e-4                # of each leaf's max |g|
NORM_RTOL = 1e-4


def _pair(arch):
    return ref_smoke(ref_get_config(arch)), smoke_variant(get_config(arch))


def _ref_params(ref_cfg, seed=0):
    init = (ref_ed.init_encdec if ref_cfg.family == "encdec"
            else ref_tf.init_decoder_lm)
    with reference_mode():
        return jax.tree.map(np.asarray, init(ref_cfg, jax.random.key(seed)))


def _np_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), bool)
    mask[1, -3:] = False
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, 1),
             "mask": mask}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model), dtype=np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((B, FRAMES, cfg.d_model),
                                              dtype=np.float32)
    return batch


def _get(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _leaves(tree):
    return [(jax.tree_util.keystr(p), p, np.asarray(w))
            for p, w in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _ref_lr_sum(steps_taken):
    sched = ref_schedule("cosine", LR)
    return sum(float(sched(jnp.asarray(t, jnp.int32)))
               for t in range(steps_taken))


def _noise_leaf(cfg, name) -> bool:
    """A leaf whose gradient is zero but for rounding: without RoPE a
    key bias adds q.b to every score of a row, which the softmax
    cancels."""
    return cfg.family == "encdec" and name.endswith("['bk']")


def _adafactor_scale(g):
    """The reference's first-step Adafactor denominator of each element,
    ``sqrt(r_i c_j / mean r)`` over a leaf's last two axes (``|g|`` for a
    vector), in float64."""
    g = np.asarray(g, np.float64)
    if g.ndim < 2:
        return np.abs(g)
    g2 = g * g + 1e-30
    vr, vc = g2.mean(-1), g2.mean(-2)
    return np.sqrt(vr[..., None] * vc[..., None, :]
                   / vr.mean(-1)[..., None, None])


def _assert_params_close(cfg, got, want, grads, lr):
    """The parameters after one step, element by element, held against
    the reference's gradient ``grads``; the weight decay is the same on
    both sides. Both optimizers normalise the gradient, so no element
    moves by more than about lr in either package: within twice the lr,
    every element (a leaf that is rounding noise, ``_noise_leaf``, gets
    only this). AdamW: where ``|g|`` is at least ``GRAD_REL`` of the
    leaf's max, the gradient test fixes its sign, so AdamW's bound
    holds there (``tests/test_torch_train.py``: within a tenth of the
    lr, at most 1e-4 of a leaf's elements beyond 1e-6). Adafactor's
    first update is ``g_ij / scale_ij`` (``_adafactor_scale``), clipped
    by its RMS: a gradient error ``delta`` (at most ``GRAD_REL`` of the
    leaf's max |g|) moves it by ``delta / scale_ij`` directly and by as
    much again through each of the two factors (means of g^2), so
    within ``4 * lr * delta / scale_ij`` (at most 3.3 of it seen at
    smoke width)."""
    for name, path, w in _leaves(want):
        d = np.abs(_get(got, path) - w)
        g = np.asarray(_get(grads, path))
        assert d.max() <= 2 * lr, (name, d.max())
        if _noise_leaf(cfg, name):
            continue
        delta = GRAD_REL * np.abs(g).max()
        if cfg.optimizer == "adafactor":
            over = d / (lr * delta / (_adafactor_scale(g) + 1e-30))
            assert over.max() <= 4, (name, over.max())
            continue
        d = d[np.abs(g) >= delta]
        if d.size:
            assert d.max() < 0.1 * lr, (name, d.max())
            assert (d > 1e-6).mean() <= 1e-4, (name, (d > 1e-6).sum())


@pytest.fixture(scope="module", params=list_archs())
def stepped(request):
    """One arch: the reference's loss and gradients, its jitted train
    step, and the port's of both, from the same params and batch."""
    arch = request.param
    ref_cfg, cfg = _pair(arch)
    params = _ref_params(ref_cfg)
    batch = _np_batch(cfg)
    ref_step, ref_opt = ref_steps.make_train_step(ref_cfg, LR)
    with reference_mode():
        rp = jax.tree.map(jnp.asarray, params)
        rb = {k: jnp.asarray(v) for k, v in batch.items()}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: ref_steps.loss_fn(ref_cfg, p, rb)))(rp)
        rs = ref_steps.TrainState(rp, ref_opt.init(rp),
                                  jnp.zeros((), jnp.int32))
        rs, rm = jax.jit(ref_step)(rs, rb)
    pb = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    pp = convert.decoder_lm_from_numpy(params)
    got_loss, got_grads = steps.value_and_grad(
        lambda p: steps.loss_fn(cfg, p, pb), pp)
    step, opt = steps.make_train_step(cfg, LR)
    state, metrics = step(steps.TrainState(pp, opt.init(pp), 0), pb)
    return dict(arch=arch, cfg=cfg, params0=params,
                ref=dict(loss=float(loss), grads=grads, state=rs,
                         metrics=rm),
                port=dict(loss=float(got_loss),
                          grads=convert.decoder_lm_to_numpy(got_grads),
                          state=state, metrics=metrics))


def test_loss_and_grads_match_reference(stepped):
    ref, port, cfg = stepped["ref"], stepped["port"], stepped["cfg"]
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=LOSS_RTOL)
    n_zero = 0
    top = max(np.abs(w).max() for _, _, w in _leaves(ref["grads"]))
    for name, path, w in _leaves(ref["grads"]):
        g = _get(port["grads"], path)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if _noise_leaf(cfg, name):
            assert max(np.abs(g).max(), np.abs(w).max()) < 1e-6 * top, name
            continue
        scale = np.abs(w).max()
        if scale == 0:
            n_zero += 1
            assert not np.any(g), name
            continue
        err = np.abs(g - w).max() / scale
        assert err < GRAD_REL, (name, err)
    # the ssm family's idle blocks are slices of the reference's
    # stacked leaves, which the other layers' blocks make non-zero
    # (test_xlstm_idle_block_takes_weight_decay_only reads the slices)
    assert n_zero == 0
    if cfg.family == "encdec":
        for name in ("wq", "wk", "wv", "wo"):
            assert np.abs(port["grads"]["encoder"]["attn"][name]).max() > 0


def test_train_step_matches_reference(stepped):
    ref, port, cfg = stepped["ref"], stepped["port"], stepped["cfg"]
    np.testing.assert_allclose(float(port["metrics"]["loss"]),
                               float(ref["metrics"]["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(port["metrics"]["grad_norm"]),
                               float(ref["metrics"]["grad_norm"]),
                               rtol=NORM_RTOL)
    assert port["state"].step == int(ref["state"].step) == 1
    _assert_params_close(cfg, convert.decoder_lm_to_numpy(
        port["state"].params), ref["state"].params, ref["grads"],
        _ref_lr_sum(1))


def _idle_blocks(cfg):
    """(layer, block) of each layer's idle block in the ssm family."""
    return [(i, "mlstm" if tf._is_slstm(cfg, i) else "slstm")
            for i in range(cfg.n_layers)]


@pytest.mark.parametrize("stepped", ["xlstm_125m"], indirect=True)
def test_xlstm_idle_block_takes_weight_decay_only(stepped):
    """The idle block's leaves: zero gradient, so AdamW's m = v = 0 and
    the update is ``p - lr * wd * p``; the port's within 1e-6 relative
    of the reference's, and moved (a skipped update fails)."""
    cfg, ref, port = stepped["cfg"], stepped["ref"], stepped["port"]
    lr0 = _ref_lr_sum(1)
    want_p, got_p = ref["state"].params["layers"], \
        port["state"].params["layers"]
    idle = _idle_blocks(cfg)
    assert {b for _, b in idle} == {"mlstm", "slstm"}
    for i, block in idle:
        for name, p0 in stepped["params0"]["layers"][block].items():
            assert not np.asarray(ref["grads"]["layers"][block][name])[i].any()
            assert not port["grads"]["layers"][block][name][i].any()
            w = np.asarray(want_p[block][name])[i]
            g = got_p[i][block][name].numpy()
            scale = np.abs(w).max()
            assert np.abs(g - w).max() <= 1e-6 * scale, (i, block, name)
            decayed = p0[i] - lr0 * 0.1 * p0[i]
            assert np.abs(g - decayed).max() <= 1e-6 * scale, (block, name)
            if np.abs(p0[i]).max() > 0:
                assert not np.array_equal(g, p0[i]), (i, block, name)
            assert not port["state"].opt["m"]["layers"][block][name][i].any()


def test_adafactor_in_pieces_matches_reference(monkeypatch):
    """kimi's smoke step with ``CHUNK`` below one expert matrix, so each
    expert leaf is updated a matrix at a time in two passes: the same
    bound against the reference's step."""
    ref_cfg, cfg = _pair("kimi_k2_1t_a32b")
    assert cfg.optimizer == "adafactor"
    params = _ref_params(ref_cfg)
    batch = _np_batch(cfg, seed=4)
    ref_step, ref_opt = ref_steps.make_train_step(ref_cfg, LR)
    with reference_mode():
        rp = jax.tree.map(jnp.asarray, params)
        rb = {k: jnp.asarray(v) for k, v in batch.items()}
        grads = jax.jit(jax.grad(
            lambda p: ref_steps.loss_fn(ref_cfg, p, rb)))(rp)
        rs = ref_steps.TrainState(rp, ref_opt.init(rp),
                                  jnp.zeros((), jnp.int32))
        rs, _ = jax.jit(ref_step)(rs, rb)
    pieces = []
    real = optimizers._matrix_pieces

    def counted(*a):
        for piece in real(*a):
            pieces.append(tuple(piece[0].shape))
            yield piece

    monkeypatch.setattr(optimizers, "CHUNK", 1000)
    monkeypatch.setattr(optimizers, "_matrix_pieces", counted)
    pp = convert.decoder_lm_from_numpy(params)
    step, opt = steps.make_train_step(cfg, LR)
    state, _ = step(steps.TrainState(pp, opt.init(pp), 0),
                    {k: torch.from_numpy(v.copy()) for k, v in batch.items()})
    # a matrix past CHUNK is a piece of its own; each MoE layer's three
    # expert leaves are n_experts pieces, listed once for the two passes,
    # and past CHUNK, so the second pass computes each update again
    assert all(m == 1 for m, r, c in pieces if r * c > 1000)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    d, f = cfg.d_model, cfg.moe_d_ff
    assert (pieces.count((1, d, f)) + pieces.count((1, f, d))
            >= 3 * cfg.n_experts * n_moe)
    assert cfg.n_experts * d * f > 1000
    _assert_params_close(cfg, convert.decoder_lm_to_numpy(state.params),
                         rs.params, grads, _ref_lr_sum(1))


@pytest.mark.parametrize("arch", ["kimi_k2_1t_a32b", "arctic_480b",
                                  "zamba2_2p7b", "xlstm_125m",
                                  "pixtral_12b", "whisper_small"])
def test_remat_full_gives_the_gradient_of_remat_off(arch):
    ref_cfg, cfg = _pair(arch)
    params = convert.decoder_lm_from_numpy(_ref_params(ref_cfg))
    batch = {k: torch.from_numpy(v.copy())
             for k, v in _np_batch(cfg).items()}
    out = {}
    for name, kw in (("off", dict(remat=False)),
                     ("full", dict(remat=True, remat_policy="full")),
                     ("dots", dict(remat=True, remat_policy="dots"))):
        c = dataclasses.replace(cfg, **kw)
        out[name] = pytree.tree_leaves(steps.value_and_grad(
            lambda p: steps.loss_fn(c, p, batch), params))
    for name in ("full", "dots"):
        for a, b in zip(out["off"], out[name]):
            assert torch.equal(a, b), (arch, name)


# ---------------------------------------------------------------------------
# The families' blocks under autograd
# ---------------------------------------------------------------------------

def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def _grads_close(got: dict, want: dict, rel=GRAD_REL):
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].detach().numpy() if torch.is_tensor(got[k]) else got[k]
        scale = np.abs(w).max()
        assert scale > 0, k
        assert np.abs(g - w).max() / scale < rel, (k, np.abs(g - w).max()
                                                   / scale)


def _port_grads(fn, inputs: dict) -> dict:
    live = {k: torch.from_numpy(np.array(v)).requires_grad_()
            for k, v in inputs.items()}
    got = torch.autograd.grad(fn(live), list(live.values()))
    return dict(zip(live, got))


def _ref_grads(fn, inputs: dict) -> dict:
    with reference_mode():
        return jax.jit(jax.grad(fn))({k: jnp.asarray(v)
                                      for k, v in inputs.items()})


def _flat(tree, prefix=""):
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{key}/"))
        else:
            out[prefix + key] = v
    return out


@pytest.mark.parametrize("impl", ["ragged", "capacity"])
def test_apply_moe_gradient_matches_reference(impl):
    """Through the router softmax, the top-k renormalisation, both
    dispatches (capacity drops tokens at factor 0.5) and the aux loss."""
    d, e, ff, k = 16, 4, 32, 2
    with reference_mode():
        p = jax.tree.map(np.asarray, ref_moe.init_moe(
            jax.random.key(3), d, e, ff, k, jnp.float32, shared_d_ff=ff))
    inputs = {"x": _normal(1, (2, 8, d)),
              **{f"p/{n}": v for n, v in _flat(p).items()}}
    r = _normal(2, (2, 8, d))

    def split(tree):
        out = {}
        for key, v in tree.items():
            if key.startswith("p/"):
                node = out
                *head, last = key[2:].split("/")
                for h in head:
                    node = node.setdefault(h, {})
                node[last] = v
        return out

    def port_loss(t):
        o = moe.apply_moe(split(t), t["x"], k, impl=impl,
                          capacity_factor=0.5)
        return (o.y * torch.from_numpy(r)).sum() + 0.01 * o.aux_loss

    def ref_loss(t):
        o = ref_moe.apply_moe(split(t), t["x"], k, impl=impl,
                              capacity_factor=0.5)
        return (o.y * r).sum() + 0.01 * o.aux_loss

    _grads_close(_port_grads(port_loss, inputs),
                 _ref_grads(ref_loss, inputs))


def test_ssd_chunked_gradient_matches_reference():
    """Four chunks of 8 (the loop carrying the state across chunks)."""
    h, p, n, length, chunk = 2, 8, 4, 32, 8
    inputs = {"x": _normal(0, (B, length, h, p)),
              "dt": np.log1p(np.exp(_normal(1, (B, length, h)))),
              "a": -np.exp(_normal(2, (h,)) * 0.3),
              "b": _normal(3, (B, length, n)),
              "c": _normal(4, (B, length, n))}
    r = _normal(5, (B, length, h, p))

    def port_loss(t):
        y, s = m2._ssd_chunked(t["x"], t["dt"], t["a"], t["b"], t["c"],
                               chunk)
        return (y * torch.from_numpy(r)).sum() + s.square().sum()

    def ref_loss(t):
        y, s = ref_m2._ssd_chunked(t["x"], t["dt"], t["a"], t["b"],
                                   t["c"], chunk)
        return (y * r).sum() + jnp.square(s).sum()

    _grads_close(_port_grads(port_loss, inputs),
                 _ref_grads(ref_loss, inputs))


@pytest.mark.parametrize("block", ["mamba2", "mlstm", "slstm"])
def test_ssm_block_gradient_matches_reference(block):
    """``apply_mamba2`` (causal conv, gated norm, two chunks),
    ``apply_mlstm`` (four chunks) and ``apply_slstm`` (its loop over
    time): the gradient of every parameter and of the input."""
    d, length = 64, 32
    if block == "mamba2":
        rdims = ref_m2.Mamba2Dims(d_model=d, d_state=8, head_dim=16,
                                  conv_kernel=4, chunk=16)
        pdims = m2.Mamba2Dims(d_model=d, d_state=8, head_dim=16,
                              conv_kernel=4, chunk=16)
        r_init, r_apply = ref_m2.init_mamba2, ref_m2.apply_mamba2
        p_apply = m2.apply_mamba2
    else:
        kw = dict(d_model=d, n_heads=2, chunk=8)
        rdims, pdims = ref_xl.XLSTMDims(**kw), xl.XLSTMDims(**kw)
        r_init, r_apply = ((ref_xl.init_mlstm, ref_xl.apply_mlstm)
                           if block == "mlstm"
                           else (ref_xl.init_slstm, ref_xl.apply_slstm))
        p_apply = xl.apply_mlstm if block == "mlstm" else xl.apply_slstm
    with reference_mode():
        params = jax.tree.map(np.asarray,
                              r_init(jax.random.key(0), rdims, jnp.float32))
    inputs = {"x": _normal(7, (B, length, d)), **params}
    r = _normal(8, (B, length, d))

    def port_loss(t):
        y, _ = p_apply({k: v for k, v in t.items() if k != "x"}, pdims,
                       t["x"])
        return (y * torch.from_numpy(r)).sum()

    def ref_loss(t):
        y, _ = r_apply({k: v for k, v in t.items() if k != "x"}, rdims,
                       t["x"])
        return (y * r).sum()

    _grads_close(_port_grads(port_loss, inputs),
                 _ref_grads(ref_loss, inputs))


# ---------------------------------------------------------------------------
# Prefill and decode steps, and a trained state through the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["pixtral_12b", "whisper_small"])
def test_prefill_and_decode_steps_of_vlm_and_encdec(arch):
    """``make_prefill_step`` takes a vlm's image embeddings and an
    encoder-decoder's frames; ``make_decode_step`` an encoder-decoder's
    caches. The prefill's last logits equal the forward's; the decode's
    last within 2e-3 of the encoder-decoder prefill."""
    ref_cfg, cfg = _pair(arch)
    params = convert.decoder_lm_from_numpy(_ref_params(ref_cfg))
    batch = {k: torch.from_numpy(v.copy())
             for k, v in _np_batch(cfg).items()}
    last = steps.make_prefill_step(cfg)(params, batch)
    if cfg.family == "vlm":
        want = tf.forward(cfg, params, batch["tokens"],
                          image_embeds=batch["image_embeds"]).logits[:, -1]
        assert torch.equal(last, want)
        return
    want = ed.forward_encdec(cfg, params, batch["tokens"],
                             batch["frames"]).logits[:, -1]
    assert torch.equal(last, want)
    decode = steps.make_decode_step(cfg)
    caches = ed.init_encdec_caches(cfg, params, batch["frames"], B, S)
    for i in range(S):
        logits, caches = decode(params, {"tokens": batch["tokens"][:, i:i + 1],
                                         "caches": caches, "index": i})
    rel = (logits - last).abs().max() / last.abs().max()
    assert rel < 2e-3, float(rel)


@pytest.mark.parametrize("arch", ["kimi_k2_1t_a32b", "xlstm_125m",
                                  "whisper_small"])
def test_trained_state_through_reference_restore(arch, tmp_path):
    """A port TrainState after one step (kimi: dense_layers + layers and
    Adafactor's factors; xlstm: both blocks of every layer; whisper:
    encoder and decoder stacks) restored by the reference into its own
    TrainState, leaf for leaf, and back through the port's converter."""
    ref_cfg, cfg = _pair(arch)
    params = _ref_params(ref_cfg)
    pp = convert.decoder_lm_from_numpy(params)
    step, opt = steps.make_train_step(cfg, LR)
    state, _ = step(steps.TrainState(pp, opt.init(pp), 0),
                    {k: torch.from_numpy(v.copy())
                     for k, v in _np_batch(cfg).items()})
    save_checkpoint(str(tmp_path / "s"), convert.lm_train_state_to_numpy(
        state), 1)
    _, ref_opt = ref_steps.make_train_step(ref_cfg, LR)
    with reference_mode():
        rp = jax.tree.map(jnp.asarray, params)
        like = ref_steps.TrainState(rp, ref_opt.init(rp),
                                    jnp.zeros((), jnp.int32))
    got = ref_restore(str(tmp_path / "s"), like)
    assert int(got.step) == 1
    want = {"params": convert.decoder_lm_to_numpy(state.params),
            "opt": convert.decoder_lm_to_numpy(state.opt)}
    for part in ("params", "opt"):
        leaves = _leaves(getattr(got, part))
        assert leaves
        for name, path, w in leaves:
            np.testing.assert_array_equal(_get(want[part], path), w,
                                          err_msg=name)
    back = convert.lm_train_state_from_numpy(
        convert.lm_train_state_to_numpy(state))
    for a, b in zip(pytree.tree_leaves(back.params),
                    pytree.tree_leaves(state.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["xlstm_125m", "whisper_small"])
def test_sync_tree_sim_over_a_family_tree(arch):
    """``sync_tree_sim`` over 4 nodes' bf16 smoke params (the port's
    per-layer lists, each leaf stacked over the nodes; xlstm's both
    blocks of every layer) against the reference's over its node- and
    layer-stacked tree: bit for bit (K1's plain version; the mean summed
    in float32 and rounded once in both packages)."""
    from repro.core import decentralized as ref_dec
    from repro_torch.core import decentralized as dec

    n = 4
    ref_cfg = dataclasses.replace(_pair(arch)[0], dtype="bfloat16")
    init = (ref_ed.init_encdec if ref_cfg.family == "encdec"
            else ref_tf.init_decoder_lm)
    with reference_mode():
        stacked = jax.vmap(lambda k: init(ref_cfg, k))(
            jax.random.split(jax.random.key(2), n))
        spec = ref_dec.parse_sync("gossip-hypercube")
        want = jax.tree.map(np.asarray,
                            ref_dec.sync_tree_sim(stacked, spec, n))
    nodes = [convert.decoder_lm_from_numpy(jax.tree.map(
        lambda x, i=i: np.asarray(x[i]), stacked)) for i in range(n)]
    tree = pytree.tree_map(lambda *xs: torch.stack(xs), *nodes)
    out = dec.sync_tree_sim(tree, dec.parse_sync("gossip-hypercube"), n)
    assert out is tree
    for i in range(n):
        got = convert.decoder_lm_to_numpy(pytree.tree_map(
            lambda x, i=i: x[i], tree))
        for name, path, w in _leaves(jax.tree.map(lambda x, i=i: x[i],
                                                  want)):
            g = _get(got, path)
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g.view(np.int16),
                                          w.view(np.int16), err_msg=name)
