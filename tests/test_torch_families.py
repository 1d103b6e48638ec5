"""The port's other LM families against the JAX package's, on the CPU:
MoE (kimi-k2, arctic), hybrid Mamba2 (zamba2), xLSTM, the VLM (pixtral)
and the encoder-decoder (whisper), at their smoke variants in float32.

For each: the reference's parameters carried across with the converter
(every leaf bit-equal both ways, and the port's own init in the
reference's tree); ``forward`` (pixtral with ``image_embeds``,
whisper's ``forward_encdec`` over stub frames) and every
``decode_step`` within ``REL`` = 1e-4 of max|logit| of the reference's
(``tests/test_torch_models.py``'s bound); the port's decode against its
own forward under 2e-3 (the reference's ``test_decode_consistency``
bound; the MoE families with ``moe_impl="ragged"``, since a forward over
B x S tokens may drop tokens under capacity where a one-token step does
not); greedy ``generate`` token-equal to the reference's for kimi and
whisper; ``serve.main --device cpu`` for all ten archs. Then the pieces
the families add: K5's plain path non-causal (Sq != Sk) and at head_dim
80 against the reference's ``attention_ref``, non-causal self-attention
and cross-attention against the reference's, the frontends' sinusoid,
and an encoder-decoder config refused by ``init_decoder_lm``.
"""

import dataclasses
import functools
import operator

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import list_archs as ref_list_archs  # noqa: E402
from repro.configs import smoke_variant as ref_smoke  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as ref_dense  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import encdec as ref_ed  # noqa: E402
from repro.models import frontends as ref_fe  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, list_archs, smoke_variant  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import encdec as ed  # noqa: E402
from repro_torch.models import frontends as fe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from torch_parity import reference_mode  # noqa: E402

FAMILIES = ["kimi_k2_1t_a32b", "arctic_480b", "zamba2_2p7b", "xlstm_125m",
            "pixtral_12b", "whisper_small"]
B, S = 2, 12            # S > ssd_chunk would need a multiple of it
FRAMES = 16
REL = 1e-4              # port vs reference, float32, of max|logit|


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _t(x):
    return torch.from_numpy(np.array(x))


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """(arch, reference config, its numpy params, port config, port
    params, tokens, extra input: frames or image embeds or None)."""
    arch = request.param
    ref_cfg = ref_smoke(ref_get_config(arch))
    cfg = smoke_variant(get_config(arch))
    with reference_mode():
        init = (ref_ed.init_encdec if cfg.family == "encdec"
                else ref_tf.init_decoder_lm)
        ref_params = jax.tree.map(np.asarray, init(ref_cfg,
                                                   jax.random.key(0)))
    params = convert.decoder_lm_from_numpy(ref_params)
    tokens = _rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    extra = None
    if cfg.family == "encdec":
        extra = _rng(2).standard_normal((B, FRAMES, cfg.d_model),
                                        dtype=np.float32)
    elif cfg.family == "vlm":
        extra = _rng(3).standard_normal((B, cfg.n_image_tokens, cfg.d_model),
                                        dtype=np.float32)
    return arch, ref_cfg, ref_params, cfg, params, tokens, extra


def test_configs_match_reference():
    """All ten archs, full and smoke, field for field and in
    ``n_params``; the names the reference lists, in its order."""
    assert list_archs() == ref_list_archs()
    for arch in list_archs():
        full, ref_full = get_config(arch), ref_get_config(arch)
        assert full.n_params() == ref_full.n_params(), arch
        assert full.n_active_params() == ref_full.n_active_params(), arch
        for cfg, ref in ((full, ref_full),
                         (smoke_variant(full), ref_smoke(ref_full))):
            assert vars(cfg) == vars(ref), arch
    assert get_config("zamba2-2.7b").hd == 80
    from repro.configs import lda_paper as ref_paper
    from repro_torch.configs import lda_paper
    for port, ref in ((lda_paper.CONFIG.corpus, ref_paper.CONFIG.corpus),
                      (lda_paper.CONFIG.lda, ref_paper.CONFIG.lda)):
        for f in dataclasses.fields(ref):
            if f.name != "dtype":
                assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert (lda_paper.CONFIG.ws_k, lda_paper.CONFIG.ws_p,
            lda_paper.CONFIG.batch_size) == (4, 0.3, 20)
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("llama_7b")


def _leaf(node, keys):
    return functools.reduce(operator.getitem, keys, node)


def test_converter_bit_equal_both_ways(family):
    """Reference -> port -> reference gives every leaf back bit for bit
    (kimi's dense_layers, the float32 router, zamba2's unstacked
    shared_attn, mamba/mlstm/slstm, whisper's encoder and decoder); the
    port's own init has the reference's tree, shapes and dtypes, and
    survives port -> reference -> port bit for bit."""
    arch, ref_cfg, ref_params, cfg, params, _, _ = family
    to_np = (convert.encdec_to_numpy if cfg.family == "encdec"
             else convert.decoder_lm_to_numpy)
    from_np = (convert.encdec_from_numpy if cfg.family == "encdec"
               else convert.decoder_lm_from_numpy)
    back = to_np(params)
    assert jax.tree.structure(back) == jax.tree.structure(ref_params)
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref_params):
        got = _leaf(back, [p.key for p in path])
        assert got.dtype == leaf.dtype and np.array_equal(got, leaf), path

    gen = torch.Generator().manual_seed(0)
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    mine = (ed.init_encdec(bf16, gen) if cfg.family == "encdec"
            else tf.init_decoder_lm(bf16, gen))
    tree = to_np(mine)
    with reference_mode():
        init = (ref_ed.init_encdec if cfg.family == "encdec"
                else ref_tf.init_decoder_lm)
        want = jax.eval_shape(lambda: init(
            dataclasses.replace(ref_cfg, dtype="bfloat16"),
            jax.random.key(0)))
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for a, w in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        assert a.shape == w.shape and a.dtype == w.dtype
    again = from_np(tree)
    flat_a = jax.tree_util.tree_leaves_with_path(
        convert.decoder_lm_to_numpy(again))
    for path, leaf in flat_a:
        orig = _leaf(tree, [p.key for p in path])
        assert np.array_equal(leaf.view(np.uint8), orig.view(np.uint8)), path


def _ref_run(ref_cfg, ref_params, tokens, extra):
    """The reference's forward logits and its teacher-forced decode
    logits [B, S, V]."""
    p = jax.tree.map(jnp.asarray, ref_params)
    toks = jnp.asarray(tokens)
    with reference_mode():
        if ref_cfg.family == "encdec":
            frames = jnp.asarray(extra)
            full = ref_ed.forward_encdec(ref_cfg, p, toks, frames).logits
            caches = ref_ed.init_encdec_caches(ref_cfg, p, frames, B, S)
            step = jax.jit(ref_ed.decode_step_encdec, static_argnums=0)
        else:
            img = None if extra is None else jnp.asarray(extra)
            full = ref_tf.forward(ref_cfg, p, toks, image_embeds=img).logits
            caches = ref_tf.init_caches(ref_cfg, B, S)
            step = jax.jit(ref_tf.decode_step, static_argnums=0)
        dec = []
        for t in range(S):
            o = step(ref_cfg, p, toks[:, t:t + 1], caches,
                     jnp.asarray(t, jnp.int32))
            caches = o.caches
            dec.append(np.asarray(o.logits[:, 0]))
    return np.asarray(full), np.stack(dec, 1)


def _port_run(cfg, params, tokens, extra, images=True):
    toks = _t(tokens).long()
    if cfg.family == "encdec":
        frames = _t(extra)
        full = ed.forward_encdec(cfg, params, toks, frames).logits
        caches = ed.init_encdec_caches(cfg, params, frames, B, S)
        step = ed.decode_step_encdec
    else:
        img = None if extra is None or not images else _t(extra)
        full = tf.forward(cfg, params, toks, image_embeds=img).logits
        caches = tf.init_caches(cfg, B, S, "cpu")
        step = tf.decode_step
    dec = []
    for t in range(S):
        o = step(cfg, params, toks[:, t:t + 1], caches, t)
        caches = o.caches
        dec.append(o.logits[:, 0])
    return full, torch.stack(dec, 1), caches


def test_forward_and_decode_match_reference(family):
    arch, ref_cfg, ref_params, cfg, params, tokens, extra = family
    want_full, want_dec = _ref_run(ref_cfg, ref_params, tokens, extra)
    got_full, got_dec, caches = _port_run(cfg, params, tokens, extra)
    n_img = cfg.n_image_tokens if cfg.family == "vlm" else 0
    assert got_full.shape == (B, n_img + S, cfg.vocab_size)
    assert _rel(got_full.numpy(), want_full) <= REL
    assert _rel(got_dec.numpy(), want_dec) <= REL
    if cfg.family == "hybrid":
        assert len(caches["attn"]) == cfg.n_layers // cfg.attn_every
        assert all(c.index == S for c in caches["attn"])
    elif cfg.family == "encdec":
        assert all(c.index == S for c in caches.self_kv)
    elif cfg.family != "ssm":
        assert len(caches) == cfg.n_layers
        assert all(c.index == S for c in caches)


def test_decode_matches_own_forward(family):
    """The reference's serving-correctness bound on the port alone: the
    cached step teacher-forced over the prompt gives the forward's
    logits (a vlm without images, as served; MoE with ragged dispatch)."""
    arch, _, _, cfg, params, tokens, extra = family
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, moe_impl="ragged")
    full, dec, _ = _port_run(cfg, params, tokens, extra, images=False)
    assert _rel(dec.numpy(), full.numpy()) < 2e-3


@pytest.mark.parametrize("arch", ["kimi_k2_1t_a32b", "arctic_480b"])
def test_moe_forward_aux_loss_matches_reference(arch):
    """The per-layer aux loss averaged over the MoE layers."""
    ref_cfg = ref_smoke(ref_get_config(arch))
    cfg = smoke_variant(get_config(arch))
    with reference_mode():
        ref_params = ref_tf.init_decoder_lm(ref_cfg, jax.random.key(5))
        tokens = _rng(7).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        want = ref_tf.forward(ref_cfg, ref_params, jnp.asarray(tokens))
    params = convert.decoder_lm_from_numpy(jax.tree.map(np.asarray,
                                                        ref_params))
    got = tf.forward(cfg, params, _t(tokens).long())
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss),
                               rtol=1e-6)
    assert float(got.aux_loss) > 0


@pytest.mark.parametrize("arch", ["kimi_k2_1t_a32b", "whisper_small"])
def test_generate_matches_reference(arch):
    """Greedy tokens of ``serve.generate`` equal the reference's (kimi's
    capacity dispatch; whisper's encoder, cross caches and learned
    positions)."""
    ref_cfg = ref_smoke(ref_get_config(arch))
    cfg = smoke_variant(get_config(arch))
    frames = None
    with reference_mode():
        if cfg.family == "encdec":
            ref_params = ref_ed.init_encdec(ref_cfg, jax.random.key(4))
            frames = _rng(5).standard_normal((2, FRAMES, cfg.d_model),
                                             dtype=np.float32)
        else:
            ref_params = ref_tf.init_decoder_lm(ref_cfg, jax.random.key(4))
    params = convert.decoder_lm_from_numpy(jax.tree.map(np.asarray,
                                                        ref_params))
    prompt = _rng(6).integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    with reference_mode():
        want, _ = ref_serve.generate(
            ref_cfg, ref_params, jnp.asarray(prompt), 6,
            frames=None if frames is None else jnp.asarray(frames))
    got, stats = serve.generate(cfg, params, _t(prompt).long(), 6,
                                frames=None if frames is None
                                else _t(frames))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["decode_tok_per_sec"] > 0 and stats["caches_sec"] >= 0


@pytest.mark.parametrize("arch", list_archs())
def test_serve_main_on_cpu(arch):
    """``serve.main`` runs every arch on the CPU; ``--layers`` cuts the
    depth (both stacks of whisper; zamba2 in whole stages)."""
    layers = {"zamba2_2p7b": 2, "whisper_small": 1, "kimi_k2_1t_a32b": 2}
    argv = ["--device", "cpu", "--arch", arch, "--batch", "2",
            "--prompt-len", "6", "--gen", "3"]
    if arch in layers:
        argv += ["--layers", str(layers[arch])]
    out = serve.main(argv)
    cfg = out["config"]
    assert out["tokens"].shape == (2, 9)
    assert int(out["tokens"].min()) >= 0
    assert int(out["tokens"].max()) < cfg.vocab_size
    assert cfg.n_layers == layers.get(arch, 2)
    if cfg.family == "encdec":
        assert cfg.n_encoder_layers == cfg.n_layers
        assert tuple(out["frames"].shape) == (2, serve.STUB_FRAMES,
                                              cfg.d_model)
    else:
        assert out["frames"] is None


def test_hybrid_depth_must_be_whole_stages():
    cfg = dataclasses.replace(smoke_variant(get_config("zamba2_2p7b")),
                              n_layers=3)
    with pytest.raises(ValueError, match="attn_every"):
        tf.init_decoder_lm(cfg, torch.Generator().manual_seed(0))


def test_init_decoder_lm_refuses_an_encoder_decoder():
    """As the reference's: whisper goes through ``models/encdec``."""
    cfg = smoke_variant(get_config("whisper_small"))
    with pytest.raises(ValueError, match="unsupported family encdec"):
        tf.init_decoder_lm(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        with reference_mode():
            ref_tf.init_decoder_lm(ref_smoke(ref_get_config("whisper_small")),
                                   jax.random.key(0))


# ----------------------------------------------------------------------------
# The pieces: K5 non-causal and at D=80, attention, cross-attention, stubs
# ----------------------------------------------------------------------------

# (b, sq, sk, h, hkv, d, causal, kwargs, dtype, atol)
K5_CASES = [
    (2, 48, 112, 4, 4, 64, False, {}, "float32", 2e-5),     # cross, Sq < Sk
    (1, 100, 40, 4, 2, 32, False, {}, "float32", 2e-5),     # Sq > Sk
    (2, 1, 150, 12, 12, 64, False, {}, "float32", 2e-5),    # cross decode
    (1, 75, 75, 2, 2, 64, False, {}, "bfloat16", 3e-2),     # encoder, bf16
    (2, 64, 64, 4, 4, 80, True, {}, "float32", 2e-5),       # zamba2 prefill
    (2, 1, 40, 4, 4, 80, True, {"q_offset": 39}, "float32", 2e-5),
    (1, 70, 70, 2, 2, 80, True, {"softcap": 30.0, "window": 24},
     "bfloat16", 3e-2),
    (1, 30, 90, 2, 1, 80, False, {}, "float32", 2e-5),
]


@pytest.mark.parametrize("case", K5_CASES,
                         ids=[f"k5_{i}" for i in range(len(K5_CASES))])
def test_k5_plain_path_matches_reference(case):
    """K5's CPU path (``ops.flash_attention`` on CPU tensors: the plain
    version) against the reference's ``attention_ref``, non-causal with
    Sq != Sk and at head_dim 80: float32 within 2e-5, bf16 within 3e-2
    (the reference kernel test's tolerances)."""
    b, sq, sk, h, hkv, d, causal, kw, dtype, atol = case
    rng = _rng(sq + sk + d)
    q, k, v = (rng.standard_normal(s, dtype=np.float32)
               for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d)))

    def heads(x):
        return x.transpose(0, 2, 1, 3).reshape(-1, x.shape[1], d)
    with reference_mode():
        want = np.asarray(ref_dense(
            *(jnp.asarray(heads(x), getattr(jnp, dtype)) for x in (q, k, v)),
            causal=causal, **kw), np.float32)
    want = want.reshape(b, h, sq, d).transpose(0, 2, 1, 3)
    got = flash_ops.flash_attention(
        *(_t(x).to(getattr(torch, dtype)) for x in (q, k, v)),
        causal=causal, **kw)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol)


def test_k5_takes_head_dim_80_and_routes_its_prefill_to_fma():
    """D=80 is a head_dim K5 takes; "wgmma" needs 64-column panels, so a
    bf16 prefill at D=80 takes "fma", and a decode takes "decode"."""
    assert 80 in flash_ops.HEAD_DIMS and 80 not in flash_ops.WGMMA_DIMS
    assert flash_ops.variant(torch.bfloat16, 128, 80, 1) == "fma"
    assert flash_ops.variant(torch.float32, 128, 80, 1) == "fma"
    assert flash_ops.variant(torch.bfloat16, 1, 80, 1) == "decode"
    assert flash_ops.variant(torch.bfloat16, 1, 128, 7) == "decode"
    assert flash_ops.variant(torch.bfloat16, 1500, 64, 1) == "wgmma"


@pytest.mark.parametrize("d, sq, causal", [(80, 1, True), (80, 200, True),
                                          (64, 300, False), (64, 1, False)])
def test_k5_device_launch_reaches_the_kernel(monkeypatch, d, sq, causal):
    """A device tensor at head_dim 80, or non-causal, goes to the kernel
    (its loader, which raises here where nothing is built) whatever
    variant it takes; a head_dim the kernel does not take (24) still
    raises, and nothing pads or falls back to the plain version."""
    class Loaded(Exception):
        pass

    def load(name):
        raise Loaded(name)

    def plain(*a, **k):
        raise AssertionError("the plain version ran for a device tensor")

    monkeypatch.setattr(flash_ops, "attention_ref", plain)
    monkeypatch.setattr(flash_ops.common, "require_cuda", lambda *a: None)
    monkeypatch.setattr(flash_ops.common, "load", load)
    q = torch.empty((1, sq, 4, d), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 300, 4, d), dtype=torch.bfloat16, device="meta")
    before = flash_ops.launches
    with pytest.raises(Loaded):
        flash_ops.flash_attention(q, k, k, causal=causal)
    bad = torch.empty((1, sq, 4, 24), dtype=torch.bfloat16, device="meta")
    kbad = torch.empty((1, 300, 4, 24), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="head_dim 24"):
        flash_ops.flash_attention(bad, kbad, kbad, causal=causal)
    assert flash_ops.launches == before


@pytest.mark.parametrize("sq, sk, want", [(1, 1500, 3), (1, 512, 1),
                                          (1, 513, 2), (4, 64, 1)])
def test_non_causal_decode_splits(sq, sk, want):
    """A non-causal "decode" launch sees every key, whatever its offset:
    whisper's cross decode (Sq=1, Sk=1500) takes 3 splits."""
    assert flash_ops.n_splits(sq, sk, False, flash_ops.GLOBAL_WINDOW, 0) \
        == want


def _attn_params(d, h, hkv, hd, bias, seed):
    with reference_mode():
        p = ref_attn.init_attention(jax.random.key(seed), d, h, hkv, hd,
                                    jnp.float32, qkv_bias=bias)
    p = jax.tree.map(np.asarray, p)
    if bias:     # the init's biases are 0: make them count
        p = {k: (v + _rng(seed).standard_normal(v.shape, dtype=np.float32)
                 if k.startswith("b") else v) for k, v in p.items()}
    return p, {k: _t(v) for k, v in p.items()}


def test_noncausal_self_attention_matches_reference():
    """whisper's encoder attention: non-causal, no RoPE, QKV bias."""
    ref_p, p = _attn_params(32, 4, 4, 8, True, 7)
    x = _rng(8).standard_normal((2, 20, 32), dtype=np.float32)
    pos = jnp.broadcast_to(jnp.arange(20, dtype=jnp.int32), (2, 20))
    with reference_mode():
        want, _ = ref_attn.apply_attention(
            jax.tree.map(jnp.asarray, ref_p), jnp.asarray(x), pos,
            causal=False, rope_theta=None)
    got, none = attn.apply_attention(p, _t(x), 0, causal=False,
                                     rope_theta=None)
    assert none is None
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-5
    cache = attn.init_kv_cache(2, 20, 4, 8, torch.float32, "cpu")
    with pytest.raises(ValueError, match="causal"):
        attn.apply_attention(p, _t(x[:, :1]), 0, causal=False,
                             rope_theta=None, cache=cache)


def test_cross_attention_matches_reference():
    """Queries against encoder memory, from the memory and from a
    precomputed ``CrossCache`` (GQA 4/2 here, MHA in whisper)."""
    ref_p, p = _attn_params(32, 4, 2, 8, True, 9)
    x = _rng(10).standard_normal((2, 5, 32), dtype=np.float32)
    mem = _rng(11).standard_normal((2, 23, 32), dtype=np.float32)
    with reference_mode():
        rp = jax.tree.map(jnp.asarray, ref_p)
        want = np.asarray(ref_attn.apply_cross_attention(
            rp, jnp.asarray(x), memory=jnp.asarray(mem)))
        want_cache = ref_attn.precompute_cross_cache(rp, jnp.asarray(mem))
    got = attn.apply_cross_attention(p, _t(x), memory=_t(mem))
    assert _rel(got.numpy(), want) <= 1e-5
    cache = attn.precompute_cross_cache(p, _t(mem))
    for g, w in zip(cache, want_cache):
        assert _rel(g.numpy(), np.asarray(w)) <= 1e-6
    step = attn.apply_cross_attention(p, _t(x[:, :1]), cross_cache=cache)
    assert _rel(step.numpy(), want[:, :1]) <= 1e-5


def test_frontend_stubs():
    """The audio stub's positions are the reference's sinusoid (its stub
    minus its own noise); both stubs have the shapes and dtype, and a
    seed gives the same frames on every call."""
    cfg = smoke_variant(get_config("whisper_small"))
    ref_cfg = ref_smoke(ref_get_config("whisper_small"))
    key = jax.random.key(3)
    with reference_mode():
        stub = ref_fe.audio_frames_stub(ref_cfg, key, 2, 30)
        noise = jax.random.normal(key, (2, 30, cfg.d_model), jnp.float32)
    want = np.asarray(stub - noise)[0]
    np.testing.assert_allclose(fe.sinusoid(30, cfg.d_model).numpy(), want,
                               atol=1e-6)
    a = fe.audio_frames_stub(cfg, torch.Generator().manual_seed(0), 2)
    b = fe.audio_frames_stub(cfg, torch.Generator().manual_seed(0), 2)
    assert a.shape == (2, cfg.max_source_len, cfg.d_model)
    assert torch.equal(a, b) and a.dtype == torch.float32
    vlm = get_config("pixtral_12b")
    img = fe.image_patches_stub(vlm, torch.Generator().manual_seed(0), 1)
    assert img.shape == (1, 256, 5120) and img.dtype == torch.bfloat16
