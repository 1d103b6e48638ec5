"""The port's dense decoder LM and its serving launcher against the JAX
package's, on the CPU.

Layer by layer (rmsnorm, rope, the gelu-tanh MLP, the embedding scale,
softcap) on seeded numpy inputs; the parameter converter; ``forward``
and a ``decode_step`` sequence from the reference's own parameters for
the smoke variants of gemma2-2b (window alternation, softcaps, sandwich
norms), granite-3-8b (plain GQA) and qwen2-72b (QKV bias), in float32,
within 1e-4 of max|logit|; the port's decode against its own forward
(the reference's 2e-3); greedy ``generate`` with equal tokens when the
smoke window of 16 bites; ``serve.main`` on the CPU, and its default
device raising without a GPU.
"""

import functools
import operator

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke_variant as ref_smoke  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.configs import get_config, list_archs, smoke_variant  # noqa: E402
from repro_torch.convert import decoder_lm_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from torch_parity import reference_mode  # noqa: E402

ARCHS = ["gemma2_2b", "gemma2_9b", "granite_3_8b", "qwen2_72b"]
B, S = 2, 20            # S > 16: the gemma2 smoke window bites
REL = 1e-4              # port vs reference, float32, of max|logit|


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(reference config, its params, port config, port params)."""
    arch = request.param
    ref_cfg = ref_smoke(ref_get_config(arch))
    cfg = smoke_variant(get_config(arch))
    with reference_mode():
        ref_params = ref_tf.init_decoder_lm(ref_cfg, jax.random.key(0))
    params = decoder_lm_from_numpy(jax.tree.map(np.asarray, ref_params))
    tokens = _rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return ref_cfg, ref_params, cfg, params, tokens


def test_configs_match_reference():
    from repro.configs import list_archs as ref_list_archs
    assert list_archs() == ref_list_archs()
    assert set(ARCHS) <= set(list_archs())
    for arch in ARCHS:
        full, ref_full = get_config(arch), ref_get_config(arch)
        assert full.n_params() == ref_full.n_params()
        for cfg, ref in ((full, ref_full),
                         (smoke_variant(full), ref_smoke(ref_full))):
            port = {k: v for k, v in vars(cfg).items()}
            assert port == {k: v for k, v in vars(ref).items()}
    assert get_config("gemma2-2b").n_params() == 2_614_099_968
    assert get_config("gemma2_2b").torch_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("llama_7b")


def test_rmsnorm_and_layernorm_match_reference():
    x = _rng(2).standard_normal((2, 5, 32), dtype=np.float32)
    scale = _rng(3).standard_normal(32, dtype=np.float32)
    bias = _rng(4).standard_normal(32, dtype=np.float32)
    got = layers.apply_rmsnorm({"scale": _t(scale)}, _t(x))
    want = ref_layers.apply_rmsnorm({"scale": jnp.asarray(scale)},
                                    jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    got = layers.apply_layernorm({"scale": _t(scale), "bias": _t(bias)},
                                 _t(x))
    want = ref_layers.apply_layernorm(
        {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
        jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_reference(theta):
    x = _rng(5).standard_normal((2, 7, 3, 16), dtype=np.float32)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    got = layers.apply_rope(_t(x), _t(pos), theta)
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_gated_mlp_matches_reference(act):
    r = _rng(6)
    p = {k: r.standard_normal(s, dtype=np.float32) * 0.2 for k, s in
         (("w_gate", (16, 40)), ("w_up", (16, 40)), ("w_down", (40, 16)))}
    x = r.standard_normal((2, 3, 16), dtype=np.float32)
    got = layers.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x), act)
    want = ref_layers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_embedding_unembed_and_softcap_match_reference():
    r = _rng(7)
    table = r.standard_normal((50, 24), dtype=np.float32)
    tokens = r.integers(0, 50, (2, 6)).astype(np.int32)
    got = layers.apply_embedding({"table": _t(table)}, _t(tokens).long())
    want = ref_layers.apply_embedding({"table": jnp.asarray(table)},
                                      jnp.asarray(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    logits = layers.apply_unembed({"table": _t(table)}, got)
    want_logits = ref_layers.apply_unembed({"table": jnp.asarray(table)},
                                           want)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-5, atol=1e-4)
    for cap in (None, 30.0):
        np.testing.assert_allclose(
            layers.softcap(logits, cap).numpy(),
            np.asarray(ref_layers.softcap(want_logits, cap)), rtol=1e-5,
            atol=1e-4)


def test_trunc_normal_law():
    g = torch.Generator().manual_seed(0)
    x = layers.trunc_normal(g, (256, 512), torch.float32, fan_in=64)
    assert float(x.abs().max()) <= 2.0 / 8.0
    # the standard normal cut at +-2 has std 0.8796
    assert abs(float(x.std()) * 8.0 - 0.8796) < 0.01
    assert layers.trunc_normal(g, (4, 4), torch.bfloat16).dtype == \
        torch.bfloat16


def test_converter_keeps_every_leaf(model):
    ref_cfg, ref_params, cfg, params, _ = model
    assert len(params["layers"]) == cfg.n_layers

    def get(node, keys):
        return functools.reduce(operator.getitem, keys, node).numpy()

    for path, leaf in jax.tree_util.tree_leaves_with_path(ref_params):
        keys = [p.key for p in path]
        if keys[0] == "layers":
            got = np.stack([get(layer, keys[1:])
                            for layer in params["layers"]])
        else:
            got = get(params, keys)
        np.testing.assert_array_equal(got, np.asarray(leaf))
    init = tf.init_decoder_lm(cfg, torch.Generator().manual_seed(0))
    assert jax.tree.structure(init["layers"][0]) == jax.tree.structure(
        params["layers"][0])


def test_forward_and_decode_match_reference(model):
    ref_cfg, ref_params, cfg, params, tokens = model
    with reference_mode():
        want = np.asarray(ref_tf.forward(ref_cfg, ref_params,
                                         jnp.asarray(tokens)).logits)
        caches = ref_tf.init_caches(ref_cfg, B, S)
        step = jax.jit(ref_tf.decode_step, static_argnums=0)
        want_dec = []
        for t in range(S):
            o = step(ref_cfg, ref_params,
                                   jnp.asarray(tokens[:, t:t + 1]), caches,
                                   jnp.asarray(t, jnp.int32))
            caches = o.caches
            want_dec.append(np.asarray(o.logits[:, 0]))
    want_dec = np.stack(want_dec, 1)
    toks = _t(tokens).long()
    got = tf.forward(cfg, params, toks).logits
    assert got.shape == (B, S, cfg.vocab_size)
    assert _rel(got.numpy(), want) <= REL
    caches = tf.init_caches(cfg, B, S, "cpu")
    got_dec = []
    for t in range(S):
        o = tf.decode_step(cfg, params, toks[:, t:t + 1], caches, t)
        caches = o.caches
        got_dec.append(o.logits[:, 0])
    got_dec = torch.stack(got_dec, 1).numpy()
    assert _rel(got_dec, want_dec) <= REL
    assert _rel(got_dec, got.numpy()) < 2e-3     # the reference's bound
    assert all(c.index == S for c in caches)


def test_generate_matches_reference():
    """gemma2's smoke variant, prompt 24 and 8 new tokens: the window of
    16 bites on the local layers; greedy tokens are equal."""
    ref_cfg = ref_smoke(ref_get_config("gemma2_2b"))
    cfg = smoke_variant(get_config("gemma2_2b"))
    with reference_mode():
        ref_params = ref_tf.init_decoder_lm(ref_cfg, jax.random.key(3))
    params = decoder_lm_from_numpy(jax.tree.map(np.asarray, ref_params))
    prompt = _rng(8).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    with reference_mode():
        want, _ = ref_serve.generate(ref_cfg, ref_params,
                                     jnp.asarray(prompt), 8)
    got, stats = serve.generate(cfg, params, _t(prompt).long(), 8)
    assert got.shape == (2, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["decode_tok_per_sec"] > 0


def test_serve_main_on_cpu():
    out = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                      "20", "--gen", "4", "--arch", "granite_3_8b"])
    assert out["tokens"].shape == (2, 24)
    assert out["config"].n_layers == 2
    assert out["decode_sec"] >= 0 and out["prefill_sec"] >= 0


def test_serve_main_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--gen", "1"])


def test_other_families_raise():
    """Every decoder family is served now; an encoder-decoder config
    given to ``init_decoder_lm`` raises ``ValueError``, as the
    reference's does (whisper goes through ``models/encdec``)."""
    import dataclasses
    cfg = dataclasses.replace(smoke_variant(get_config("granite_3_8b")),
                              family="encdec")
    with pytest.raises(ValueError, match="unsupported family encdec"):
        tf.init_decoder_lm(cfg, torch.Generator().manual_seed(0))
    with reference_mode():
        with pytest.raises(ValueError, match="unsupported family encdec"):
            ref_tf.init_decoder_lm(
                dataclasses.replace(ref_smoke(ref_get_config("granite_3_8b")),
                                    family="encdec"), jax.random.key(0))
