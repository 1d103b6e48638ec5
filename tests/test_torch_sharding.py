"""The port's logical-axis sharding against the JAX package's, on the CPU.

- The reference's ``tests/test_sharding.py`` cases on the port's
  ``AbstractMesh``, each also equal to the reference's own result on
  ``compat.abstract_mesh``.
- A property (hypothesis): for random logical axes and dims on the
  (4, 2) and (2, 4, 2) meshes, under each of the three rule sets, the
  port's ``spec_for_shape`` equals the reference's.
- Every arch at full width, on (16, 16) and (2, 16, 16): the spec of
  every leaf of the parameters, the optimizer state (AdamW or
  Adafactor, as the arch uses), the caches of every decode shape and
  every ``input_specs`` batch leaf, from the port's ``launch.steps``
  helpers, equals the reference's from its ``jax.eval_shape`` abstract
  tree and its ``steps`` helpers; the port's ``*_axes`` trees equal
  the reference's leaf for leaf, and ``input_specs`` shapes and dtypes
  match. The reference stacks a layer leaf on a leading "layers" dim
  where the port keeps a list of per-layer leaves; every rule set
  replicates "layers", so a port layer leaf's spec is the reference's
  without its first entry. Specs compare as tuples (the reference's
  ``PartitionSpec`` equals the tuple of its entries).
- ``placements`` on a ``DeviceMesh`` and the frontends' ``*_spec``.
"""

import functools

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import torch  # noqa: E402
from hyputil import given, settings, st  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import INPUT_SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import encdec as ref_ed  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import mamba2 as ref_m2  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.models import xlstm as ref_xl  # noqa: E402
from repro.sharding import axes as ref_axes  # noqa: E402
from repro_torch.configs import (INPUT_SHAPES, get_config,  # noqa: E402
                                 list_archs, smoke_variant)
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import encdec as ed  # noqa: E402
from repro_torch.models import frontends as fe  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import mamba2 as m2  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models import xlstm as xl  # noqa: E402
from repro_torch.sharding import (DP_ONLY_RULES, FSDP_RULES,  # noqa: E402
                                  LOGICAL_RULES, AbstractMesh,
                                  logical_to_spec, spec_for_shape)

RULES = {"logical": (LOGICAL_RULES, ref_axes.LOGICAL_RULES),
         "fsdp": (FSDP_RULES, ref_axes.FSDP_RULES),
         "dp_only": (DP_ONLY_RULES, ref_axes.DP_ONLY_RULES)}
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(sizes, names):
    return AbstractMesh(sizes, names), compat.abstract_mesh(sizes, names)


@pytest.fixture(scope="module")
def mesh():
    return _meshes((4, 2), ("data", "model"))


def test_rule_tables_are_the_reference_s():
    for port, ref in RULES.values():
        assert tuple(port) == tuple(ref)


def test_basic_rules(mesh):
    m, rm = mesh
    for axes, want in [(("vocab", "embed"), ("model", None)),
                       (("batch", "seq"), ("data", None))]:
        assert logical_to_spec(axes, m) == want
        assert ref_axes.logical_to_spec(axes, rm) == want


def test_no_axis_reuse(mesh):
    m, rm = mesh
    axes = ("heads", "kv_heads")
    assert logical_to_spec(axes, m) == ("model", None)
    assert ref_axes.logical_to_spec(axes, rm) == logical_to_spec(axes, m)


@pytest.mark.parametrize("shape,axes,want", [
    ((8, 3, 16), ("embed", "kv_heads", "head_dim"), (None, None, None)),
    ((8, 4, 16), ("embed", "kv_heads", "head_dim"), (None, "model", None)),
    ((4, 64, 3, 8), ("batch", "cache_seq", "kv_heads", "head_dim"),
     ("data", "model", None, None)),
    ((4, 64, 4, 8), ("batch", "cache_seq", "kv_heads", "head_dim"),
     ("data", None, "model", None)),
    ((2, 64, 3, 8), ("batch", "cache_seq", "kv_heads", "head_dim"),
     (None, "model", None, None)),
])
def test_divisibility_and_cache_seq_fallback(mesh, shape, axes, want):
    m, rm = mesh
    assert spec_for_shape(shape, axes, m) == want
    assert ref_axes.spec_for_shape(shape, axes, rm) == want


def test_dp_only_rules_batch_absorbs_mesh(mesh):
    m, rm = mesh
    for shape, axes, want in [
            ((8, 16), ("batch", "seq"), (("data", "model"), None)),
            ((64, 32), ("embed", "mlp"), (None, None)),
            ((4, 16), ("batch", "seq"), ("data", None))]:
        assert spec_for_shape(shape, axes, m, DP_ONLY_RULES) == want
        assert ref_axes.spec_for_shape(shape, axes, rm,
                                       ref_axes.DP_ONLY_RULES) == want


def test_fsdp_rules_shard_embed(mesh):
    m, rm = mesh
    for rules, ref_rules, want in [
            (FSDP_RULES, ref_axes.FSDP_RULES, ("data", "model")),
            (LOGICAL_RULES, ref_axes.LOGICAL_RULES, (None, "model"))]:
        assert spec_for_shape((256, 8), ("embed", "heads"), m,
                              rules) == want
        assert ref_axes.spec_for_shape((256, 8), ("embed", "heads"), rm,
                                       ref_rules) == want


_NAMES = ["batch", "seq", "vocab", "heads", "kv_heads", "mlp", "embed",
          "experts", "layers", "head_dim", "cache_seq", "qseq", "tokens"]


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("sizes,names", [((4, 2), ("data", "model")),
                                         ((2, 4, 2),
                                          ("pod", "data", "model"))])
@given(axes=st.lists(st.sampled_from(_NAMES), min_size=1, max_size=5),
       dims=st.lists(st.integers(1, 64), min_size=5, max_size=5))
@settings(max_examples=60, deadline=None)
def test_spec_for_shape_equals_reference(rules, sizes, names, axes, dims):
    port_rules, ref_rules = RULES[rules]
    m, rm = _meshes(sizes, names)
    axes = tuple(axes)
    shape = tuple(dims[:len(axes)])
    assert spec_for_shape(shape, axes, m, port_rules) == \
        tuple(ref_axes.spec_for_shape(shape, axes, rm, ref_rules))
    assert logical_to_spec(axes, m, port_rules) == \
        tuple(ref_axes.logical_to_spec(axes, rm, ref_rules))


# ----------------------------------------------------------------------------
# Every arch at full width, leaf for leaf
# ----------------------------------------------------------------------------

def _ref_leaf(x) -> bool:
    return hasattr(x, "shape") or ref_axes._is_axes_leaf(x)


def _is_spec(x) -> bool:
    """A leaf of an axes or spec tree: a plain tuple of names, name
    tuples and ``None`` (a cache's named tuple is a node)."""
    return type(x) is tuple and all(
        isinstance(a, (str, tuple, type(None))) for a in x)


def _pairs(port, ref, stacked=False, path=()):
    """``(path, port leaf, ref leaf, stacked)`` of two trees, the port's
    per-layer lists against the reference's stacked leaves."""
    if isinstance(port, list) and not isinstance(ref, list):
        for i, p in enumerate(port):
            yield from _pairs(p, ref, True, path + (i,))
        return
    if isinstance(port, dict):
        assert set(port) == set(ref), (path, sorted(port), sorted(ref))
        for k in port:
            yield from _pairs(port[k], ref[k], stacked, path + (k,))
        return
    if isinstance(port, (list, tuple)) and not _is_spec(port):
        assert len(port) == len(ref), path
        for i, (p, r) in enumerate(zip(port, ref)):
            yield from _pairs(p, r, stacked, path + (i,))
        return
    yield path, port, ref, stacked


def _spec(x):
    return None if x is None else tuple(x)


def _check_specs(port_specs, ref_specs):
    n = 0
    for path, p, r, stacked in _pairs(port_specs, ref_specs):
        if p is None and not isinstance(r, tuple):
            continue            # the port's int cache index: no tensor
        r = tuple(r)
        if stacked:
            assert r[0] is None, (path, r)
            r = r[1:]
        assert p == r, (path, p, r)
        n += 1
    assert n > 0
    return n


def _check_axes(port_axes, ref_axes_tree):
    for path, p, r, stacked in _pairs(port_axes, ref_axes_tree):
        r = tuple(r)
        if stacked:
            assert r[0] == "layers", (path, r)
            r = r[1:]
        assert tuple(p) == r, (path, p, r)


@functools.lru_cache(maxsize=2)
def _ref_params(arch):
    cfg = ref_get_config(arch)
    return ref_steps.abstract_params(cfg)


def _ref_specs(tree, axes, mesh, rules):
    return jax.tree.map(
        lambda shp, a: ref_axes.spec_for_shape(tuple(shp.shape), a, mesh,
                                               rules),
        tree, axes, is_leaf=_ref_leaf)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_arch_specs_equal_reference(arch, mesh_name):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    m, rm = _meshes(*MESHES[mesh_name])
    rules = steps.rules_for(cfg)
    ref_rules = ref_steps.rules_for(ref_cfg)
    assert tuple(rules) == tuple(ref_rules)

    # parameters: axes leaf for leaf, then the specs
    p_axes, ref_p_axes = steps.params_axes(cfg), ref_steps.params_axes(
        ref_cfg)
    _check_axes(p_axes, ref_p_axes)
    abs_p, ref_abs_p = steps.abstract_params(cfg), _ref_params(arch)
    for path, p, r, stacked in _pairs(abs_p, ref_abs_p):
        assert tuple(p.shape) == tuple(r.shape)[1 if stacked else 0:], path
        assert str(p.dtype).split(".")[-1] == str(r.dtype), path
    state = steps.state_shardings(cfg, m, as_specs=True)
    _check_specs(state.params, _ref_specs(ref_abs_p, ref_p_axes, rm,
                                          ref_rules))

    # optimizer state (stacked as the reference's)
    ref_opt = jax.eval_shape(ref_steps.make_train_step(ref_cfg)[1].init,
                             ref_abs_p)
    ref_o_axes = ref_steps.opt_state_axes(ref_cfg, ref_abs_p, ref_p_axes)
    o_axes = steps.opt_state_axes(cfg, abs_p, p_axes)
    _check_axes(o_axes, ref_o_axes)
    _check_specs(state.opt, _ref_specs(ref_opt, ref_o_axes, rm, ref_rules))

    # every input shape's batch, caches of the decode shapes included
    for name, shape in INPUT_SHAPES.items():
        ref_shape = REF_SHAPES[name]
        if shape.kind == "decode" and not cfg.decode_shapes:
            continue
        specs = steps.input_specs(cfg, shape)
        ref_specs = ref_steps.input_specs(ref_cfg, ref_shape)
        assert set(specs) == set(ref_specs), name
        for key in specs:
            if key == "caches":
                continue
            assert tuple(specs[key].shape) == tuple(ref_specs[key].shape)
            assert str(specs[key].dtype).split(".")[-1] == \
                str(ref_specs[key].dtype), key
        got = steps._batch_shardings(cfg, specs, m, rules, as_specs=True)
        want = ref_steps._batch_shardings(ref_cfg, ref_specs,
                                          _ref_mesh(mesh_name), ref_rules)
        want = jax.tree.map(lambda s: s.spec, want,
                            is_leaf=lambda x: hasattr(x, "spec"))
        for key in specs:
            if key == "caches":
                _check_axes(steps.caches_axes(cfg),
                            ref_steps.caches_axes(ref_cfg))
                for path, p, r, stacked in _pairs(specs[key],
                                                  ref_specs[key]):
                    if isinstance(p, torch.Tensor):
                        assert tuple(p.shape) == tuple(r.shape)[
                            1 if stacked else 0:], (name, path)
                _check_specs(got[key], want[key])
            else:
                assert got[key] == tuple(want[key]), (name, key)


@functools.lru_cache(maxsize=2)
def _ref_mesh(mesh_name):
    """A mesh of placeholder devices for the reference's NamedSharding
    helpers: its abstract mesh, which NamedSharding takes."""
    return compat.abstract_mesh(*MESHES[mesh_name])


def test_module_axes_helpers_equal_reference():
    assert layers.rmsnorm_axes() == ref_layers.rmsnorm_axes()
    assert layers.layernorm_axes() == ref_layers.layernorm_axes()
    assert layers.mlp_axes() == ref_layers.mlp_axes()
    assert layers.embedding_axes() == ref_layers.embedding_axes()
    assert tuple(attn.kv_cache_axes()) == tuple(ref_attn.kv_cache_axes())
    for bias in (False, True):
        assert attn.attention_axes(bias) == ref_attn.attention_axes(bias)
    for shared in (False, True):
        for dense in (False, True):
            assert moe.moe_axes(shared, dense) == \
                ref_moe.moe_axes(shared, dense)
    assert tuple(m2.mamba_cache_axes()) == tuple(ref_m2.mamba_cache_axes())
    assert m2.mamba2_axes() == ref_m2.mamba2_axes()
    assert xl.mlstm_axes() == ref_xl.mlstm_axes()
    assert xl.slstm_axes() == ref_xl.slstm_axes()
    for arch in list_archs():
        cfg = get_config(arch)
        ref_cfg = ref_get_config(arch)
        if cfg.family == "encdec":
            _check_axes(ed.encdec_axes(cfg), ref_ed.encdec_axes(ref_cfg))
        else:
            _check_axes(tf.decoder_lm_axes(cfg),
                        ref_tf.decoder_lm_axes(ref_cfg))


@pytest.mark.parametrize("arch", ["whisper_small", "pixtral_12b"])
def test_frontend_specs_match_reference(arch):
    from repro.models import frontends as ref_fe
    cfg = smoke_variant(get_config(arch))
    ref_cfg = ref_get_config(arch)
    from repro.configs import smoke_variant as ref_smoke
    ref_cfg = ref_smoke(ref_cfg)
    port = (fe.audio_frames_spec(cfg, 3) if cfg.family == "encdec"
            else fe.image_patches_spec(cfg, 3))
    ref = (ref_fe.audio_frames_spec(ref_cfg, 3) if cfg.family == "encdec"
           else ref_fe.image_patches_spec(ref_cfg, 3))
    assert port.device.type == "meta"
    assert tuple(port.shape) == tuple(ref.shape)
    assert str(port.dtype).split(".")[-1] == str(ref.dtype)


def test_placements_on_a_device_mesh():
    """A dim over two mesh axes shards on each, in spec order; an
    unnamed or out-of-order use raises."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding import placements

    class _Mesh:                    # the names and sizes a DeviceMesh has
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 4, 2)

    del dist
    m = _Mesh()
    assert placements((("pod", "data"), None, "model"), m) == \
        (Shard(0), Shard(0), Shard(2))
    assert placements((None, None), m) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        placements((("data", "pod"),), m)
