"""The port's roofline model against the JAX package's, on the CPU.

- ``model_flops`` equals the reference's for every arch and input shape.
- ``analyze`` on the same counts gives counts / H100 figures, and every
  field of the reference's report (its ``dominant`` rule, its useful
  ratio) when the reference is handed the same figures.
- The H100 figures: 989e12 bf16 FLOP/s dense, 3.35e12 B/s of HBM3,
  450e9 B/s of NVLink 4 one way.
- The counters: a collective's kind by the reference's HLO names, and
  the attention kernel priced one way on both devices: its launches'
  FLOPs and bytes equal what the step counter counts of its plain
  version on a CPU tensor.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import INPUT_SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.roofline import model as ref_model  # noqa: E402
from repro_torch.configs import (INPUT_SHAPES, get_config,  # noqa: E402
                                 list_archs)
from repro_torch.roofline import (H100, HW, StepCounter,  # noqa: E402
                                  analyze, attention_bytes, attention_flops,
                                  collective_kind, model_flops)


def test_h100_figures():
    assert H100 == HW()
    assert H100.peak_flops == 989e12
    assert H100.hbm_bw == 3.35e12
    assert H100.link_bw == 450e9


def test_input_shapes_are_the_reference_s():
    assert list(INPUT_SHAPES) == list(REF_SHAPES)
    for name, s in INPUT_SHAPES.items():
        assert dataclasses.astuple(s) == dataclasses.astuple(REF_SHAPES[name])


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_equal_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        assert model_flops(cfg, shape) == ref_model.model_flops(
            ref_cfg, REF_SHAPES[name]), name


@pytest.mark.parametrize("counts", [
    (3.0e14, 1.0e11, 1.0e9),      # compute-bound
    (1.0e12, 9.0e11, 1.0e9),      # memory-bound
    (1.0e12, 1.0e9, 9.0e11),      # collective-bound
])
@pytest.mark.parametrize("arch", ["gemma2_2b", "kimi_k2_1t_a32b"])
def test_analyze_matches_reference_at_h100_figures(arch, counts):
    flops, nbytes, coll = counts
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    shape, ref_shape = INPUT_SHAPES["train_4k"], REF_SHAPES["train_4k"]
    colls = {"all-reduce": {"count": 3, "bytes": int(coll)}}
    mem = {"argument_size_in_bytes": 7}
    got = analyze(cfg, shape, "16x16", 256, flops, nbytes, coll, colls,
                  mem).as_dict()
    ref_hw = ref_model.HW(peak_flops=H100.peak_flops, hbm_bw=H100.hbm_bw,
                          link_bw=H100.link_bw)
    want = ref_model.analyze(ref_cfg, ref_shape, "16x16", 256, flops,
                             nbytes, coll, colls, mem, hw=ref_hw).as_dict()
    assert got == want
    assert got["compute_sec"] == flops / 989e12
    assert got["memory_sec"] == nbytes / 3.35e12
    assert got["collective_sec"] == coll / 450e9
    terms = {k: got[f"{k}_sec"] for k in ("compute", "memory",
                                          "collective")}
    assert got["dominant"] == max(terms, key=terms.get)


def test_collective_kinds_and_attention_flops():
    import torch
    ops = torch.ops._c10d_functional
    assert collective_kind(ops.all_reduce.default) == "all-reduce"
    assert collective_kind(ops.all_gather_into_tensor.default) == \
        "all-gather"
    assert collective_kind(ops.reduce_scatter_tensor.default) == \
        "reduce-scatter"
    assert collective_kind(ops.all_to_all_single.default) == "all-to-all"
    assert collective_kind(torch.ops.aten.mm.default) is None
    key = (4, 128, 192, 8, 4, 256, "bf16", "global", 50.0)
    assert attention_flops({key: 3}) == 3 * 4 * 4 * 8 * 128 * 192 * 256


@pytest.mark.parametrize("dtype, hkv, softcap", [
    (torch.float32, 2, None), (torch.bfloat16, 4, 30.0)])
def test_attention_priced_one_way_on_both_devices(dtype, hkv, softcap):
    """The plain attention on a CPU tensor counts, under the step
    counter, what the kernel's launches count on the card: FLOPs and
    bytes of one launch of its shape key. Its backward counts the FLOPs
    of the plain ops inside it (``FlopCounterMode`` over
    ``ref.attention_bwd``), and the I/O bytes of seven tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 24, 4, 32), generator=g).to(dtype)
    k, v = (torch.randn((2, 40, hkv, 32), generator=g).to(dtype)
            for _ in range(2))
    with torch.no_grad(), StepCounter() as c:
        ops.flash_attention(q, k, v, softcap=softcap)
    key = ops.shape_key(q, k, None, softcap)
    assert (c.flops, c.bytes) == (attention_flops({key: 1}),
                                  attention_bytes({key: 1}))
    for t in (q, k, v):
        t.requires_grad_(True)
    out = ops.flash_attention(q, k, v, softcap=softcap)
    dout = torch.ones_like(out)
    with StepCounter() as c:
        torch.autograd.grad(out, (q, k, v), dout)
    with FlopCounterMode(display=False) as fc:
        attention_bwd(q.detach(), k.detach(), v.detach(), dout,
                      softcap=softcap)
    assert c.flops == fc.get_total_flops() > 0
    assert c.bytes == sum(2 * t.numel() * t.element_size()
                          for t in (q, k, v)) + sum(
        t.numel() * t.element_size() for t in (dout,))
