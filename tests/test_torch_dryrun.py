"""The port's dry run, roofline counters and gossip dry run, on the CPU.

A fake ``torch.distributed`` world is process-wide, so each world runs
in one subprocess for the module (this file run as a script): a world of
8 ranks as a (4, 2) ``("data", "model")`` mesh, and the gossip dry run's
16. There:

- ``dryrun.run_one`` on the smoke variant of one arch a family (dense,
  moe, hybrid, ssm, encdec, vlm), over its applicable shapes, ends with
  ``status: ok``, fits in the card, and finite, positive counts. The
  input shapes keep their names and kinds at a smaller batch and
  sequence (``SMALL_SHAPES``), to keep the run short;
- at a (1, 1) mesh a step's per-device FLOPs equal ``FlopCounterMode``'s
  count of the unsharded step on the same local tensors, for a train,
  a prefill and a decode step;
- under ``DP_ONLY_RULES`` on (4, 2), with the global batch divisible by
  8, the train step's per-device FLOPs are exactly 1/8 of the unsharded
  step's, and its all-reduce bytes are the float32 gradient bytes of
  the (replicated) parameters, plus 4 bytes for each scalar all-reduce
  of the loss and ``grad_norm``;
- ``gossip_dryrun.measure`` at xlstm's smoke width on 16 fake ranks
  gives the six specs. Every gossip spec's exchanged bytes equal the
  model's ``collective_bytes_per_sync``; the all-reduce's counted
  result bytes are the payload, ``n / (2 (n - 1))`` = 8/15 of the
  model's ring traffic.
"""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
FAMILY_ARCHS = ["gemma2_2b", "kimi_k2_1t_a32b", "zamba2_2p7b",
                "xlstm_125m", "whisper_small", "pixtral_12b"]
# the INPUT_SHAPES, smaller: (seq_len, global_batch) by name
SMALL = {"train_4k": (64, 8), "prefill_32k": (128, 8),
         "decode_32k": (128, 8), "long_500k": (256, 1)}


def _small_shapes():
    import dataclasses

    from repro_torch.configs import INPUT_SHAPES
    return {name: dataclasses.replace(s, seq_len=SMALL[name][0],
                                      global_batch=SMALL[name][1])
            for name, s in INPUT_SHAPES.items()}


# ----------------------------------------------------------------------------
# The jobs, run in a subprocess (``python test_torch_dryrun.py JOB``)
# ----------------------------------------------------------------------------

def _job_world8() -> dict:
    import dataclasses

    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.launch import dryrun, steps
    from repro_torch.sharding import DP_ONLY_RULES
    from repro_torch.sharding.local import is_dtensor

    dryrun.init_fake_world(8)
    torch.set_num_threads(1)
    mesh8 = DeviceMesh("cpu", torch.arange(8).reshape(4, 2),
                       mesh_dim_names=("data", "model"))
    mesh1 = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                       mesh_dim_names=("data", "model"))
    out = {"runs": {}, "one": {}, "dp": {}}
    shapes = _small_shapes()
    for arch in FAMILY_ARCHS:
        cfg = smoke_variant(get_config(arch))
        for name in dryrun.applicable_shapes(cfg):
            r = dryrun.run_one(arch, name, False, verbose=False,
                               cfg_override=cfg, mesh=mesh8,
                               shape=shapes[name])
            out["runs"][f"{arch}/{name}"] = {
                k: r[k] for k in ("status", "fits", "hlo_flops_per_device",
                                  "hlo_bytes_per_device",
                                  "collective_bytes_per_device", "chips",
                                  "compute_sec", "dominant")}

    def plain_flops(cfg, shape):
        """FlopCounterMode over the unsharded step on the local tensors
        of the (1, 1) mesh's fake inputs."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.utils import _pytree as pytree
        st = steps.build(cfg, shape, mesh1)
        fn = {"train": lambda: steps.make_train_step(cfg)[0],
              "prefill": lambda: steps.make_prefill_step(cfg),
              "decode": lambda: steps.make_decode_step(cfg)}[shape.kind]()
        with FakeTensorMode():
            ins = pytree.tree_map(
                lambda t: t._local_tensor if is_dtensor(t) else t,
                st.fake_inputs())
            with FlopCounterMode(display=False) as fc:
                fn(*ins)
        return fc.get_total_flops()

    cfg = smoke_variant(get_config("gemma2_2b"))
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        shape = shapes[name]
        counter, _ = dryrun.count_step(steps.build(cfg, shape, mesh1))
        out["one"][name] = (counter.flops, plain_flops(cfg, shape))
    shape = dataclasses.replace(shapes["train_4k"], global_batch=16)
    counter, _ = dryrun.count_step(steps.build(cfg, shape, mesh8,
                                               rules=DP_ONLY_RULES))
    params = steps.abstract_params(cfg)
    from torch.utils import _pytree as pytree
    leaves = pytree.tree_leaves(params)
    out["dp"] = {"flops": counter.flops,
                 "plain": plain_flops(cfg, shape),
                 "collectives": counter.collectives,
                 "grad_bytes": sum(x.numel() * 4 for x in leaves),
                 "n_leaves": len(leaves)}
    return out


def _job_gossip() -> dict:
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.core import decentralized as dec
    from repro_torch.launch import gossip_dryrun
    cfg = smoke_variant(get_config("xlstm_125m"))
    res = gossip_dryrun.measure("xlstm_125m", cfg=cfg)
    res["allreduce_ratio"] = 16 / (2 * 15)
    res["n"] = gossip_dryrun.N_DATA
    res["exact_want"] = {s: dec.is_exact(dec.parse_sync(s), (16,))
                         for s in gossip_dryrun.SPECS}
    return res


def _run(job: str) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, HERE] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), job],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    assert line, proc.stdout[-2000:]
    return json.loads(line[-1][len("RESULT "):])


@pytest.fixture(scope="module")
def world8():
    return _run("world8")


@pytest.fixture(scope="module")
def gossip():
    return _run("gossip")


# ----------------------------------------------------------------------------
# Tests
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_run_one_every_family_ok(world8, arch):
    runs = {k: v for k, v in world8["runs"].items()
            if k.startswith(arch + "/")}
    assert runs, arch
    for key, r in runs.items():
        assert r["status"] == "ok", key
        assert r["fits"] is True, key
        assert r["chips"] == 8
        assert r["hlo_flops_per_device"] > 0, key
        assert r["hlo_bytes_per_device"] > 0, key
        assert r["compute_sec"] > 0 and r["dominant"] in (
            "compute", "memory", "collective"), key


def test_fits_holds_arguments_and_temp_to_the_card():
    """``fits`` compares a device's arguments plus its temp peak with
    the H100's 80 GB, and nothing else of the report."""
    from repro_torch.launch import dryrun
    from repro_torch.roofline import H100
    assert H100.hbm_bytes == 80e9
    half = int(H100.hbm_bytes) // 2
    assert dryrun._fits({"argument_size_in_bytes": half,
                         "temp_size_in_bytes": half,
                         "output_size_in_bytes": half})
    assert not dryrun._fits({"argument_size_in_bytes": half,
                             "temp_size_in_bytes": half + 1})


def test_decode_shapes_only_where_the_arch_decodes(world8):
    names = {k.split("/")[1] for k in world8["runs"]
             if k.startswith("whisper_small/")}
    assert "decode_32k" in names
    assert "long_500k" not in names


@pytest.mark.parametrize("name", ["train_4k", "prefill_32k", "decode_32k"])
def test_one_rank_flops_equal_flop_counter_mode(world8, name):
    got, want = world8["one"][name]
    assert want > 0
    assert got == want, (got, want)


def test_dp_only_flops_are_an_eighth(world8):
    dp = world8["dp"]
    assert dp["plain"] % 8 == 0
    assert dp["flops"] * 8 == dp["plain"], (dp["flops"], dp["plain"])


def test_dp_only_gradient_all_reduce_bytes(world8):
    dp = world8["dp"]
    ar = dp["collectives"]["all-reduce"]
    scalars = ar["count"] - dp["n_leaves"]
    assert 1 <= scalars <= 4, ar
    assert ar["bytes"] == dp["grad_bytes"] + 4 * scalars, (ar, dp)
    assert set(dp["collectives"]) == {"all-reduce"}


def test_gossip_dryrun_gives_every_spec(gossip):
    from repro_torch.launch.gossip_dryrun import SPECS
    assert list(gossip["specs"]) == SPECS
    payload = gossip["payload_bytes"]
    assert payload > 0
    for spec, rec in gossip["specs"].items():
        assert rec["exact"] == gossip["exact_want"][spec], spec
        if spec == "allreduce":
            # counted: the float32 result of every leaf's all-reduce;
            # the model: a ring all-reduce's 2 B (n - 1) / n
            assert rec["hlo_bytes"] == payload
            assert rec["hlo_bytes"] == pytest.approx(
                rec["model_bytes"] * gossip["allreduce_ratio"], rel=1e-6)
        else:
            assert rec["hlo_bytes"] == rec["model_bytes"], spec
            assert set(rec["collectives"]) == {"collective-permute"}


if __name__ == "__main__":
    job = {"world8": _job_world8, "gossip": _job_gossip}[sys.argv[1]]
    print("RESULT " + json.dumps(job()))
