"""Multi-pod dry run: every (arch x input shape x mesh) run once on fake
DTensors.

The port's counterpart of ``repro.launch.dryrun``. It sets up a fake
world first (``torch.distributed`` with the ``fake`` backend of
``torch.testing._internal.distributed.fake_pg``, 512 ranks, no process
but this one: the counterpart of the reference's 512 placeholder host
devices); it runs in a process of its own, as the reference's does.

For each combination it
  1. builds the production mesh (16x16 single-pod or 2x16x16 multi-pod)
     over the fake world,
  2. assembles the step with ``launch.steps.build`` (abstract inputs,
     shape-aware placements),
  3. runs it once under a ``FakeTensorMode`` on DTensors of fake local
     shards: XLA's compile becomes this run, and an op with no sharding
     rule, or a placement that does not propagate, raises (the
     reference's "compile fails loudly"),
  4. counts one rank's FLOPs, bytes and collectives on its local shards
     (``roofline.counters.StepCounter``: the HLO text walk becomes
     dispatch counters), and its memory as the sharded arguments' bytes
     plus the peak of live fake storage over the step (XLA's
     ``memory_analysis``),
  5. writes the H100 roofline JSON (``roofline.model``).

Attention runs the kernel's plain version, as on every CPU tensor: one
custom op, so its FLOPs count as the reference's einsums do (the full
[S, S] products a head), its bytes as the kernel's q, k, v and output,
and its output in the temp peak; its [S, S] scores, which the kernel on
the card never holds, count in neither.

``status: ok`` says the step ran with every placement propagated;
``fits`` says whether a device's arguments and temp peak fit in the
H100's 80 GB (``roofline.H100.hbm_bytes``).

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2_2b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--both-meshes]
  python -m repro_torch.launch.dryrun --all --skip-existing -o results/dryrun
  python -m repro_torch.launch.dryrun --table -o results/dryrun
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline import H100, StepCounter, analyze

__all__ = ["WORLD", "init_fake_world", "applicable_shapes", "count_step",
           "run_one", "run_extrapolated", "table", "main"]

WORLD = 512


def init_fake_world(world: int = WORLD) -> None:
    """A fake ``torch.distributed`` world of ``world`` ranks in this
    process (rank 0): collectives return at once, and the DeviceMesh
    over it is real. Raises if the fake backend is missing."""
    import torch.distributed as dist
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:       # no fallback: the dry run needs it
        raise RuntimeError("the dry run needs torch's fake process group "
                           "(torch.testing._internal.distributed.fake_pg)"
                           ) from e
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() < world:
            raise RuntimeError(f"a {dist.get_backend()} world of "
                               f"{dist.get_world_size()} is running; the "
                               f"dry run needs a fake world of {world}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    # every Partial -> Replicate over two mesh dims warns once a call
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)


def applicable_shapes(cfg) -> list[str]:
    out = []
    for name, shape in INPUT_SHAPES.items():
        if shape.kind == "decode" and not cfg.decode_shapes:
            continue
        if name == "long_500k" and not cfg.supports_long_context:
            continue
        out.append(name)
    return out


def _local_bytes(tree) -> int:
    from torch.utils import _pytree as pytree

    from repro_torch.sharding.local import is_dtensor
    total = 0
    for t in pytree.tree_leaves(tree):
        if is_dtensor(t):
            t = t._local_tensor
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def count_step(step) -> tuple[StepCounter, dict]:
    """One run of a built step on fake DTensors of its abstract inputs,
    under the counters; ``(counter, memory)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        inputs = step.fake_inputs()
        with StepCounter() as counter:
            out = step(*inputs)
        memory = {"argument_size_in_bytes": _local_bytes(inputs),
                  "output_size_in_bytes": _local_bytes(out),
                  "temp_size_in_bytes": counter.temp_peak}
    return counter, memory


def _fits(memory: dict) -> bool:
    """A device's arguments and temp peak within the card's HBM."""
    return (memory.get("argument_size_in_bytes", 0)
            + memory.get("temp_size_in_bytes", 0)) <= H100.hbm_bytes


def run_one(arch: str, shape_name: str, multi_pod: bool,
            out_dir: str | None = None, verbose: bool = True,
            unroll: bool = False, cfg_override=None,
            constrain_acts: bool = True, tag: str = "",
            rules=None, mesh=None, shape=None) -> dict:
    """Build and run one combination; its report as a dict. ``unroll``
    only names the result (eager PyTorch runs every layer, so the counts
    are those of the whole depth either way). ``mesh`` (a ``DeviceMesh``
    over a running fake world) and ``shape`` (an ``InputShape``) stand in
    for the production mesh and ``INPUT_SHAPES[shape_name]``."""
    if mesh is None:
        init_fake_world()
    cfg = cfg_override or get_config(arch)
    if unroll:
        cfg = dataclasses.replace(cfg, scan_layers=False)
    shape = shape or INPUT_SHAPES[shape_name]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
    mesh_name = ("2x16x16" if multi_pod else "16x16") + \
        ("-unroll" if unroll else "") + tag
    chips = mesh.size()

    # host work only: fake tensors launch nothing on a device
    t0 = time.time()
    step = steps_mod.build(cfg, shape, mesh, rules=rules,
                           constrain_acts=constrain_acts)
    t_lower = time.time() - t0    # lint: allow(timer-no-barrier)
    counter, mem = count_step(step)
    t_compile = time.time() - t0 - t_lower   # lint: allow(timer-no-barrier)

    colls = counter.collectives
    report = analyze(cfg, shape, mesh_name, chips, counter.flops,
                     counter.bytes, counter.collective_bytes, colls, mem)
    result = report.as_dict()
    result.update(lower_sec=t_lower, compile_sec=t_compile, status="ok",
                  fits=_fits(mem))

    if verbose:
        print(f"== {arch} x {shape_name} x {mesh_name} "
              f"(build {t_lower:.1f}s run {t_compile:.1f}s)")
        print(f"   memory: {mem} "
              f"({'fits' if result['fits'] else 'does not fit'} in "
              f"{H100.hbm_bytes / 1e9:.0f} GB)")
        print(f"   counts: flops={counter.flops:.3e} "
              f"bytes={counter.bytes:.3e}")
        print(f"   collectives: "
              f"{ {k: (v['count'], v['bytes']) for k, v in colls.items()} }")
        print(f"   roofline (H100 model): compute={report.compute_sec:.4f}s "
              f"memory={report.memory_sec:.4f}s "
              f"collective={report.collective_sec:.4f}s "
              f"dominant={report.dominant} "
              f"useful_ratio={report.useful_flops_ratio:.3f}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{arch}__{shape_name}__{mesh_name}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(result, f, indent=2, default=str)
    return result


def _depth_pair(cfg) -> tuple[int, int, int]:
    """Two reduced layer counts (L1, L2) whose runs identify the
    per-layer cost, plus the structural period. Layer stacks are
    homogeneous per family, so FLOPs, bytes and collective bytes are
    affine in depth: F(L) = F0 + L * body."""
    if cfg.family == "moe":
        base = cfg.first_dense_layers
        return base + 2, base + 4, 1
    if cfg.family == "hybrid":
        p = cfg.attn_every
        return p, 2 * p, p
    if cfg.family == "ssm":
        p = cfg.slstm_every or 1
        return p, 2 * p, p
    return 2, 4, 1


def run_extrapolated(arch: str, shape_name: str, multi_pod: bool,
                     out_dir: str | None = None,
                     constrain_acts: bool = True, tag: str = "",
                     overrides: dict | None = None, rules=None) -> dict:
    """Full-depth numbers from two reduced-depth runs and an affine fit
    in depth: the way to save time on the deep archs."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    l1, l2, _p = _depth_pair(cfg)
    assert l2 <= cfg.n_layers, (arch, l2)

    def reduced(n):
        upd = dict(n_layers=n, scan_layers=False)
        if cfg.family == "encdec":
            upd["n_encoder_layers"] = n
        return dataclasses.replace(cfg, **upd)

    r1 = run_one(arch, shape_name, multi_pod, verbose=False,
                 cfg_override=reduced(l1), constrain_acts=constrain_acts,
                 rules=rules)
    r2 = run_one(arch, shape_name, multi_pod, verbose=False,
                 cfg_override=reduced(l2), constrain_acts=constrain_acts,
                 rules=rules)

    mesh_name = ("2x16x16" if multi_pod else "16x16") + "-xtrap" + tag
    shape = INPUT_SHAPES[shape_name]
    chips = r1["chips"]
    l_full = cfg.n_layers

    def affine(key):
        slope = (r2[key] - r1[key]) / (l2 - l1)
        return max(r1[key] + slope * (l_full - l1), 0.0)

    flops = affine("hlo_flops_per_device")
    bytes_ = affine("hlo_bytes_per_device")
    coll = affine("collective_bytes_per_device")
    report = analyze(cfg, shape, mesh_name, chips, flops, bytes_, coll,
                     {"extrapolated_from": [l1, l2]},
                     memory_analysis={
                         k: int(max(
                             r1["memory_analysis"].get(k, 0)
                             + (r2["memory_analysis"].get(k, 0)
                                - r1["memory_analysis"].get(k, 0))
                             / (l2 - l1) * (l_full - l1), 0))
                         for k in r1.get("memory_analysis", {})})
    result = report.as_dict()
    result.update(status="ok", fits=_fits(report.memory_analysis),
                  method=f"depth-extrapolated[{l1},{l2}]",
                  lower_sec=r1["lower_sec"] + r2["lower_sec"],
                  compile_sec=r1["compile_sec"] + r2["compile_sec"])
    print(f"== {arch} x {shape_name} x {mesh_name} "
          f"(depths {l1},{l2} -> {l_full}) "
          f"compute={report.compute_sec:.4f}s "
          f"memory={report.memory_sec:.4f}s "
          f"collective={report.collective_sec:.4f}s "
          f"dominant={report.dominant} "
          f"ratio={report.useful_flops_ratio:.3f}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{arch}__{shape_name}__{mesh_name}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(result, f, indent=2, default=str)
    return result


def table(out_dir: str) -> str:
    """A markdown table of the reports under ``out_dir``: one row an
    (arch, mesh), each cell its shapes' values in ``INPUT_SHAPES``'
    order, "/"-separated."""
    rows: dict = {}
    for name in sorted(os.listdir(out_dir)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(out_dir, name)) as f:
            r = json.load(f)
        rows.setdefault((r["arch"], r["mesh"]), {})[r["shape"]] = r
    order = {name: i for i, name in enumerate(INPUT_SHAPES)}
    archs = {a: i for i, a in enumerate(list_archs())}
    mem = r"memory_analysis"

    def cells(runs, fn):
        return " / ".join(fn(runs[k]) for k in sorted(runs, key=order.get))

    out = ["| arch | mesh | shapes | FLOPs | bytes | collective bytes | "
           "args + temp GB | fits 80 GB | compute s | memory s | "
           "collective s | dominant | useful | run s |",
           "| --- " * 14 + "|"]
    for (arch, mesh), runs in sorted(
            rows.items(), key=lambda kv: (archs.get(kv[0][0], 99),
                                          kv[0][1])):
        out.append("| " + " | ".join([
            arch, mesh, cells(runs, lambda r: r["shape"].split("_")[0]),
            cells(runs, lambda r: f"{r['hlo_flops_per_device']:.3g}"),
            cells(runs, lambda r: f"{r['hlo_bytes_per_device']:.3g}"),
            cells(runs, lambda r: f"{r['collective_bytes_per_device']:.3g}"),
            cells(runs, lambda r: "{:.1f} + {:.0f}".format(
                r[mem]["argument_size_in_bytes"] / 1e9,
                r[mem]["temp_size_in_bytes"] / 1e9)),
            cells(runs, lambda r: "yes" if r["fits"] else "no"),
            cells(runs, lambda r: f"{r['compute_sec']:.3g}"),
            cells(runs, lambda r: f"{r['memory_sec']:.3g}"),
            cells(runs, lambda r: f"{r['collective_sec']:.3g}"),
            cells(runs, lambda r: r["dominant"][:4]),
            cells(runs, lambda r: f"{r['useful_flops_ratio']:.2f}"),
            cells(runs, lambda r: f"{r['lower_sec'] + r['compile_sec']:.0f}"),
        ]) + " |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Run every (arch x shape x mesh) step once on fake "
                    "DTensors over a fake world of 512 ranks; write the "
                    "H100 roofline JSON. CPU only, in a process of its own.")
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the 2x16x16 mesh (default 16x16)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("-o", "--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--unroll", action="store_true",
                    help="kept for the reference's interface: eager "
                         "PyTorch runs every layer, so the counts are the "
                         "same with or without it (only the result's "
                         "name changes)")
    ap.add_argument("--extrapolate", action="store_true",
                    help="full-depth numbers from two reduced-depth runs "
                         "and an affine fit in depth (saves time)")
    ap.add_argument("--constrain-acts", dest="constrain_acts",
                    action="store_true", default=True,
                    help="activation-sharding constraints (default ON)")
    ap.add_argument("--no-constrain-acts", dest="constrain_acts",
                    action="store_false")
    ap.add_argument("--moe-impl", default=None,
                    choices=["ragged", "capacity"])
    ap.add_argument("--xlstm-chunk", type=int, default=None)
    ap.add_argument("--attn-chunk", type=int, default=None)
    ap.add_argument("--dp-only", action="store_true",
                    help="replicate the model axis (pure DP rules)")
    ap.add_argument("--remat-policy", default=None,
                    choices=["full", "dots", "none"])
    ap.add_argument("--tag", default="",
                    help="suffix for result filenames (perf experiments)")
    ap.add_argument("--table", action="store_true",
                    help="print a markdown table of the reports under -o "
                         "and exit")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.out))
        return
    init_fake_world()

    combos = []
    archs = list_archs() if args.all or not args.arch else [args.arch]
    for arch in archs:
        cfg = get_config(arch)
        shapes = (applicable_shapes(cfg) if args.all or not args.shape
                  else [args.shape])
        for s in shapes:
            meshes = [args.multi_pod] if not args.both_meshes \
                else [False, True]
            for mp in meshes:
                combos.append((arch, s, mp))

    failures = []
    for arch, s, mp in combos:
        suffix = ("-xtrap" if args.extrapolate else (
            "-unroll" if args.unroll else "")) + args.tag
        mesh_name = ("2x16x16" if mp else "16x16") + suffix
        fname = os.path.join(args.out, f"{arch}__{s}__{mesh_name}.json")
        if args.skip_existing and os.path.exists(fname):
            print(f"-- skip {arch} x {s} x {mesh_name} (exists)")
            continue
        try:
            overrides = {}
            if args.moe_impl and get_config(arch).family == "moe":
                overrides["moe_impl"] = args.moe_impl
            if args.xlstm_chunk is not None \
                    and get_config(arch).family == "ssm":
                overrides["xlstm_chunk"] = args.xlstm_chunk
            if args.attn_chunk is not None:
                overrides["attn_chunk_q"] = args.attn_chunk
            if args.remat_policy is not None:
                overrides["remat_policy"] = args.remat_policy
            rules = None
            if args.dp_only:
                from repro_torch.sharding import DP_ONLY_RULES
                rules = DP_ONLY_RULES
            if args.extrapolate:
                run_extrapolated(arch, s, mp, out_dir=args.out,
                                 constrain_acts=args.constrain_acts,
                                 tag=args.tag, overrides=overrides,
                                 rules=rules)
            else:
                cfg = (dataclasses.replace(get_config(arch), **overrides)
                       if overrides else None)
                run_one(arch, s, mp, out_dir=args.out, unroll=args.unroll,
                        constrain_acts=args.constrain_acts, tag=args.tag,
                        rules=rules, cfg_override=cfg)
        except Exception as e:
            failures.append((arch, s, mesh_name, repr(e)))
            print(f"!! FAIL {arch} x {s} x {mesh_name}: {e}")
            traceback.print_exc()

    print(f"\n{len(combos) - len(failures)}/{len(combos)} combinations "
          f"ran")
    if failures:
        for f in failures:
            print("FAILED:", *f)
        sys.exit(1)


if __name__ == "__main__":
    main()
