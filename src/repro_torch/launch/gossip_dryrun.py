"""Gossip against all-reduce parameter sync at production mesh scale,
counted from the ops one rank dispatches (not just the analytic model).

The port's counterpart of ``repro.launch.gossip_dryrun``. For a real
architecture's parameter tree, one synchronization over the 16 ranks of
the production mesh's "data" axis runs under each strategy on a fake
world (``launch.dryrun.init_fake_world``): this rank holds its node's
parameters as float32 fake tensors, ``core.decentralized.sync_tree_mesh``
runs on them through ``MeshComm``, and ``roofline.counters.StepCounter``
counts the bytes this rank hands over. This closes the loop on the
paper's technique at LM scale: the napkin model
``decentralized.collective_bytes_per_sync`` is held against what the
sync sends. An exchange (``batch_isend_irecv``) counts the bytes sent,
an all-reduce its result, as the reference counts HLO results; the
model counts a ring all-reduce's traffic, ``2 B (n - 1) / n``, so there
the two differ by that factor.

  PYTHONPATH=src python -m repro_torch.launch.gossip_dryrun --arch xlstm_125m
"""

from __future__ import annotations

import argparse
import json
import os

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import get_config, list_archs
from repro_torch.core import comm as comm_mod
from repro_torch.core import decentralized as dec
from repro_torch.launch.dryrun import init_fake_world
from repro_torch.launch.steps import abstract_params
from repro_torch.roofline import StepCounter

__all__ = ["SPECS", "N_DATA", "measure", "main"]

SPECS = ["allreduce", "gossip-hypercube", "gossip-hypercube[2]",
         "gossip-hypercube[1]", "gossip-ring[2]", "gossip-ring[1]"]
N_DATA = 16          # the production mesh's "data" axis


def measure(arch: str, out_path: str | None = None, cfg=None) -> dict:
    """One sync a spec of ``arch``'s parameters (or ``cfg``'s) over
    ``N_DATA`` fake ranks; the counted and the modelled bytes a rank
    hands over."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    init_fake_world(N_DATA)
    cfg = cfg or get_config(arch)
    mesh = comm_mod.Mesh((N_DATA,), ("data",)) \
        if torch.distributed.get_world_size() == N_DATA else None
    if mesh is None:
        raise RuntimeError(f"gossip_dryrun needs a fake world of {N_DATA} "
                           f"ranks (init_fake_world({N_DATA}) before any "
                           f"other)")
    abs_p = abstract_params(cfg)
    payload = sum(x.numel() * 4 for x in pytree.tree_leaves(abs_p))
    results = {"arch": arch, "payload_bytes": payload, "specs": {}}
    print(f"{arch}: payload {payload / 1e9:.2f} GB per node, data axis "
          f"{N_DATA}")
    print(f"{'spec':>22s} {'model GB':>10s} {'sent GB':>10s} "
          f"{'sent/model':>10s} {'exact':>6s}")
    for spec_str in SPECS:
        spec = dec.parse_sync(spec_str)
        with FakeTensorMode():
            tree = pytree.tree_map(
                lambda x: torch.empty(x.shape, dtype=torch.float32), abs_p)
            with StepCounter() as counter:
                dec.sync_tree_mesh(tree, spec, mesh, ("data",))
        sent = counter.collective_bytes
        model = dec.collective_bytes_per_sync(spec, payload, (N_DATA,))
        exact = dec.is_exact(spec, (N_DATA,))
        results["specs"][spec_str] = {
            "hlo_bytes": int(sent),
            "model_bytes": int(model),
            "collectives": {k: (int(v["count"]), int(v["bytes"]))
                            for k, v in counter.collectives.items()},
            "exact": exact,
        }
        print(f"{spec_str:>22s} {model / 1e9:10.3f} {sent / 1e9:10.3f} "
              f"{sent / max(model, 1):10.2f} {str(exact):>6s}")
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=2)
        print(f"wrote {out_path}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Count one parameter sync a strategy over 16 fake "
                    "ranks (CPU only, in a process of its own).")
    ap.add_argument("--arch", default="xlstm_125m", choices=list_archs())
    ap.add_argument("-o", "--out", default=None)
    args = ap.parse_args(argv)
    init_fake_world(N_DATA)
    measure(args.arch, args.out or f"results/gossip_sync_{args.arch}.json")


if __name__ == "__main__":
    main()
