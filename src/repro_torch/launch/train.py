"""Training launcher of the decoder LMs.

The torch counterpart of ``repro.launch.train``. It trains every decoder
family (dense, moe, hybrid, ssm, vlm; a vlm on its text, as the
reference's); the encoder-decoder trains through
``launch.steps.make_train_step`` (see :func:`main`). Two modes:

  standard       one device: each step one gradient of the whole batch
                 and one optimizer step (``launch.steps.make_train_step``:
                 the config's optimizer, a cosine schedule). The
                 reference's pjit/GSPMD step computes the same function
                 over its mesh.

  decentralized  the paper's contribution generalized to LM training: each
                 node holds ITS OWN parameter copy (one node a rank of
                 ``launch.mesh.make_host_mesh()``'s "data" axis, the ranks
                 spawned here); every step does H local optimizer steps on
                 the node's own batch, then synchronizes the parameters
                 (sync = allreduce | gossip-hypercube[k] | gossip-ring[k],
                 ``core.decentralized.sync_tree_mesh``). Only parameters
                 and the scalar loss leave a rank; its tokens never do.

CPU-friendly: defaults to the smoke variant of the arch, xlstm-125m
as in the reference.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 20 --batch 8 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch granite_3_8b --steps 20 --batch 8 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --mode decentralized --sync "gossip-ring[1]" --local-steps 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2_2b \\
      --full --batch 4 --seq 512

Runs on the GPU unless ``--device cpu``. Ranks: gloo on the CPU; on the
card NCCL when every rank has a card of its own, else gloo ranks sharing
the one card (``--dist-backend`` picks one). The weights are drawn on
the CPU from ``--seed`` and moved (node r of a decentralized run from
the r-th child of the seed), so every device starts from the same
model; ``--init-from`` starts from a params checkpoint instead (either
package's layout), and ``--ckpt`` saves the standard run's params in the
reference's layout.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint import (restore_checkpoint, save_checkpoint,
                                    stored_shapes)
from repro_torch.configs import get_config, list_archs, smoke_variant
from repro_torch.convert import lm_params_from_flat, lm_params_to_flat
from repro_torch.core import decentralized as dec
from repro_torch.data.lm_pipeline import TokenPipeline
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as tf
from repro_torch.optim import make_lr_schedule, make_optimizer

__all__ = ["RunLog", "node_seed", "load_params", "train_standard",
           "train_decentralized", "parse_args", "main"]

BACKENDS = ("auto", "nccl", "gloo")


@dataclasses.dataclass
class RunLog:
    """What a run measured. Losses per step (decentralized: after the H
    local steps, averaged over the nodes), seconds per step (host clock,
    the card drained), and for a decentralized run the seconds and bytes
    of each sync and the parameter spread ``max |x - mean_nodes(x)|`` at
    the logged steps."""

    losses: list[float] = dataclasses.field(default_factory=list)
    grad_norms: list[float] = dataclasses.field(default_factory=list)
    step_seconds: list[float] = dataclasses.field(default_factory=list)
    sync_seconds: list[float] = dataclasses.field(default_factory=list)
    spreads: list[tuple[int, float]] = dataclasses.field(
        default_factory=list)
    tokens_per_step: int = 0
    param_bytes: int = 0
    sync_bytes: int = 0       # handed to torch.distributed per sync, a rank
    napkin_bytes: int = 0     # collective_bytes_per_sync of the params
    peak_bytes: list[int] = dataclasses.field(default_factory=list)
    state: Any = None         # the final TrainState (this rank's node)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def node_seed(seed: int, n_nodes: int, rank: int) -> int:
    """The seed of node ``rank``'s initial draw: the rank-th child of
    ``seed`` (the reference splits its key n ways)."""
    child = np.random.SeedSequence(seed).spawn(n_nodes)[rank]
    return int(child.generate_state(1, np.uint64)[0] >> 1)


def load_params(directory: str, cfg, device) -> dict:
    """Params from the latest checkpoint in ``directory`` (either
    package's layout), checked against ``cfg``."""
    flat = restore_checkpoint(directory, stored_shapes(directory))
    params = lm_params_from_flat(flat, device)
    table = tuple(params["embed"]["table"].shape)
    n_layers = len(params.get("layers", [])) + len(
        params.get("dense_layers", []))
    if (table != (cfg.vocab_size, cfg.d_model)
            or n_layers != cfg.n_layers):
        raise ValueError(f"checkpoint {directory}: embed {table} and "
                         f"{n_layers} layers do not fit "
                         f"{cfg.name} ({cfg.vocab_size}, {cfg.d_model}; "
                         f"{cfg.n_layers} layers)")
    return params


def _init_params(cfg, seed: int, device, init_from=None) -> dict:
    if init_from:
        return load_params(init_from, cfg, device)
    gen = torch.Generator().manual_seed(seed)
    return tf.init_decoder_lm(cfg, gen, device=device)


def _init_state(cfg, seed: int, opt, device, init_from=None):
    params = _init_params(cfg, seed, device, init_from)
    return steps_mod.TrainState(params=params, opt=opt.init(params), step=0)


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def train_standard(cfg, args) -> RunLog:
    dev = resolve_device(args.device)
    train_step, opt = steps_mod.make_train_step(cfg, args.lr)
    state = _init_state(cfg, args.seed, opt, dev, args.init_from)
    pipe = TokenPipeline(cfg.vocab_size, args.seq, args.batch,
                         seed=args.seed)
    log = RunLog(tokens_per_step=args.batch * args.seq,
                 param_bytes=dec.tree_bytes(state.params))
    _sync(dev)
    _reset_peak(dev)
    t_run = time.perf_counter()
    for step, batch in zip(range(args.steps), pipe.batches(dev)):
        t0 = time.perf_counter()
        state, metrics = train_step(state, {"tokens": batch.tokens,
                                            "targets": batch.targets,
                                            "mask": batch.mask})
        log.losses.append(float(metrics["loss"]))       # drains the card
        log.grad_norms.append(float(metrics["grad_norm"]))
        now = time.perf_counter()
        log.step_seconds.append(now - t0)   # lint: allow(timer-no-barrier)
        if step % args.log_every == 0 or step == args.steps - 1:
            run_s = now - t_run   # lint: allow(timer-no-barrier)
            print(f"step {step:4d} loss {log.losses[-1]:.4f} grad_norm "
                  f"{log.grad_norms[-1]:.3f} ({run_s / (step + 1):.2f}"
                  f"s/step)")
    log.peak_bytes = [_peak(dev)]
    if args.ckpt:
        path = save_checkpoint(args.ckpt, lm_params_to_flat(state.params),
                               args.steps)
        print("checkpoint:", path)
    log.state = state
    return log


def train_decentralized(cfg, args, mesh, init_params=None) -> RunLog:
    """This rank's node of a decentralized run over ``mesh``'s "data"
    axis (every rank calls it): H local steps, then the parameter sync.
    ``init_params`` is this node's draw before the consensus mean
    (default: from the seed, or ``args.init_from``); it is updated in
    place. Returns this rank's log, with the node's final TrainState in
    ``log.state``."""
    n = int(mesh.shape["data"])
    r = mesh.index("data")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    spec = dec.parse_sync(args.sync)
    h = args.local_steps
    opt = make_optimizer(cfg.optimizer, make_lr_schedule("constant",
                                                         args.lr))
    params = (init_params if init_params is not None else
              _init_params(cfg, node_seed(args.seed, n, r), dev,
                           args.init_from))
    # start from CONSENSUS: every node the mean of the n draws
    dec.sync_tree_mesh(params, dec.SyncSpec("allreduce"), mesh)
    opt_state = opt.init(params)
    step = 0
    log = RunLog(tokens_per_step=n * h * args.batch * args.seq,
                 param_bytes=dec.tree_bytes(params),
                 sync_bytes=dec.bytes_per_sync(spec, params, n, r),
                 napkin_bytes=dec.collective_bytes_per_sync(
                     spec, dec.tree_bytes(params), (n,)))
    pipe = TokenPipeline(cfg.vocab_size, args.seq, n * h * args.batch,
                         seed=args.seed)
    shp = (n, h, args.batch, args.seq)
    _sync(dev)
    _reset_peak(dev)
    t_run = time.perf_counter()
    for t, batch in zip(range(args.steps), pipe.batches()):
        t0 = time.perf_counter()
        # this node's microbatches only are moved; the rest stay here
        mine = [x.reshape(shp)[r].to(dev) for x in batch]
        b = {}
        for i in range(h):
            b = {"tokens": mine[0][i], "targets": mine[1][i],
                 "mask": mine[2][i]}
            _, grads = steps_mod.value_and_grad(
                lambda p: tf.lm_loss(cfg, p, b), params)
            params, opt_state = opt.update(grads, opt_state, params,
                                           step + i)
            del grads
        with torch.no_grad():       # loss after the updates, last batch
            loss = float(tf.lm_loss(cfg, params, b))
        _sync(dev)
        t1 = time.perf_counter()
        dec.sync_tree_mesh(params, spec, mesh)
        _sync(dev)
        now = time.perf_counter()
        log.sync_seconds.append(now - t1)   # lint: allow(timer-no-barrier)
        step += h
        log.losses.append(dec.scalar_all_reduce(loss) / n)
        log.step_seconds.append(now - t0)   # lint: allow(timer-no-barrier)
        if t % args.log_every == 0 or t == args.steps - 1:
            log.spreads.append((t, dec.spread_mesh(params, mesh)))
            run_s = now - t_run   # lint: allow(timer-no-barrier)
            if r == 0:
                print(f"step {t:4d} loss {log.losses[-1]:.4f} "
                      f"param_spread {log.spreads[-1][1]:.2e} "
                      f"({run_s / (t + 1):.2f}s/step, sync "
                      f"{log.sync_seconds[-1]:.3f}s)", flush=True)
    peaks = [None] * n
    dist.all_gather_object(peaks, _peak(dev))
    log.peak_bytes = peaks
    log.state = steps_mod.TrainState(params, opt_state, step)
    return log


def _decentralized_rank(cfg, args) -> RunLog:
    if args.device == "cpu":     # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // dist.get_world_size()))
    log = train_decentralized(cfg, args, make_host_mesh())
    return dataclasses.replace(log, state=None)    # rank 0's log, no params


def _backend(args) -> str:
    if args.dist_backend != "auto":
        return args.dist_backend
    if args.device == "cpu":
        return "gloo"
    cards = torch.cuda.device_count()
    return "nccl" if cards >= args.nodes else "gloo"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="xlstm_125m", choices=list_archs())
    ap.add_argument("--mode", default="standard",
                    choices=["standard", "decentralized"])
    ap.add_argument("--sync", default="gossip-hypercube",
                    help="allreduce | gossip-hypercube[k] | gossip-ring[k]")
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="use the full config (default: smoke variant)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (widths kept)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--init-from", default=None,
                    help="start from the params checkpoint in this "
                         "directory (either package's layout)")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--nodes", type=int, default=4,
                    help="decentralized: nodes, one rank each")
    ap.add_argument("--dist-backend", default="auto", choices=BACKENDS,
                    help="auto: gloo on the CPU; nccl when every rank has "
                         "a card, else gloo ranks sharing the card")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain torch path)")
    return ap.parse_args(argv)


def config_of(args):
    """The model config the arguments ask for."""
    cfg = get_config(args.arch)
    if not args.full:
        cfg = smoke_variant(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return cfg


def main(argv=None) -> RunLog:
    args = parse_args(argv)
    resolve_device(args.device)
    cfg = config_of(args)
    if cfg.family == "encdec":
        # the reference names examples/whisper_train.py, which neither
        # package has; its own smoke test trains whisper through
        # steps.make_train_step, and so does the port
        raise SystemExit(f"{cfg.name}: the enc-dec arch is not trained "
                         f"here, as in the reference; train it through "
                         f"repro_torch.launch.steps.make_train_step")
    print(f"arch={cfg.name} family={cfg.family} layers={cfg.n_layers} "
          f"params~{cfg.n_params():,} mode={args.mode} "
          f"device={args.device}")
    if args.mode == "standard":
        log = train_standard(cfg, args)
    else:
        from repro_torch.launch.gossip_sim import launch

        backend = _backend(args)
        print(f"nodes={args.nodes} ranks ({backend}) sync={args.sync} "
              f"local_steps={args.local_steps}")
        log = launch(_decentralized_rank, args.nodes, backend, (cfg, args))
    print(f"first loss {log.losses[0]:.4f} -> last loss "
          f"{log.losses[-1]:.4f}")
    return log


if __name__ == "__main__":
    main()
