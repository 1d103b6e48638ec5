"""DELEDA on a device mesh: the paper's algorithm with nodes on separate ranks.

The torch counterpart of ``repro.launch.gossip_sim``. The simulation
substrate (``core/deleda.py``) stacks the n agents on an array axis of one
device. Here each rank of a ``torch.distributed`` world owns a block of
nodes (their documents never leave it: the privacy constraint as a
placement), runs their local G-OEM updates as one fused E-step, and
gossips through :class:`repro_torch.core.comm.MeshComm`: each matching
round is an intra-rank mix (the ``gossip_mix`` kernel) plus one-hop
block exchanges between ranks. A rank moves O(K x V) bytes a pass.

``mesh_shape=(node_devices, vocab_devices)`` lays the world out as a node
x vocab grid (the Scale layer): a rank holds ``[n_local, K, V/vd]``, the
E-step assembles the minibatch's beta columns with one all-reduce over the
vocab group of ``[n_local, B, L, K]`` partials (and one of the ``[n_local,
K]`` denominators), and each vocab shard scatters only its own words. The
``[K, V]`` topic matrix is never gathered.

Single-edge asynchronous gossip has no lockstep analogue, so the mesh
runs random matching rounds, as the reference does.

Run it (``--nprocs`` ranks spawned with ``torch.multiprocessing``):

  PYTHONPATH=src python -m repro_torch.launch.gossip_sim --device cpu \\
      --dist-backend gloo --nprocs 4 --nodes 8 --steps 20
  PYTHONPATH=src python -m repro_torch.launch.gossip_sim --nprocs 1
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import resolve_device
from repro_torch.core import deleda as deleda_mod
from repro_torch.core import estep as estep_mod
from repro_torch.core import evaluation
from repro_torch.core import gossip
from repro_torch.core import threefry as tf3
from repro_torch.core.comm import GossipSchedule, MeshComm, make_grid_mesh
from repro_torch.core.graph import complete_graph, watts_strogatz_graph
from repro_torch.core.lda import LDAConfig, beta_distance, eta_star, init_stats
from repro_torch.core.oem import make_rho_schedule
from repro_torch.data.lda_synthetic import CorpusSpec, make_corpus
from repro_torch.launch.mesh import make_host_mesh

__all__ = ["build_update_step", "run_mesh_deleda", "MeshRun", "launch",
           "main"]

BACKENDS = ("nccl", "gloo")


def build_update_step(lda: LDAConfig, batch_size: int, comm: MeshComm,
                      corpus_layout: str = "dense"):
    """The mesh local-update step of one rank.

    Returns ``update_fn(stats, steps, key, words, mask, alive)`` that
    :func:`run_mesh_deleda` calls once per gossip round, updating the
    rank's block in place: ``stats`` ``[n_local, K, V_local]``, ``steps``
    ``[n_local]`` int32, ``key`` the round's ``[2]`` key, ``words``/``mask``
    ``[n_local, D, L]`` (the unique layout's ids and counts), ``alive``
    ``[n_local]`` host bool. On a 1-D mesh it issues no collective; on a
    grid only the two vocab-group all-reduces of the beta assembly, of
    floating-point tensors shaped ``[n_local, K]`` and ``[n_local, B, L,
    K]``. All local nodes run one fused E-step (one ``lda_gibbs`` launch,
    ``lda_sparse`` in the unique layout).
    """
    if corpus_layout not in ("dense", "unique"):
        raise ValueError(f"corpus_layout must be dense|unique, "
                         f"got {corpus_layout!r}")
    rho_fn = make_rho_schedule("power")
    unique = corpus_layout == "unique"
    grid = comm.vocab_axis is not None

    def update_fn(stats, steps, key, words, mask, alive):
        n_local, d = words.shape[0], words.shape[1]
        dev = stats.device
        # the node-device's stream: the same on every vocab shard of it
        k_dev = tf3.fold_in_data(key, comm.node_index)
        ks = tf3.split(tf3.split(k_dev, n_local))            # [n, 2, 2]
        k_sel, k_gibbs = ks[:, 0], ks[:, 1]
        idx = tf3.randint(k_sel, (batch_size,), 0, d)        # [n, B]
        node = torch.arange(n_local, device=dev)[:, None]
        bw, bm = words[node, idx], mask[node, idx]           # [n, B, L]
        maskf = bm.to(stats.dtype)
        if grid:
            v_local = stats.shape[-1]
            v0 = comm.vocab_index * v_local
            denom = comm.all_reduce((stats + lda.tau).sum(-1),
                                    comm.vocab_axis)         # [n, K]
            lw = bw - v0
            in_shard = (lw >= 0) & (lw < v_local)
            lw = torch.clamp(lw, 0, v_local - 1)
            cols = estep_mod._gather_columns(stats, lw)      # [n, B, L, K]
            part = torch.where(in_shard[..., None], cols + lda.tau,
                               torch.zeros_like(cols))
            beta_w = comm.all_reduce(part, comm.vocab_axis) / \
                denom[:, None, None, :]
            scatter_w, v_scatter = lw, v_local
        else:
            beta_w = estep_mod.beta_w_from_stats_batch(stats, bw, lda.tau)
            scatter_w, v_scatter = bw, lda.vocab_size
        if unique:
            per_pos = estep_mod.fused_sweeps_sparse(lda, k_gibbs, beta_w,
                                                    maskf)
        else:
            per_pos = estep_mod.fused_sweeps(lda, k_gibbs, beta_w, maskf)
        if grid:
            # each vocab shard scatters only its own words' rows
            per_pos = torch.where(in_shard[..., None], per_pos,
                                  torch.zeros_like(per_pos))
        stats_hat = estep_mod.stats_from_per_pos_batch(
            scatter_w, per_pos, v_scatter, maskf)
        t = steps + 1
        rho = rho_fn(t).to(stats.dtype)[:, None, None]
        alive = np.asarray(alive, bool)
        if alive.all():
            stats.mul_(1.0 - rho).add_(stats_hat.mul_(rho))
            steps.copy_(t)
        elif alive.any():
            rows = torch.as_tensor(np.nonzero(alive)[0], device=dev)
            r = rho[rows]
            stats[rows] = (1.0 - r) * stats[rows] + r * stats_hat[rows]
            steps[rows] = t[rows]
        return stats, steps

    return update_fn


class MeshRun(NamedTuple):
    """What :func:`run_mesh_deleda` returns on every rank.

    The reference's (stats, consensus, seconds[, eval_lp]) in its order,
    plus the step counters; ``stats`` and ``steps`` are the global
    ``[n, K, V]`` / ``[n]`` on rank 0 (gathered once, after the timed
    window) and None elsewhere.
    """

    stats: torch.Tensor | None
    consensus: list
    seconds: float
    eval_lp: np.ndarray | None
    steps: torch.Tensor | None


def run_mesh_deleda(lda: LDAConfig, words, mask, graph, n_steps: int,
                    batch_size: int, seed: int = 0, mesh=None,
                    schedule: GossipSchedule | None = None,
                    scenario=None, alive: np.ndarray | None = None,
                    mesh_shape: tuple[int, int] | None = None,
                    eval_every: int = 0,
                    eval_spec: evaluation.EvalSpec | None = None,
                    corpus_layout: str = "dense",
                    member: np.ndarray | None = None,
                    save_every: int = 0,
                    checkpoint_dir: str | None = None,
                    restore_from: str | None = None,
                    device: str | torch.device | None = "cuda") -> MeshRun:
    """DELEDA with nodes on the ranks of the running process group.

    Call it on every rank (an SPMD program) with the same arguments:
    words/mask ``[n, D, L]`` the whole corpus as the launcher drew it
    (each rank keeps its own nodes' rows), ``graph`` the topology the
    matchings are drawn from (``np.random.default_rng(seed)``), or a
    ``schedule``, or a :class:`~repro_torch.core.scenario.Scenario` (its
    compiled schedule, ``alive`` and ``member`` replace them).

    Round t mixes ``partners[t]`` through :class:`MeshComm` and then every
    live node makes a local G-OEM update: the round key is
    ``key(seed * 100003 + t)``, folded with the node-device index, split
    per local node into a select and a Gibbs key, as the reference's. A
    pair with a down or non-member endpoint becomes two self-partners on
    the host, so it crosses no link. The consensus distance is taken at
    every tenth round and the last (over members), without gathering the
    statistic. ``eval_every = E`` records the held-out LP of the first
    ``eval_spec.probe_nodes`` nodes every E rounds (``lda_l2r``; on a grid
    their vocab shards are gathered over the vocab group first).
    ``save_every`` / ``checkpoint_dir`` save the carry as a
    :class:`~repro_torch.core.deleda.TrainState` in the JAX package's
    layout; ``restore_from`` resumes the latest one bit for bit.

    ``mesh_shape=(node_devices, vocab_devices)`` builds a node x vocab
    grid (:func:`~repro_torch.core.comm.make_grid_mesh`); ``mesh`` passes
    a 1-D mesh; neither: :func:`make_host_mesh`. ``device`` is the card
    (the rank's current CUDA device) unless ``"cpu"`` is asked for.
    """
    dev = resolve_device(device)
    if mesh_shape is not None:
        if mesh is not None:
            raise ValueError("pass mesh OR mesh_shape, not both")
        if lda.vocab_size % mesh_shape[1]:
            raise ValueError(f"vocab axis {mesh_shape[1]} must divide "
                             f"vocab_size={lda.vocab_size}")
        mesh = make_grid_mesh(*mesh_shape)
    mesh = mesh or make_host_mesh()
    vocab_axis = "vocab" if mesh_shape is not None else None
    words = torch.as_tensor(words)
    mask = torch.as_tensor(mask)
    n = words.shape[0]
    comm = MeshComm(mesh=mesh, axis_name="data", vocab_axis=vocab_axis)
    if n % comm.n_devices:
        raise ValueError(f"n={n} nodes not divisible by "
                         f"{comm.n_devices} node-devices")
    if scenario is not None:
        if scenario.topology.n_nodes != n:
            raise ValueError(
                f"scenario topology has {scenario.topology.n_nodes} nodes "
                f"but the corpus shards {n}")
        compiled = scenario.compile(np.random.default_rng(seed))
        schedule, alive = compiled.schedule, compiled.alive
        if member is None:
            member = compiled.member
        if n_steps > schedule.n_rounds:
            raise ValueError(f"scenario horizon {schedule.n_rounds} < "
                             f"n_steps {n_steps}")
    if schedule is None:
        schedule = GossipSchedule.draw_matchings(
            graph, n_steps, np.random.default_rng(seed))
    partners = schedule.partners()[:n_steps]             # [T, n]
    if len(partners) < n_steps:
        raise ValueError(f"schedule has {len(partners)} rounds < "
                         f"n_steps {n_steps}")
    if alive is None:
        alive = np.ones((n_steps, n), bool)
    else:
        alive = np.asarray(alive, bool)[:n_steps]
        if alive.shape != (n_steps, n):
            raise ValueError(f"alive must cover [{n_steps}, {n}], "
                             f"got shape {alive.shape}")
    if member is None:
        live = alive
    else:
        member = np.asarray(member, bool)[:n_steps]
        if member.shape != (n_steps, n):
            raise ValueError(f"member must cover [{n_steps}, {n}], "
                             f"got shape {member.shape}")
        live = alive & member
    ids = np.arange(n, dtype=np.int32)
    rows_t = np.arange(n_steps)[:, None]
    pair_up = live & live[rows_t, partners]
    partners = np.where(pair_up, partners, ids)
    if corpus_layout == "unique":
        # once, on the whole corpus, so U is the realized maximum of all
        # ranks (the reference's conversion)
        words, mask = estep_mod.unique_view(words, mask)
    rows = comm.node_rows(n)
    n_local = rows.stop - rows.start
    words = words[rows].to(dev)
    mask = mask[rows].to(dev)
    live_local = live[:, rows]

    k, v = lda.n_topics, lda.vocab_size
    # node i starts from init_stats(split(key(seed), n)[i]); a rank draws
    # its own nodes only
    keys0 = tf3.split(tf3.key(seed, dev), n)[rows]
    stats = comm.vocab_block(init_stats(lda, keys0)).contiguous()
    steps = torch.zeros((n_local,), dtype=torch.int32, device=dev)
    update_fn = build_update_step(lda, batch_size, comm,
                                  corpus_layout=corpus_layout)

    probe, n_probe_local = 0, 0
    if eval_every:
        if eval_spec is None:
            raise ValueError("eval_every > 0 needs an eval_spec "
                             "(repro_torch.core.evaluation.EvalSpec)")
        if n_steps % eval_every != 0:
            raise ValueError(
                f"n_steps={n_steps} must be divisible by "
                f"eval_every={eval_every} (the LP trajectory is "
                f"[n_steps/eval_every, probe_nodes])")
        probe = min(eval_spec.probe_nodes, n)
        ew, em = eval_spec.words, eval_spec.mask
        if eval_spec.layout == "unique":
            ew, em = estep_mod.unique_view(ew, em)
        ew, em = ew.to(dev), em.to(dev)
        # the probe nodes are 0..probe-1: this rank's first rows, if any
        n_probe_local = max(min(rows.stop, probe) - rows.start, 0)
    if save_every and checkpoint_dir is None:
        raise ValueError("save_every > 0 needs a checkpoint_dir")

    def carry_state(t_next):
        """The mesh carry as the simulation's TrainState on rank 0 (None
        elsewhere): per-round keys are indexed by the absolute round, so
        (stats, steps, t) is all a bitwise resume needs."""
        g_stats = comm.gather(stats)
        # counters travel as float64 (exact): every tensor that leaves a
        # rank is floating point
        g_steps = comm.gather(steps.double(), per_node=True)
        if g_stats is None:
            return None
        mrow = (np.ones((n,), bool) if member is None
                else member[min(t_next, n_steps) - 1])
        return deleda_mod.TrainState(
            stats=g_stats.cpu(), steps=g_steps.to(torch.int32).cpu(),
            key=tf3.key(seed), t=t_next, stats_version=t_next,
            member=torch.as_tensor(mrow), cursor=0)

    t_start = 0
    if restore_from is not None:
        like = deleda_mod.TrainState(
            stats=torch.zeros((), dtype=torch.float32).expand(n, k, v),
            steps=torch.zeros((n,), dtype=torch.int32),
            key=torch.zeros((2,), dtype=torch.int64))
        restored = deleda_mod.restore_state(restore_from, like)
        stats = comm.shard(restored.stats).to(dev).contiguous()
        steps = restored.steps[rows].to(dev)
        t_start = int(restored.t)
        if t_start >= n_steps:
            raise ValueError(f"checkpoint at step {t_start} has nothing "
                             f"left to run (n_steps={n_steps})")

    consensus, eval_lp = [], []
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for t in range(t_start, n_steps):
        comm.mix_matching(stats, partners[t])
        update_fn(stats, steps, tf3.key(seed * 100003 + t, dev), words,
                  mask, live_local[t])
        if t % 10 == 0 or t == n_steps - 1:
            consensus.append(float(gossip.consensus_distance_mesh(
                stats, comm, None if member is None else member[t])))
        if eval_every and (t + 1) % eval_every == 0:
            eval_lp.append(_probe_lp(lda, comm, stats[:n_probe_local],
                                     eval_spec, ew, em, rows.start, probe))
        if save_every and (t + 1) % save_every == 0:
            st = carry_state(t + 1)
            if st is not None:
                deleda_mod.save_state(checkpoint_dir, st)
            dist.barrier()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dist.barrier()
    seconds = time.perf_counter() - t0   # lint: allow(timer-no-barrier)

    lp = None
    if eval_every:
        lp = torch.stack(eval_lp).to(torch.float64) if eval_lp else \
            torch.zeros((0, probe), dtype=torch.float64, device=dev)
        lp = comm.all_reduce(lp).cpu().numpy().astype(np.float32)
    g_stats = comm.gather(stats)
    g_steps = comm.gather(steps.double(), per_node=True)
    return MeshRun(stats=g_stats, consensus=consensus, seconds=seconds,
                   eval_lp=lp,
                   steps=None if g_steps is None else g_steps.to(torch.int32))


def _probe_lp(lda, comm, local, spec, ew, em, row0, probe):
    """This round's LP of the probe nodes as a ``[probe]`` float tensor:
    each rank fills the entries of its probe rows ``local`` (from global
    row ``row0``; on a grid the rank of vocab shard 0, after gathering
    their shards over the vocab group), zeros elsewhere; the run sums
    them over the world once at its end."""
    out = torch.zeros((probe,), dtype=torch.float32, device=local.device)
    if comm.vocab_axis is not None:
        local = comm.all_gather(local, comm.vocab_axis, dim=-1)
        if comm.vocab_index != 0:
            return out
    if local.shape[0]:
        out[row0:row0 + local.shape[0]] = evaluation.heldout_lp_from_stats(
            spec.key.to(local.device), ew, em, local, lda.tau, lda.alpha,
            spec.n_particles, spec.layout)
    return out


# ----------------------------------------------------------------------------
# Spawning ranks
# ----------------------------------------------------------------------------

def _rank_entry(rank, world, backend, store_path, out_path, fn, args):
    if backend == "nccl":
        torch.cuda.set_device(rank)
    elif torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    kw = ({"device_id": torch.device("cuda", rank)} if backend == "nccl"
          else {})
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world, **kw)
    try:
        result = fn(*args)
        if rank == 0:
            torch.save(result, out_path)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn, nprocs: int, backend: str = "nccl", args: tuple = (),
           timeout_s: float | None = None):
    """Run ``fn(*args)`` on ``nprocs`` spawned ranks of a new world and
    return rank 0's result.

    The ranks meet through a ``FileStore`` in a temporary directory (no
    port to bind or leave bound); ``fn`` must be importable by name, and
    its result is handed back with ``torch.save``. ``nccl`` needs one card
    per rank; ``gloo`` runs any number of ranks, several on one card. A
    rank that raises ends the others, and the error is raised here; past
    ``timeout_s`` seconds every rank is killed and ``TimeoutError`` raised.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if nprocs > cards:
            raise RuntimeError(
                f"nccl needs one card per rank: {nprocs} ranks asked for, "
                f"{cards} card(s) present; use backend='gloo' for several "
                f"ranks on one card")
    with tempfile.TemporaryDirectory() as tmp:
        store, out = os.path.join(tmp, "store"), os.path.join(tmp, "out.pt")
        ctx = mp.start_processes(_rank_entry, nprocs=nprocs, join=False,
                                 start_method="spawn",
                                 args=(nprocs, backend, store, out, fn, args))
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                    proc.join()
                raise TimeoutError(f"{nprocs} ranks ran past {timeout_s} s")
        return torch.load(out, weights_only=False)


# ----------------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------------

def _paper_lda() -> LDAConfig:
    """The paper's K, V and alpha (``repro.configs.lda_paper``), L=32 and
    10 sweeps (5 burn-in), as the reference's launcher uses them."""
    return LDAConfig(n_topics=5, vocab_size=100, alpha=0.5, doc_len_max=32,
                     n_gibbs=10, n_gibbs_burnin=5)


def _main_rank(args) -> dict | None:
    from repro_torch.core.scenario import GraphSequence, Scenario

    lda = _paper_lda()
    corpus = make_corpus(lda, tf3.key(args.seed),
                         CorpusSpec(n_nodes=args.nodes,
                                    docs_per_node=args.docs_per_node,
                                    n_test=20))
    graph = (complete_graph(args.nodes) if args.graph == "complete"
             else watts_strogatz_graph(args.nodes, 4, 0.3, args.seed))
    scenario = None
    if args.drop > 0 or args.churn > 0:
        scenario = Scenario(topology=GraphSequence.static(graph, args.steps),
                            drop_prob=args.drop, churn=args.churn,
                            name=f"drop{args.drop}-churn{args.churn}")
    run = run_mesh_deleda(
        lda, corpus.words, corpus.mask, graph, args.steps, args.batch,
        args.seed, scenario=scenario, mesh_shape=args.mesh_shape,
        corpus_layout=args.corpus_layout, save_every=args.save_every,
        checkpoint_dir=args.checkpoint_dir, restore_from=args.restore,
        device=args.device)
    if run.stats is None:
        return None
    beta_star = corpus.beta_star.to(run.stats.device)
    d = float(beta_distance(eta_star(run.stats[0]), beta_star))
    return {"graph": graph.name, "lambda2": graph.lambda2(),
            "seconds": run.seconds, "consensus": run.consensus,
            "beta_distance_node0": d, "world": dist.get_world_size()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--graph", default="complete",
                    choices=["complete", "ws"])
    ap.add_argument("--batch", type=int, default=5)
    ap.add_argument("--docs-per-node", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--corpus-layout", default="dense",
                    choices=["dense", "unique"],
                    help="dense per-position sweeps or the unique-token "
                         "(CSR) count-weighted sweeps")
    ap.add_argument("--drop", type=float, default=0.0,
                    help="per-event gossip message drop probability")
    ap.add_argument("--churn", type=float, default=0.0,
                    help="stationary fraction of nodes down at any round")
    ap.add_argument("--mesh-shape", default=None, metavar="NODES,VOCAB",
                    help="2-D node x vocab grid of ranks, e.g. 2,2 "
                         "(needs NODES*VOCAB ranks)")
    ap.add_argument("--save-every", type=int, default=0,
                    help="checkpoint the carried state every N rounds "
                         "(0 = off; needs --checkpoint-dir)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="directory for step_<t>/state.npz checkpoints")
    ap.add_argument("--restore", default=None,
                    help="resume from the latest committed checkpoint in "
                         "this directory (bitwise-identical trajectory)")
    ap.add_argument("--nprocs", type=int, default=1,
                    help="ranks to spawn (torch.multiprocessing, spawn)")
    ap.add_argument("--dist-backend", default="nccl", choices=BACKENDS,
                    help="nccl: one card per rank; gloo: CPU tensors, or "
                         "card blocks staged through pinned host memory")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.mesh_shape:
        try:
            shape = tuple(int(x) for x in args.mesh_shape.split(","))
        except ValueError:
            ap.error(f"--mesh-shape expects NODES,VOCAB integers, "
                     f"got {args.mesh_shape!r}")
        if len(shape) != 2:
            ap.error(f"--mesh-shape expects exactly NODES,VOCAB, "
                     f"got {args.mesh_shape!r}")
        args.mesh_shape = shape
    resolve_device(args.device)
    out = launch(_main_rank, args.nprocs, args.dist_backend, (args,))
    print(f"n={args.nodes} graph={out['graph']} "
          f"lambda2={out['lambda2']:.4f} ranks={out['world']}")
    print(f"{args.steps} steps in {out['seconds']:.1f}s | consensus "
          f"{out['consensus']} | D(beta, beta*) node0 = "
          f"{out['beta_distance_node0']:.4f}")
    return out


if __name__ == "__main__":
    main()
