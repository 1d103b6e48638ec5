"""Topic-inference serving launcher: one node answering live queries.

The torch counterpart of ``repro.launch.serve_topics``. It trains a G-OEM
statistic (the ``lda_gibbs`` kernel on the card), restores one from a
checkpoint, or serves node ``--restore-node`` of a DELEDA training
checkpoint (``--restore-train``; either package's, dense or written
with ``--restore-vocab-shards`` S > 1), and wraps it in the
staleness-aware :class:`ServingState` cache, and drives a seeded
open-loop Poisson stream of ``"ll"`` queries (the ``lda_l2r`` kernel)
and ``"mixture"`` queries (the ``lda_gibbs`` kernel) through the
continuous-batching :class:`TopicServer`. ``--closed-loop`` submits
every request at once instead, which measures the node's capacity;
``--request-len uniform`` draws request lengths uniformly in
``[2, doc-len]`` so that every bucket carries traffic. ``--gossip-every
N`` publishes a fresh statistic every N slabs mid-serve.

  PYTHONPATH=src python -m repro_torch.launch.serve_topics --requests 200
  PYTHONPATH=src python -m repro_torch.launch.serve_topics --topics 100 \
      --vocab 50000 --doc-len 64 --train-batch 256 --requests 2048 \
      --request-len uniform --closed-loop
  PYTHONPATH=src python -m repro_torch.launch.serve_topics \
      --restore-train /tmp/deleda_ckpt --restore-node 3 --topics 100 \
      --vocab 50000 --doc-len 64 --requests 512 --closed-loop

Runs on the GPU; ``--device cpu`` runs the plain torch path instead.
:func:`main` returns the results and the measured rates as a dict.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.core import deleda, serving
from repro_torch.core import threefry as tf3
from repro_torch.core.lda import LDAConfig, LDAState
from repro_torch.core.oem import run_oem
from repro_torch.data.lda_synthetic import CorpusSpec, make_corpus


def _percentile(xs: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _get_stats(config: LDAConfig, args, corpus,
               device: torch.device) -> tuple[LDAState, float]:
    """The served statistic and the G-OEM training seconds (0 if restored)."""
    key = tf3.key(args.seed, device)
    if args.restore_train:
        return _restore_train_node(config, args, device), 0.0
    if args.restore:
        zero = torch.zeros((), dtype=torch.int32, device=device)
        like = LDAState(stats=torch.zeros((config.n_topics,
                                           config.vocab_size),
                                          device=device),
                        step=zero, stats_version=zero)
        state = restore_checkpoint(args.restore, like)
        print(f"restored checkpoint: step={int(state.step)} "
              f"stats_version={int(state.stats_version)}")
        return state, 0.0
    _sync(device)
    t0 = time.perf_counter()
    trace = run_oem(config, tf3.fold_in_data(key, 1), corpus.flat_words,
                    corpus.flat_mask, n_steps=args.train_steps,
                    batch_size=args.train_batch,
                    record_every=args.train_steps)
    _sync(device)
    train_s = time.perf_counter() - t0   # lint: allow(timer-no-barrier)
    state = trace.state
    print(f"trained G-OEM statistic: {args.train_steps} steps in "
          f"{train_s:.3f}s ({args.train_steps / train_s:.2f} steps/s, "
          f"stats_version={int(state.stats_version)})")
    if args.save:
        path = save_checkpoint(args.save, state, int(state.step))
        print("checkpoint:", path)
    return state, train_s


def _restore_train_node(config: LDAConfig, args,
                        device: torch.device) -> LDAState:
    """Node ``args.restore_node``'s statistic of a DELEDA TrainState
    checkpoint, as a single-node ``LDAState`` on ``device``.

    The checkpoint is restored on the CPU and only the node's row moves.
    No config digest is checked: serving knows the model's shape, not
    the training run's knobs.
    """
    like = deleda.state_like(deleda.DeledaConfig(lda=config),
                             args.restore_nodes, "cpu",
                             vocab_shards=args.restore_vocab_shards)
    tstate = deleda.restore_state(args.restore_train, like)
    i = args.restore_node
    if not 0 <= i < tstate.n_nodes:
        raise SystemExit(f"--restore-node {i} out of range for the "
                         f"{tstate.n_nodes}-node checkpoint")
    if not bool(tstate.member[i]):
        print(f"note: node {i} is not a member at step {tstate.t} — "
              f"serving its frozen statistic")
    state = LDAState(
        stats=tstate.dense_stats()[i].to(device, copy=True),
        step=tstate.steps[i].to(device),
        stats_version=torch.tensor(tstate.stats_version, dtype=torch.int32,
                                   device=device))
    print(f"restored train state: node {i}/{tstate.n_nodes} at round "
          f"{tstate.t} (local steps {int(tstate.steps[i])}, stats_version "
          f"{tstate.stats_version})")
    return state


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--topics", type=int, default=5)
    ap.add_argument("--vocab", type=int, default=1000)
    ap.add_argument("--doc-len", type=int, default=32)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-steps", type=int, default=20)
    ap.add_argument("--train-batch", type=int, default=16)
    ap.add_argument("--save", default=None,
                    help="checkpoint dir to save the trained statistic")
    ap.add_argument("--restore", default=None,
                    help="checkpoint dir to restore instead of training")
    ap.add_argument("--restore-train", default=None, metavar="DIR",
                    help="restore a DELEDA TrainState checkpoint "
                         "(run_deleda save_every, either package) and "
                         "serve one node's statistic")
    ap.add_argument("--restore-node", type=int, default=0,
                    help="which node's statistic to serve (--restore-train)")
    ap.add_argument("--restore-nodes", type=int, default=50,
                    help="node count the train checkpoint was written with")
    ap.add_argument("--restore-vocab-shards", type=int, default=1,
                    help="vocab_shards the train checkpoint was written "
                         "with (the carried stats layout)")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="Poisson arrival rate (requests/sec)")
    ap.add_argument("--closed-loop", action="store_true",
                    help="submit every request at once and drain: the "
                         "node's capacity in req/s (--rate is unused)")
    ap.add_argument("--request-len", default="poisson",
                    choices=("poisson", "uniform"),
                    help="held-out request lengths: Poisson(10) as the "
                         "training corpus (paper S4), or uniform in "
                         "[2, doc-len] as benchmarks/serve_bench.py draws "
                         "them")
    ap.add_argument("--mixture-frac", type=float, default=0.25,
                    help="fraction of requests asking for topic mixtures")
    ap.add_argument("--particles", type=int, default=10)
    ap.add_argument("--buckets", type=int, default=3)
    ap.add_argument("--slab-docs", type=int, default=None)
    ap.add_argument("--backend", default="fused", choices=("fused",),
                    help="the fused evaluator; the serial one is not ported")
    ap.add_argument("--gossip-every", type=int, default=0,
                    help="publish a fresh statistic every N slabs (0 = off)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain torch path")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    config = LDAConfig(n_topics=args.topics, vocab_size=args.vocab,
                       alpha=args.alpha, doc_len_max=args.doc_len,
                       n_gibbs=30, n_gibbs_burnin=15)
    corpus = make_corpus(config,
                         tf3.fold_in_data(tf3.key(args.seed, device), 7),
                         CorpusSpec(n_nodes=10, docs_per_node=20,
                                    n_test=max(args.requests, 100),
                                    test_len_uniform=(args.request_len
                                                      == "uniform")))
    state, train_s = _get_stats(config, args, corpus, device)

    sstate = serving.ServingState(state.stats, tau=config.tau,
                                  version=int(state.stats_version))
    server = serving.TopicServer(
        sstate, alpha=config.alpha, key=tf3.key(args.seed + 1, device),
        doc_len_max=config.doc_len_max, n_particles=args.particles,
        n_buckets=args.buckets, slab_docs=args.slab_docs)
    print(f"server: buckets={server.buckets} "
          f"slab_docs={server.slab_docs} backend={args.backend} "
          f"device={device}")

    # request stream: held-out documents (trimmed to true length), seeded
    # Poisson arrival times, a seeded coin for the query kind
    rng = np.random.default_rng(args.seed)
    test_words = corpus.test_words.cpu().numpy()
    test_lens = corpus.test_mask.cpu().numpy().sum(-1).astype(int)
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, args.requests))
    if args.closed_loop:
        arrivals[:] = 0.0
    kinds = np.where(rng.random(args.requests) < args.mixture_frac,
                     "mixture", "ll")

    results: list[serving.ServeResult] = []
    t0 = time.perf_counter()
    submitted = 0
    while len(results) < args.requests:
        # open-loop pacing clock: intentionally host wall time, arrivals
        # must not wait on device work
        now = time.perf_counter() - t0   # lint: allow(timer-no-barrier)
        while submitted < args.requests and arrivals[submitted] <= now:
            i = submitted % test_words.shape[0]
            server.submit(test_words[i, :max(test_lens[i], 1)],
                          kind=str(kinds[submitted]), doc_id=i)
            submitted += 1
        if server.pending_count():
            results.extend(server.step())
            if args.gossip_every and server.n_slabs % args.gossip_every == 0:
                # a gossip round lands mid-serve: perturb the statistic the
                # way a neighbor averaging would and publish it
                mixed = 0.5 * (sstate.stats + torch.roll(sstate.stats, 1, 0))
                sstate.publish(mixed)
        elif submitted < args.requests:
            # idle until the next arrival — host wall by construction
            # lint: allow(timer-no-barrier)
            time.sleep(max(0.0, arrivals[submitted] - (time.perf_counter()
                                                       - t0)))
    # every result was copied to the host by server.step(), which waits
    # for the device, so the serve wall is closed when the queue drains
    _sync(device)
    wall = time.perf_counter() - t0   # lint: allow(timer-no-barrier)

    lat = [r.latency_s for r in results]
    lls = [r.value for r in results if r.kind == "ll"]
    versions = sorted({r.stats_version for r in results})
    summary = {
        "device": str(device), "results": results, "server": server,
        "serving_state": sstate, "config": config, "corpus": corpus,
        "train_steps_per_s": (args.train_steps / train_s if train_s
                              else None),
        "serve_wall_s": wall, "req_per_s": len(results) / wall,
        "p50_ms": 1e3 * _percentile(lat, 50),
        "p99_ms": 1e3 * _percentile(lat, 99),
    }
    offered = "closed loop" if args.closed_loop else f"{args.rate:.0f}/s"
    print(f"served {len(results)} requests in {wall:.2f}s "
          f"({summary['req_per_s']:.1f} req/s offered {offered})")
    print(f"latency p50 {summary['p50_ms']:.1f}ms "
          f"p99 {summary['p99_ms']:.1f}ms | "
          f"slabs {server.n_slabs} occupancy {server.mean_occupancy:.2f}")
    print(f"stats_versions answered: {versions} "
          f"(cache derivations: {sstate.n_derivations})")
    if lls:
        print(f"mean held-out LL {np.mean(lls):.3f} over {len(lls)} docs")
    mix = next((r for r in results if r.kind == "mixture"), None)
    if mix is not None:
        top = np.argsort(mix.value)[::-1][:3]
        print(f"sample mixture doc={mix.doc_id}: top topics {top.tolist()} "
              f"weights {np.asarray(mix.value)[top].round(3).tolist()}")
    return summary


if __name__ == "__main__":
    main()
