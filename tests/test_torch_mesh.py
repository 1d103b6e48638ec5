"""The port's DELEDA on a mesh of ranks against the JAX package, on gloo.

The reference's own mesh launcher stops on the installed jax (a shard_map
varying-axes check rejects its scan carry; ROADMAP R2), so
``run_mesh_deleda`` is held against a composition, in this process, of
the reference's public functions in the order of its ``update_fn``
(``src/repro/launch/gossip_sim.py``): ``jax.random.key(seed * 100003 + t)``,
``fold_in`` by node-device index, ``split``, ``randint``,
``estep.beta_w_from_stats`` (on a grid the per-shard denominators summed
in shard order, as the port's all-reduce of two shards gives),
``estep.fused_sweeps`` / ``fused_sweeps_sparse``,
``estep.stats_from_per_pos``, ``oem.make_rho_schedule("power")``, with
``comm.DenseSimComm().mix_matching`` for the gossip, at the golden test's
tolerances (steps exact, mass rtol 1e-4, every entry rtol 3e-3, consensus
rtol 1e-3, LP rtol 1e-5). Every run held against the reference starts
from the reference's initial statistic, restored from a step-0
checkpoint.

The ranks are spawned by ``gossip_sim.launch`` (gloo, start method
"spawn") once per world size for the whole module; they import this file,
so it imports no JAX at module level: the reference runs only here.
"""

import dataclasses
import os
import shutil
import sys
import tempfile

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.core import comm, deleda, evaluation, gossip  # noqa: E402
from repro_torch.core import lda as port_lda  # noqa: E402
from repro_torch.core.graph import complete_graph  # noqa: E402
from repro_torch.core.scenario import GraphSequence, Scenario  # noqa: E402
from repro_torch.launch import gossip_sim  # noqa: E402

KW = dict(n_topics=3, vocab_size=24, alpha=0.5, doc_len_max=8, n_gibbs=4,
          n_gibbs_burnin=2)
N, D, B, T, SEED, EVAL, PROBE = 8, 4, 2, 12, 3, 6, 2
L = KW["doc_len_max"]
MIX_ROUNDS = 5
LAUNCH_TIMEOUT_S = 300          # a hung rank fails its fixture, not the run
SCEN = dict(drop_prob=0.3, churn=0.3, churn_mean_down=3.0)


# ---------------------------------------------------------------------------
# What the ranks run (no JAX here)
# ---------------------------------------------------------------------------

def _scenario():
    return Scenario(topology=GraphSequence.static(complete_graph(N), T),
                    name="drops-churn", **SCEN)


def _spec(data, layout):
    return evaluation.EvalSpec(
        words=torch.from_numpy(data["test_words"]).long(),
        mask=torch.from_numpy(data["test_mask"]),
        key=torch.from_numpy(data["eval_key"]), n_particles=3,
        probe_nodes=PROBE, layout=layout)


def _run(data, layout="dense", mesh_shape=None, flat=False, scenario=False,
         eval_every=0, **kw):
    lda = port_lda.LDAConfig(**KW)
    kw.setdefault("restore_from", data["init_dir"])
    out = gossip_sim.run_mesh_deleda(
        lda, torch.from_numpy(data["words"]).long(),
        torch.from_numpy(data["mask"]), complete_graph(N), T, B, seed=SEED,
        mesh=comm.make_grid_mesh(dist.get_world_size(), 1) if flat else None,
        mesh_shape=mesh_shape, corpus_layout=layout,
        scenario=_scenario() if scenario else None, eval_every=eval_every,
        eval_spec=_spec(data, layout) if eval_every else None, device="cpu",
        **kw)
    if out.stats is None:
        return None
    return {"stats": out.stats.numpy(), "steps": out.steps.numpy(),
            "consensus": np.asarray(out.consensus),
            "eval_lp": out.eval_lp}


def _mix(data, grid, shards):
    """Five matchings mixed by MeshComm; the gathered global result."""
    if grid is None:
        mc = comm.MeshComm()
    else:
        mc = comm.MeshComm(comm.make_grid_mesh(*grid), vocab_axis="vocab")
    stats = torch.from_numpy(data["mix_stats"])
    n, k, v = stats.shape
    if shards:
        stats = stats.reshape(n, k, shards, v // shards)
    local = mc.shard(stats).clone()
    for t in range(MIX_ROUNDS):
        mc.mix_matching(local, data["mix_sched"][t])
    out = mc.gather(local)
    return None if out is None else {
        "stats": out.reshape(n, k, v).numpy(),
        "bytes": mc.bytes_per_round((n, k, v), 4, data["mix_sched"][0]),
        "bytes_sharded": mc.bytes_per_round((n, k, 4, v // 4), 4,
                                            data["mix_sched"][0])}


def _resume(data, layout, mesh_shape=None):
    """Save every 6 rounds, delete step 12, resume from step 6; and the
    uninterrupted run."""
    ckpt = data["ckpt_dirs"][f"{layout}-{mesh_shape}"]
    full = _run(data, layout, mesh_shape, eval_every=EVAL)
    _run(data, layout, mesh_shape, eval_every=EVAL, save_every=EVAL,
         checkpoint_dir=ckpt)
    if dist.get_rank() == 0:
        shutil.rmtree(os.path.join(ckpt, f"step_{T:08d}"))
    dist.barrier()
    resumed = _run(data, layout, mesh_shape, eval_every=EVAL,
                   restore_from=ckpt)
    return None if full is None else {"full": full, "resumed": resumed}


class _Recorder:
    """Records every tensor the port hands to ``torch.distributed``."""

    NAMES = ("all_reduce", "all_gather", "gather", "batch_isend_irecv",
             "broadcast", "reduce", "scatter", "all_to_all",
             "all_gather_into_tensor", "reduce_scatter_tensor")

    def __init__(self):
        self.records, self.phase, self.orig = [], "loop", {}

    def _tensors(self, name, args, kwargs):
        if name == "batch_isend_irecv":
            return [op.tensor for op in args[0]]
        if name == "all_gather":
            return [args[1]]
        return [args[0] if args else kwargs["tensor"]]

    def _wrap(self, name, fn):
        def recorded(*args, **kwargs):
            group = kwargs.get("group")
            ranks = (tuple(range(dist.get_world_size())) if group is None
                     else tuple(dist.get_process_group_ranks(group)))
            for t in self._tensors(name, args, kwargs):
                self.records.append((self.phase, name, str(t.dtype),
                                     t.is_floating_point(), tuple(t.shape),
                                     ranks))
            return fn(*args, **kwargs)
        return recorded

    def __enter__(self):
        for name in self.NAMES:
            self.orig[name] = getattr(dist, name)
            setattr(dist, name, self._wrap(name, self.orig[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(dist, name, fn)


def _privacy(data, mesh_shape):
    """run_mesh_deleda under the recorder; update_fn's calls are marked."""
    build = gossip_sim.build_update_step
    rec = _Recorder()

    def marked(*args, **kwargs):
        fn = build(*args, **kwargs)

        def update(*a):
            rec.phase = "update"
            try:
                return fn(*a)
            finally:
                rec.phase = "loop"
        return update

    gossip_sim.build_update_step = marked
    try:
        with rec:
            _run(data, mesh_shape=mesh_shape, eval_every=EVAL,
                 restore_from=None)
    finally:
        gossip_sim.build_update_step = build
    mine = {"rank": dist.get_rank(), "records": rec.records}
    if mesh_shape is not None:
        mine["vocab_line"] = tuple(comm.make_grid_mesh(*mesh_shape)
                                   .line("vocab"))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def _exchanges(data, layout):
    """The scenario run, counting the block exchanges of each rank."""
    calls = []
    real = gossip.exchange

    def counted(x, peer, **kw):
        calls.append(peer)
        return real(x, peer, **kw)

    gossip.exchange = counted
    try:
        out = _run(data, layout, scenario=True)
    finally:
        gossip.exchange = real
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, len(calls))
    return None if out is None else dict(out, exchanges=every)


def _round(data):
    """gossip_round_mesh with one node a rank: a tensor and a dict tree,
    one matching with a self-partner (rank 3 keeps its values)."""
    me = dist.get_rank()
    x = torch.from_numpy(data["round_x"][me])
    tree = {"a": x, "b": 2 * x}
    p = np.array([1, 0, 2, 3])
    got = (gossip.gossip_round_mesh(x, p),
           gossip.gossip_round_mesh(tree, p))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (got[0].numpy(), got[1]["a"].numpy(),
                                   got[1]["b"].numpy()))
    return every


_JOBS = {"run": _run, "mix": _mix, "resume": _resume, "privacy": _privacy,
         "exchanges": _exchanges, "round": _round}


def _rank_jobs(jobs, data):
    torch.set_num_threads(1)
    out = {name: _JOBS[kind](data, **kw) for name, kind, kw in jobs}
    # the ranks ran the port alone: nothing pulled JAX into them
    assert "jax" not in sys.modules and "repro.core" not in sys.modules
    return out


# ---------------------------------------------------------------------------
# The reference, composed in this process
# ---------------------------------------------------------------------------

def _ref():
    import jax
    import jax.numpy as jnp

    from repro.core import comm as r_comm
    from repro.core import deleda as r_deleda
    from repro.core import estep as r_estep
    from repro.core import evaluation as r_eval
    from repro.core import gossip as r_gossip
    from repro.core import lda as r_lda
    from repro.core import oem as r_oem
    from repro.data import lda_synthetic as r_synth
    import torch_parity
    return dict(jax=jax, jnp=jnp, comm=r_comm, deleda=r_deleda,
                estep=r_estep, eval=r_eval, gossip=r_gossip, lda=r_lda,
                oem=r_oem, synth=r_synth, parity=torch_parity)


def _guard(partners, live):
    ids = np.arange(partners.shape[1], dtype=partners.dtype)
    rows = np.arange(len(partners))[:, None]
    return np.where(live & live[rows, partners], partners, ids)


_STEPS = {}


def _ref_block_step(n_local, n_vocab, layout):
    """The reference's update_fn for one node-device's block, jitted."""
    cache_key = (n_local, n_vocab, layout)
    if cache_key in _STEPS:
        return _STEPS[cache_key]
    r = _ref()
    jax, jnp = r["jax"], r["jnp"]
    lda = r["lda"].LDAConfig(**KW)
    if layout == "unique":
        estep = r["estep"].get_sparse_estep("dense")
        sweeps = r["estep"].fused_sweeps_sparse
    else:
        estep = r["estep"].get_estep("dense")
        sweeps = r["estep"].fused_sweeps
    rho_fn = r["oem"].make_rho_schedule("power")
    vl = lda.vocab_size // n_vocab

    def step(st, steps, key, d, words, mask, al):
        kd = jax.random.fold_in(key, d)
        ks = jax.vmap(jax.random.split)(jax.random.split(kd, n_local))
        idx = jax.vmap(lambda k: jax.random.randint(k, (B,), 0, D))(
            ks[:, 0])
        bw = jax.vmap(lambda w, i: w[i])(words, idx)
        maskf = jax.vmap(lambda m, i: m[i])(mask, idx).astype(jnp.float32)
        if n_vocab == 1:
            beta_w = jax.vmap(lambda s, w: r["estep"].beta_w_from_stats(
                s, w, lda.tau))(st, bw)
        else:
            denom = (st[..., :vl] + lda.tau).sum(-1)
            for i in range(1, n_vocab):
                denom = denom + (st[..., i * vl:(i + 1) * vl]
                                 + lda.tau).sum(-1)
            cols = jax.vmap(lambda s, w: jnp.moveaxis(s[:, w], 0, -1))(
                st, bw)
            beta_w = (cols + lda.tau) / denom[:, None, None]
        per_pos = sweeps(estep, lda, ks[:, 1], beta_w, maskf)
        hat = jax.vmap(lambda w, p, m: r["estep"].stats_from_per_pos(
            w, p, lda.vocab_size, m))(bw, per_pos, maskf)
        rho = rho_fn(steps + 1).astype(jnp.float32)[:, None, None]
        new = (1 - rho) * st + rho * hat
        return (jnp.where(al[:, None, None], new, st),
                jnp.where(al, steps + 1, steps))

    _STEPS[cache_key] = jax.jit(step)
    return _STEPS[cache_key]


def _compose(data, n_dev, n_vocab=1, layout="dense", partners=None,
             live=None, eval_every=0):
    """The reference's update_fn, node-device block by block, in
    reference mode. Returns stats, steps, consensus and the LP trajectory."""
    r = _ref()
    jax, jnp = r["jax"], r["jnp"]
    lda = r["lda"].LDAConfig(**KW)
    n_local = N // n_dev
    with r["parity"].reference_mode():
        step = _ref_block_step(n_local, n_vocab, layout)
        words, mask = jnp.asarray(data["words"]), jnp.asarray(data["mask"])
        ew, em = (jnp.asarray(data["test_words"]),
                  jnp.asarray(data["test_mask"]))
        if layout == "unique":
            words, mask = r["estep"].unique_view(words, mask)
            ew, em = r["estep"].unique_view(ew, em)
        if live is None:
            live = np.ones((T, N), bool)
        partners = _guard(partners, live)
        stats = jnp.asarray(data["stats0"])
        steps = jnp.zeros((N,), jnp.int32)
        mix = r["comm"].DenseSimComm()
        ekey = jax.random.wrap_key_data(
            jnp.asarray(data["eval_key"].astype(np.uint32)))
        lp_fn = jax.jit(jax.vmap(lambda st: r["eval"].heldout_lp_from_stats(
            ekey, ew, em, st, lda.tau, lda.alpha, 3, layout)))
        cons, lps = [], []
        for t in range(T):
            stats = mix.mix_matching(stats, partners[t])
            key = jax.random.key(SEED * 100003 + t)
            out = [step(stats[d * n_local:(d + 1) * n_local],
                        steps[d * n_local:(d + 1) * n_local], key, d,
                        words[d * n_local:(d + 1) * n_local],
                        mask[d * n_local:(d + 1) * n_local],
                        jnp.asarray(live[t, d * n_local:(d + 1) * n_local]))
                   for d in range(n_dev)]
            stats = jnp.concatenate([o[0] for o in out])
            steps = jnp.concatenate([o[1] for o in out])
            if t % 10 == 0 or t == T - 1:
                cons.append(float(r["gossip"].consensus_distance(stats)))
            if eval_every and (t + 1) % eval_every == 0:
                lps.append(np.asarray(lp_fn(stats[:PROBE])))
        return {"stats": np.asarray(stats), "steps": np.asarray(steps),
                "consensus": np.asarray(cons),
                "eval_lp": np.asarray(lps, np.float32) if lps else None}


def _assert_matches(got, want):
    """The golden tolerances."""
    np.testing.assert_array_equal(got["steps"], want["steps"])
    np.testing.assert_allclose(got["stats"].astype(np.float64).sum(),
                               want["stats"].astype(np.float64).sum(),
                               rtol=1e-4)
    np.testing.assert_allclose(got["stats"], want["stats"], rtol=3e-3,
                               atol=1e-5)
    np.testing.assert_allclose(got["consensus"], want["consensus"],
                               rtol=1e-3, atol=1e-5)
    if want["eval_lp"] is not None:
        np.testing.assert_allclose(got["eval_lp"], want["eval_lp"],
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# Fixtures: the data, then one spawn per world size
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    r = _ref()
    jax = r["jax"]
    with r["parity"].reference_mode():
        corpus = r["synth"].make_corpus(
            r["lda"].LDAConfig(**KW), jax.random.key(0),
            r["synth"].CorpusSpec(n_nodes=N, docs_per_node=D, n_test=4))
        stats0 = np.array(jax.vmap(
            lambda k: r["lda"].init_stats(r["lda"].LDAConfig(**KW), k))(
            jax.random.split(jax.random.key(SEED), N)))
        eval_key = np.asarray(jax.random.key_data(jax.random.key(7)))
    tmp = tempfile.mkdtemp(prefix="mesh_test_")
    init_dir = os.path.join(tmp, "init")
    # the reference's initial statistic as a step-0 TrainState
    st = deleda.state_like(deleda.DeledaConfig(lda=port_lda.LDAConfig(**KW)),
                           N, "cpu")
    deleda.save_state(init_dir, dataclasses.replace(
        st, stats=torch.from_numpy(stats0), key=torch.zeros(2).long()))
    rng = np.random.default_rng(5)
    mix_sched = comm.GossipSchedule.draw_matchings(
        complete_graph(N), MIX_ROUNDS, rng).data
    mix_sched[1] = np.arange(N)                  # an idle round
    row = mix_sched[2]                           # two idle pairs
    for i in (0, 1):
        row[row[i]], row[i] = row[i], i
    out = {"words": np.asarray(corpus.words).astype(np.int64),
           "mask": np.asarray(corpus.mask),
           "test_words": np.asarray(corpus.test_words).astype(np.int64),
           "test_mask": np.asarray(corpus.test_mask), "stats0": stats0,
           "eval_key": eval_key.astype(np.int64), "init_dir": init_dir,
           "mix_stats": rng.random((N, 3, 32), dtype=np.float32),
           "round_x": rng.random((4, 3, 5), dtype=np.float32),
           "mix_sched": mix_sched,
           "partners": comm.GossipSchedule.draw_matchings(
               complete_graph(N), T, np.random.default_rng(SEED)).data,
           "ckpt_dirs": {f"{lay}-{ms}": os.path.join(tmp, f"{lay}-{ms}")
                         for lay in ("dense", "unique")
                         for ms in (None, (2, 2))}}
    yield out
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.fixture(scope="module")
def world1(data):
    jobs = [("dense", "run", {}), ("unique", "run", {"layout": "unique"})]
    return gossip_sim.launch(_rank_jobs, 1, "gloo", (jobs, data),
                             timeout_s=LAUNCH_TIMEOUT_S)


@pytest.fixture(scope="module")
def world2(data):
    jobs = [("flat", "run", {"flat": True})]
    return gossip_sim.launch(_rank_jobs, 2, "gloo", (jobs, data),
                             timeout_s=LAUNCH_TIMEOUT_S)


@pytest.fixture(scope="module")
def world4(data):
    jobs = [("mix-1d", "mix", {"grid": None, "shards": None}),
            ("mix-1d-s4", "mix", {"grid": None, "shards": 4}),
            ("mix-grid", "mix", {"grid": (2, 2), "shards": None}),
            ("mix-grid-s4", "mix", {"grid": (2, 2), "shards": 4}),
            ("mix-flat", "mix", {"grid": (4, 1), "shards": None}),
            ("round", "round", {}),
            ("dense", "run", {"eval_every": EVAL}),
            ("unique", "run", {"layout": "unique", "eval_every": EVAL}),
            ("grid", "run", {"mesh_shape": (2, 2), "eval_every": EVAL}),
            ("grid-unique", "run", {"mesh_shape": (2, 2),
                                    "layout": "unique"}),
            ("scenario", "exchanges", {"layout": "dense"}),
            ("resume", "resume", {"layout": "dense"}),
            ("resume-grid-unique", "resume", {"layout": "unique",
                                              "mesh_shape": (2, 2)}),
            ("privacy-1d", "privacy", {"mesh_shape": None}),
            ("privacy-grid", "privacy", {"mesh_shape": (2, 2)})]
    return gossip_sim.launch(_rank_jobs, 4, "gloo", (jobs, data),
                             timeout_s=LAUNCH_TIMEOUT_S)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def _random_matching(rng, n, self_frac):
    perm = rng.permutation(n)
    p = np.arange(n, dtype=np.int32)
    for a, b in zip(perm[0::2], perm[1::2]):
        if rng.random() >= self_frac:
            p[a], p[b] = b, a
    return p


@pytest.mark.parametrize("n", [4, 8, 12, 16])
@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_route_matching_equals_reference(n, n_dev):
    ref_comm = _ref()["comm"]
    rng = np.random.default_rng(100 * n + n_dev)
    for trial in range(6):
        p = _random_matching(rng, n, self_frac=[0.0, 0.3, 1.0][trial % 3])
        (w_src, w_act), w_passes = ref_comm._route_matching(p, n_dev)
        (g_src, g_act), g_passes = comm._route_matching(p, n_dev)
        np.testing.assert_array_equal(g_src, w_src)
        np.testing.assert_array_equal(g_act, w_act)
        assert len(g_passes) == len(w_passes)
        for (gp, gs, ga), (wp, ws, wa) in zip(g_passes, w_passes):
            assert gp == wp
            np.testing.assert_array_equal(gs, ws)
            np.testing.assert_array_equal(ga, wa)


@pytest.mark.parametrize("n,n_dev", [(10, 4), (6, 4), (9, 2)])
def test_route_matching_refuses_indivisible_n(n, n_dev):
    ref_comm = _ref()["comm"]
    p = np.arange(n, dtype=np.int32)
    with pytest.raises(ValueError) as want:
        ref_comm._route_matching(p, n_dev)
    with pytest.raises(ValueError) as got:
        comm._route_matching(p, n_dev)
    assert str(got.value) == str(want.value)


def test_bytes_per_round_follows_reference(world4, data):
    """The grid's total equals the flat mesh's, the vocab-sharded layout's
    equals the dense one's, and the number is the reference's formula."""
    p = data["mix_sched"][0]
    _, passes = comm._route_matching(p, 4)
    block = (N // 4) * 3 * 32 * 4
    assert world4["mix-1d"]["bytes"] == sum(len(pm) for pm, _, _ in
                                            passes) * block
    _, passes2 = comm._route_matching(p, 2)
    # two vocab shards each move half a block: a (2, 1) mesh's total
    assert world4["mix-grid"]["bytes"] == sum(
        len(pm) * (N // 2) * 3 * 32 * 4 for pm, _, _ in passes2)
    assert world4["mix-grid"]["bytes_sharded"] == world4["mix-grid"]["bytes"]
    assert world4["mix-1d-s4"]["bytes_sharded"] == world4["mix-1d"]["bytes"]


# ---------------------------------------------------------------------------
# Mixing on gloo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["mix-1d", "mix-1d-s4", "mix-grid",
                                  "mix-grid-s4", "mix-flat"])
def test_mesh_mixing_matches_dense_sim_comm(world4, data, case):
    r = _ref()
    jnp = r["jnp"]
    want = jnp.asarray(data["mix_stats"])
    dense = r["comm"].DenseSimComm()
    for t in range(MIX_ROUNDS):
        want = dense.mix_matching(want, data["mix_sched"][t])
    err = np.abs(world4[case]["stats"] - np.asarray(want)).max()
    assert err < 1e-6, err


def test_gossip_round_mesh_matches_reference_mix(world4, data):
    """One rank a node: the reference's mix_matching of the stacked
    values, for a tensor and each leaf of a dict."""
    r = _ref()
    p = np.array([1, 0, 2, 3], np.int32)
    with r["parity"].reference_mode():
        want = np.asarray(r["gossip"].mix_matching(
            r["jnp"].asarray(data["round_x"]), p))
    for rank, (x, a, b) in enumerate(world4["round"]):
        np.testing.assert_array_equal(x, want[rank])
        np.testing.assert_array_equal(a, want[rank])
        np.testing.assert_allclose(b, 2 * want[rank], rtol=1e-7)
    np.testing.assert_array_equal(world4["round"][3][0],
                                  data["round_x"][3])


# ---------------------------------------------------------------------------
# The launcher at level 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["dense", "unique"])
def test_world1_matches_composed_reference(world1, data, layout):
    want = _compose(data, 1, layout=layout, partners=data["partners"])
    _assert_matches(world1[layout], want)


@pytest.mark.parametrize("name,layout,n_vocab,eval_every", [
    ("dense", "dense", 1, EVAL), ("unique", "unique", 1, EVAL),
    ("grid", "dense", 2, EVAL), ("grid-unique", "unique", 2, 0)])
def test_world4_matches_composed_reference(world4, data, name, layout,
                                           n_vocab, eval_every):
    n_dev = 4 // n_vocab
    want = _compose(data, n_dev, n_vocab, layout, data["partners"],
                    eval_every=eval_every)
    got = world4[name]
    _assert_matches(got, want)
    if eval_every:
        assert got["eval_lp"].shape == (T // EVAL, PROBE)


def test_grid_equals_flat_mesh(world2, world4):
    """The reference's own bounds (tests/test_scale.py): stats 1e-5,
    consensus rtol 1e-4."""
    flat, grid = world2["flat"], world4["grid"]
    assert np.abs(flat["stats"] - grid["stats"]).max() < 1e-5
    np.testing.assert_allclose(flat["consensus"], grid["consensus"],
                               rtol=1e-4)
    np.testing.assert_array_equal(flat["steps"], grid["steps"])


def test_scenario_drops_and_churn(world4, data):
    """Drops and churn: the composed reference under the same compiled
    masks; down nodes keep their counters; a dropped or down pair moves
    no block (each rank's exchanges are the passes it takes part in)."""
    compiled = _scenario().compile(np.random.default_rng(SEED))
    partners, live = compiled.schedule.partners(), compiled.alive
    assert compiled.n_dropped > 0 and compiled.n_churned > 0
    assert not live.all()
    want = _compose(data, 4, partners=partners, live=live)
    got = world4["scenario"]
    _assert_matches(got, want)
    np.testing.assert_array_equal(got["steps"], live.sum(0))
    guarded = _guard(partners, live)
    expect = [0, 0, 0, 0]
    for row in guarded:
        for perm, _src, _act in comm._route_matching(row, 4)[1]:
            for a, _b in perm:
                expect[a] += 1
    assert got["exchanges"] == expect


@pytest.mark.parametrize("name", ["resume", "resume-grid-unique"])
def test_mesh_kill_restore_bitwise(world4, name):
    full, resumed = world4[name]["full"], world4[name]["resumed"]
    np.testing.assert_array_equal(resumed["stats"], full["stats"])
    np.testing.assert_array_equal(resumed["steps"], full["steps"])
    np.testing.assert_array_equal(resumed["eval_lp"], full["eval_lp"][1:])
    # consensus after the restore: round 10 and the last
    np.testing.assert_array_equal(resumed["consensus"],
                                  full["consensus"][1:])


def test_mesh_checkpoint_is_a_reference_train_state(world4, data):
    """The mesh carry restores in the JAX package's restore_state."""
    r = _ref()
    directory = data["ckpt_dirs"]["dense-None"]
    with r["parity"].reference_mode():
        like = r["deleda"].init_state(
            r["deleda"].DeledaConfig(lda=r["lda"].LDAConfig(**KW)),
            r["jax"].random.key(SEED), N)
        st = r["deleda"].restore_state(directory, like)
    assert int(st.t) == EVAL
    assert np.asarray(st.stats).shape == (N, 3, 24)
    assert (np.asarray(st.steps) == EVAL).all()


# ---------------------------------------------------------------------------
# Privacy placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["privacy-1d", "privacy-grid"])
def test_privacy_placement(world4, case):
    """No integer-typed or document-shaped ([..., L]) tensor leaves a rank;
    the update step issues no collective on a 1-D mesh and, on the grid,
    only all-reduces over the rank's vocab group (two a round)."""
    every = world4[case]
    assert len(every) == 4
    for mine in every:
        recs = mine["records"]
        assert recs, "the recorder saw no distributed call"
        for phase, name, dtype, is_float, shape, ranks in recs:
            assert is_float, (name, dtype, shape)
            assert not shape or shape[-1] != L, (name, shape)
        update = [r for r in recs if r[0] == "update"]
        if case == "privacy-1d":
            assert update == []
            assert {r[1] for r in recs} <= {"batch_isend_irecv",
                                            "all_reduce", "gather"}
        else:
            assert len(update) == 2 * T
            for _phase, name, _dt, _f, _shape, ranks in update:
                assert name == "all_reduce"
                assert ranks == mine["vocab_line"]
