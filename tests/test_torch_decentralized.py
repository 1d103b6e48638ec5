"""The port's decentralized LM training against the JAX package's, on gloo.

``parse_sync``, ``rounds_per_axis``, ``is_exact`` and
``collective_bytes_per_sync`` equal the reference's on a grid of specs and
sizes; ``sync_tree_sim`` equals the reference's for every spec, on a
float32 tree and bit for bit on a bfloat16 one (K1's plain version).

``launch.train.train_decentralized`` runs in 4 gloo ranks spawned once
for the module by ``gossip_sim.launch`` (as ``tests/test_torch_mesh.py``
does), one node a rank, gemma2-2b's smoke variant, H = 2 local AdamW
steps and 3 syncs, with each of allreduce, gossip-hypercube and
gossip-ring[1]. The reference's own decentralized launcher needs a
multi-device shard_map (ROADMAP R2), so each run is held against a
composition, in this process, of the reference's functions in the
order of its ``step_fn``: per node ``lm_loss`` / ``value_and_grad`` /
``opt.update`` for H steps, the loss after them, then its
``sync_tree_sim`` of the stacked parameters (which the reference holds
equal to ``sync_tree_mesh``). Both start from the reference's consensus
start (the mean of its n initial draws), restored from a checkpoint.
``repro_torch.analysis.collectives.Recorder`` watches every
``torch.distributed`` call of a run for the privacy rule. The ranks
import this file, so it imports JAX only inside functions.
"""

import os
import shutil
import sys
import tempfile

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.analysis.collectives import Recorder  # noqa: E402
from repro_torch.core import comm as port_comm  # noqa: E402
from repro_torch.core import decentralized as dec  # noqa: E402
from repro_torch.launch import gossip_sim, train  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from test_torch_mesh import LAUNCH_TIMEOUT_S  # noqa: E402

N, H, STEPS, B, SEQ, LR, SEED = 4, 2, 3, 2, 16, 1e-3, 0
SPECS = ["allreduce", "gossip-hypercube", "gossip-ring[1]"]
LOSS_RTOL = 1e-5


def _args(init_dir, sync, **kw):
    args = train.parse_args(
        ["--device", "cpu", "--arch", "gemma2_2b", "--mode",
         "decentralized", "--sync", sync, "--local-steps", str(H),
         "--steps", str(STEPS), "--batch", str(B), "--seq", str(SEQ),
         "--lr", str(LR), "--seed", str(SEED), "--init-from", init_dir,
         "--log-every", "2"])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


# ---------------------------------------------------------------------------
# What the ranks run (no JAX here)
# ---------------------------------------------------------------------------

def _run(data, sync, record=False):
    cfg = train.config_of(_args(data["init"], sync))
    rec = Recorder() if record else None
    if record:
        with rec:
            log = train.train_decentralized(cfg, _args(data["init"], sync),
                                            make_host_mesh())
    else:
        log = train.train_decentralized(cfg, _args(data["init"], sync),
                                        make_host_mesh())
    mine = {"params": convert.decoder_lm_to_numpy(log.state.params),
            "losses": log.losses, "spreads": log.spreads,
            "sync_bytes": log.sync_bytes, "napkin": log.napkin_bytes,
            "param_bytes": log.param_bytes, "step": log.state.step,
            "shapes": sorted({tuple(x.shape) for x in
                              torch.utils._pytree.tree_leaves(
                                  log.state.params)})}
    if record:
        mine.update(records=rec.records, objects=rec.objects)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def _chunked_means():
    """A rank's mean and spread of a 2,000-element leaf in one all-reduce
    and in chunks of 777 (two whole chunks and a ragged tail)."""
    mesh = make_host_mesh()
    comm = port_comm.MeshComm(mesh)
    g = torch.Generator().manual_seed(dist.get_rank())
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        base = torch.randn((40, 50), generator=g).to(dtype)
        got = []
        for chunk in (dec.SYNC_CHUNK, 777):
            real, dec.SYNC_CHUNK = dec.SYNC_CHUNK, chunk
            try:
                x = base.clone()
                dec._mean_(x, comm, ("data",), N)
                got.append((x.float().numpy(),
                            dec.spread_mesh({"w": base}, mesh)))
            finally:
                dec.SYNC_CHUNK = real
        out[str(dtype)] = got
    return out


def _rank_jobs(data):
    torch.set_num_threads(1)
    out = {sync: _run(data, sync) for sync in SPECS}
    out["chunks"] = _chunked_means()
    out["privacy"] = _run(data, "gossip-ring[1]", record=True)
    assert "jax" not in sys.modules and "repro.core" not in sys.modules
    return out


# ---------------------------------------------------------------------------
# The reference, composed in this process
# ---------------------------------------------------------------------------

def _ref():
    import jax
    import jax.numpy as jnp

    from repro.checkpoint import save_checkpoint
    from repro.configs import get_config, smoke_variant
    from repro.core import decentralized as r_dec
    from repro.data.lm_pipeline import TokenPipeline
    from repro.models import transformer as r_tf
    from repro.optim import make_lr_schedule, make_optimizer
    import torch_parity
    return dict(jax=jax, jnp=jnp, save=save_checkpoint, dec=r_dec,
                cfg=smoke_variant(get_config("gemma2_2b")), tf=r_tf,
                pipe=TokenPipeline, sched=make_lr_schedule,
                make_opt=make_optimizer, parity=torch_parity)


def _compose(params0, sync):
    """The reference's step_fn, node by node, then its sync_tree_sim."""
    r = _ref()
    jax, jnp, cfg = r["jax"], r["jnp"], r["cfg"]
    spec = r["dec"].parse_sync(sync)
    opt = r["make_opt"](cfg.optimizer, r["sched"]("constant", LR))

    @jax.jit
    def local(p, s, tokens, targets, mask, step):
        for i in range(H):
            b = {"tokens": tokens[i], "targets": targets[i],
                 "mask": mask[i]}
            _, g = jax.value_and_grad(
                lambda q: r["tf"].lm_loss(cfg, q, b))(p)
            p, s = opt.update(g, s, p, step + i)
        last = {"tokens": tokens[-1], "targets": targets[-1],
                "mask": mask[-1]}
        return p, s, r["tf"].lm_loss(cfg, p, last)

    with r["parity"].reference_mode():
        nodes = [jax.tree.map(jnp.asarray, params0) for _ in range(N)]
        states = [opt.init(p) for p in nodes]
        pipe = r["pipe"](cfg.vocab_size, SEQ, N * H * B, seed=SEED)
        losses, step = [], jnp.zeros((), jnp.int32)
        for _t, batch in zip(range(STEPS), pipe.batches()):
            shp = (N, H, B, SEQ)
            tok, tgt, msk = (x.reshape(shp) for x in batch)
            outs = [local(nodes[i], states[i], tok[i], tgt[i], msk[i], step)
                    for i in range(N)]
            stacked = jax.tree.map(lambda *xs: jnp.stack(xs),
                                   *[o[0] for o in outs])
            stacked = r["dec"].sync_tree_sim(stacked, spec, N)
            nodes = [jax.tree.map(lambda x, i=i: x[i], stacked)
                     for i in range(N)]
            states = [o[1] for o in outs]
            losses.append(float(np.mean([float(o[2]) for o in outs])))
            step = step + H
        return ([jax.tree.map(np.asarray, p) for p in nodes],
                np.asarray(losses))


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    """The reference's consensus start (its train_decentralized's: the
    mean of N draws from the split key), saved as a params checkpoint."""
    r = _ref()
    jax, jnp = r["jax"], r["jnp"]
    with r["parity"].reference_mode():
        keys = jax.random.split(jax.random.key(SEED), N)
        stacked = jax.vmap(lambda k: r["tf"].init_decoder_lm(r["cfg"], k))(
            keys)
        params0 = jax.tree.map(lambda x: np.asarray(x.mean(0)), stacked)
    tmp = tempfile.mkdtemp(prefix="dec_test_")
    r["save"](os.path.join(tmp, "init"), params0, 0)
    yield {"init": os.path.join(tmp, "init"), "params0": params0}
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.fixture(scope="module")
def world4(data):
    return gossip_sim.launch(_rank_jobs, N, "gloo", (data,),
                             timeout_s=LAUNCH_TIMEOUT_S)


# ---------------------------------------------------------------------------
# The spec helpers and the simulation substrate
# ---------------------------------------------------------------------------

_SPEC_STRS = ["allreduce", "gossip-hypercube", "gossip-hypercube[1]",
              "gossip-hypercube[2]", "gossip-hypercube[5]", "gossip-ring",
              "gossip-ring[1]", "gossip-ring[3]", "gossip-ring[0]"]
_SIZES = [(1,), (2,), (4,), (8,), (16,), (6,), (4, 4), (2, 8), (8, 1),
          (1, 4)]


@pytest.mark.parametrize("spec_str", _SPEC_STRS)
def test_spec_helpers_match_reference(spec_str):
    r = _ref()["dec"]
    want, got = r.parse_sync(spec_str), dec.parse_sync(spec_str)
    assert (got.kind, got.rounds) == (want.kind, want.rounds)
    for sizes in _SIZES:
        assert dec.rounds_per_axis(got, sizes) == r.rounds_per_axis(
            want, sizes)
        assert dec.is_exact(got, sizes) == r.is_exact(want, sizes)
        for payload in (1, 1000, 1 << 30):
            assert (dec.collective_bytes_per_sync(got, payload, sizes)
                    == r.collective_bytes_per_sync(want, payload, sizes))


@pytest.mark.parametrize("bad", ["gossip", "allreduce[2]x", "ring[1]",
                                 "gossip-torus[2]"])
def test_parse_sync_refuses_what_the_reference_refuses(bad):
    r = _ref()["dec"]
    with pytest.raises(ValueError) as want:
        r.parse_sync(bad)
    with pytest.raises(ValueError) as got:
        dec.parse_sync(bad)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown sync kind"):
        dec.SyncSpec("torus")


def _torch(x):
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _sim_tree(rng, n):
    return {"a": rng.standard_normal((n, 3, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal((n, 7)).astype(np.float32),
                  "d": rng.standard_normal((n, 2, 2, 3)).astype(
                      np.float32)}}


_SIM_CASES = [(spec, n) for spec in ("allreduce", "gossip-hypercube",
                                     "gossip-hypercube[1]", "gossip-ring",
                                     "gossip-ring[1]", "gossip-ring[3]")
              for n in (4, 8, 6)
              if not (spec.startswith("gossip-hypercube") and n == 6)]


@pytest.mark.parametrize("spec_str,n", _SIM_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sync_tree_sim_matches_reference(spec_str, n, dtype):
    """float32 within 1e-6 (the allreduce's sum order); bfloat16 bit for
    bit: gossip through K1's plain version, the mean summed in float32 and
    rounded once in both packages. (The hypercube needs n a power of 2.)"""
    r = _ref()
    jax, jnp = r["jax"], r["jnp"]
    tree = _sim_tree(np.random.default_rng(n), n)
    jdt = getattr(jnp, dtype)
    ref_in = jax.tree.map(lambda x: jnp.asarray(x).astype(jdt), tree)
    want = jax.tree.map(np.asarray, r["dec"].sync_tree_sim(
        ref_in, r["dec"].parse_sync(spec_str), n))
    port = jax.tree.map(lambda x: _torch(np.asarray(x)), ref_in)
    out = dec.sync_tree_sim(port, dec.parse_sync(spec_str), n)
    assert out is port
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = port
        for k in path:
            g = g[k.key]
        assert str(g.dtype).endswith(dtype)
        if dtype == "bfloat16":
            np.testing.assert_array_equal(
                g.view(torch.int16).numpy(), w.view(np.int16))
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7)


def test_gossip_mix_refuses_other_dtypes():
    """K1 has float32 and bfloat16 paths; any other dtype raises on every
    device, the CPU's plain version included."""
    from repro_torch.kernels.gossip_mix import ops as mix_ops

    pairs = np.array([[0, 1]], np.int32)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            mix_ops.mix_pairs_(torch.zeros((2, 3), dtype=dtype), pairs)
    x = torch.tensor([[1.0, 2.0], [3.0, 5.0]], dtype=torch.bfloat16)
    mix_ops.mix_pairs_(x, pairs)
    assert x.tolist() == [[2.0, 3.5], [2.0, 3.5]]


def test_sync_tree_sim_launches_nothing_on_the_cpu():
    from repro_torch.kernels.gossip_mix import ops as mix_ops

    before = mix_ops.launches
    tree = {"w": torch.ones((4, 3), dtype=torch.bfloat16)}
    dec.sync_tree_sim(tree, dec.parse_sync("gossip-hypercube"), 4,
                      comm=port_comm.SimComm())
    assert mix_ops.launches == before


# ---------------------------------------------------------------------------
# The launcher in 4 ranks
# ---------------------------------------------------------------------------

def _assert_params_close(got, want, lr_sum):
    """AdamW's bound (tests/test_torch_train.py): every element within a
    tenth of the summed lr; at most 1e-3 of a leaf's beyond 1e-6 (the
    single-node bound is 1e-4 for 3 updates; here 6 updates, and each
    sync spreads a node's odd element to its partners)."""
    jax = _ref()["jax"]
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for k in path:
            g = g[k.key]
        d = np.abs(g - w)
        name = jax.tree_util.keystr(path)
        assert d.max() < 0.1 * lr_sum, (name, d.max())
        assert (d > 1e-6).mean() <= 1e-3, (name, (d > 1e-6).sum())


@pytest.mark.parametrize("sync", SPECS)
def test_decentralized_matches_composed_reference(world4, data, sync):
    want_nodes, want_losses = _compose(data["params0"], sync)
    got = world4[sync]
    assert len(got) == N
    for rank in range(N):
        np.testing.assert_allclose(got[rank]["losses"], want_losses,
                                   rtol=LOSS_RTOL)
        assert got[rank]["step"] == STEPS * H
        _assert_params_close(got[rank]["params"], want_nodes[rank],
                             LR * H * STEPS)


@pytest.mark.parametrize("sync", SPECS)
def test_decentralized_consensus_and_bytes(world4, sync):
    got = world4[sync]
    spec = dec.parse_sync(sync)
    spreads = [s for _t, s in got[0]["spreads"]]
    assert [t for t, _s in got[0]["spreads"]] == [0, 2]
    if dec.is_exact(spec, (N,)):
        assert spreads == [0.0, 0.0]
        jax = _ref()["jax"]
        for leaf0, *others in zip(*(jax.tree.leaves(g["params"])
                                    for g in got)):
            for leaf in others:
                np.testing.assert_array_equal(leaf, leaf0)
    else:
        assert all(np.isfinite(spreads)) and min(spreads) > 0
    payload = got[0]["param_bytes"]
    assert got[0]["napkin"] == dec.collective_bytes_per_sync(spec, payload,
                                                             (N,))
    (k,) = dec.rounds_per_axis(spec, (N,))
    assert got[0]["sync_bytes"] == (payload if spec.kind == "allreduce"
                                    else k * payload)   # float32 leaves


def test_chunked_all_reduce(world4):
    """bfloat16 leaves average to the same bits in chunks (their float32
    sums are exact), and to the reference's bf16 mean; float32 leaves
    within the rounding of a 4-term sum, whose order gloo's all-reduce
    picks by the buffer's size."""
    got = world4["chunks"]                      # rank 0's
    (a, sa), (b, sb) = got["torch.bfloat16"]
    np.testing.assert_array_equal(a, b)
    assert sa == sb > 0
    # and they are the reference's bf16 node mean (sync_tree_sim's
    # x.mean(0), held equal to its pmean), bit for bit
    r = _ref()
    bases = []
    for rank in range(N):
        g = torch.Generator().manual_seed(rank)
        bases.append(torch.randn((40, 50), generator=g).to(
            torch.bfloat16).float().numpy())
    want = r["dec"].sync_tree_sim(
        {"w": r["jnp"].asarray(np.stack(bases)).astype(r["jnp"].bfloat16)},
        r["dec"].parse_sync("allreduce"), N)["w"][0]
    np.testing.assert_array_equal(a, np.asarray(want).astype(np.float32))
    (a, sa), (b, sb) = got["torch.float32"]
    np.testing.assert_allclose(a, b, rtol=4e-7, atol=1e-7)
    np.testing.assert_allclose(sa, sb, rtol=1e-6)


def test_privacy_placement(world4):
    """Only floating-point tensors shaped like a parameter leaf (the
    gossip's [1, ...] block of one, or a flat float32 chunk of one that an
    all-reduce moves) or the scalar loss leave a rank; the integer [B, S]
    tokens, targets and mask never do."""
    every = world4["privacy"]
    chunk = dec.SYNC_CHUNK
    for mine in every:
        recs = mine["records"]
        assert recs, "the recorder saw no distributed call"
        shapes = set(map(tuple, mine["shapes"]))
        flat = {(min(int(np.prod(s)), chunk),) for s in shapes} | {
            (int(np.prod(s)) % chunk,) for s in shapes}
        for _phase, name, dtype, is_float, shape, _ranks in recs:
            assert is_float, (name, dtype, shape)
            assert (shape in shapes or shape[1:] in shapes and shape[0] == 1
                    or name == "all_reduce" and shape in flat
                    or shape == (1,)), (name, shape)
            assert shape[-2:] != (B, SEQ) and shape != (B, SEQ)
        assert {r[1] for r in recs} <= {"batch_isend_irecv", "all_reduce"}
        assert mine["objects"] == ["int"]
