"""The port's lifecycle layer against the JAX package's, on the CPU.

TrainState checkpoints in the reference's npz layout cross both ways; a
run killed in one package resumes in the other and matches that
package's uninterrupted run; kill/restore, segments and streams are
bitwise within the port; forgetting (``decay``) and the ``alive`` /
``member`` masks follow the reference; ``serve_topics --restore-train``
serves a node of either package's checkpoint.

Sizes are ``tests/test_lifecycle.py``'s. Across packages the port starts
from the reference's initial statistic and takes its corpus arrays, at
``test_torch_deleda.py::test_sync_run_matches_reference``'s tolerances
(stats rtol 1e-4 / atol 1e-6, consensus rtol 1e-5, steps exact).
"""

import dataclasses
import os
import shutil
import warnings

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import deleda as ref_deleda  # noqa: E402
from repro.core import gossip as ref_gossip  # noqa: E402
from repro.core import lda as ref_lda  # noqa: E402
from repro.core.graph import watts_strogatz_graph as ref_ws  # noqa: E402
from repro.data import lda_synthetic as ref_synth  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import provenance  # noqa: E402
from repro_torch.convert import train_state_to_numpy  # noqa: E402
from repro_torch.core import deleda, evaluation, gossip, lda, oem  # noqa: E402
from repro_torch.core import threefry as tf3  # noqa: E402
from repro_torch.core.graph import watts_strogatz_graph  # noqa: E402
from repro_torch.data import lda_synthetic as synth  # noqa: E402
from repro_torch.launch import serve_topics  # noqa: E402
from torch_parity import port_key, reference_mode, to_torch  # noqa: E402

KW = dict(n_topics=3, vocab_size=24, alpha=0.5, doc_len_max=10, n_gibbs=4,
          n_gibbs_burnin=2)
CFG = lda.LDAConfig(**KW)
N, T, REC = 10, 20, 10
RTOL, ATOL, CONS_RTOL = 1e-4, 1e-6, 1e-5
FIELDS = ("stats", "steps", "key", "t", "stats_version", "member", "cursor")
pytestmark = pytest.mark.filterwarnings(
    "ignore:.*document lengths fell outside:UserWarning")


def _spec(**kw):
    return dict(n_nodes=N, docs_per_node=4, n_test=6, **kw)


@pytest.fixture(scope="module")
def ref():
    """The reference's corpus arrays and its initial statistic for key 1."""
    with reference_mode():
        corpus = ref_synth.make_corpus(ref_lda.LDAConfig(**KW),
                                       jax.random.key(0),
                                       ref_synth.CorpusSpec(**_spec()))
        stats0 = np.array(ref_deleda.init_state(
            ref_deleda.DeledaConfig(lda=ref_lda.LDAConfig(**KW)),
            jax.random.key(1), N).stats)
    return dict(words=np.asarray(corpus.words), mask=np.asarray(corpus.mask),
                test_words=np.asarray(corpus.test_words),
                test_mask=np.asarray(corpus.test_mask), stats0=stats0)


@pytest.fixture(scope="module")
def port_corpus():
    return synth.make_corpus(CFG, tf3.key(0), synth.CorpusSpec(**_spec()))


def _inputs(kind):
    return deleda.make_run_inputs(watts_strogatz_graph(N, 4, 0.3, seed=0),
                                  T, seed=1, kind=kind)


def _ref_inputs(kind):
    return ref_deleda.make_run_inputs(ref_ws(N, 4, 0.3, seed=0), T, seed=1,
                                      kind=kind)


def _cfg(**kw):
    kw.setdefault("batch_size", 2)
    return deleda.DeledaConfig(lda=CFG, **kw)


def _ref_cfg(**kw):
    kw.setdefault("batch_size", 2)
    return ref_deleda.DeledaConfig(lda=ref_lda.LDAConfig(**KW), **kw)


def _ref_run(ref, kind, key=None, **kw):
    """A reference run on its own corpus (inside reference_mode)."""
    sched, degs = _ref_inputs(kind)
    cfg = kw.pop("config")
    words = kw.pop("words", ref["words"])
    mask = kw.pop("mask", ref["mask"])
    with reference_mode():
        return ref_deleda.run_deleda(
            cfg, jax.random.key(1) if key is None else key,
            None if words is None else jnp.asarray(words),
            None if mask is None else jnp.asarray(mask), sched, degs, T,
            record_every=REC, **kw)


def _port_run(ref, cfg, kind, **kw):
    """A port run on the reference's corpus from its initial statistic."""
    sched, degs = _inputs(kind)
    key = port_key(jax.random.key(1))
    if "restore_from" not in kw:
        kw["init"] = dataclasses.replace(deleda.init_state(cfg, key, N),
                                         stats=torch.from_numpy(ref["stats0"]))
    words = kw.pop("words", to_torch(ref["words"], torch.int64))
    mask = kw.pop("mask", to_torch(ref["mask"]))
    return deleda.run_deleda(cfg, key, words, mask, sched, degs, T,
                             record_every=REC, **kw)


def _assert_close(port, want, tail_only=False):
    """A port trace against a reference trace, at the parity tolerances."""
    sl = slice(-1, None) if tail_only else slice(None)
    assert port.steps.tolist() == np.asarray(want.steps).tolist()
    np.testing.assert_allclose(port.stats.numpy(), np.asarray(want.stats),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port.history[sl].numpy(),
                               np.asarray(want.history[sl]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(port.consensus[sl].numpy(),
                               np.asarray(want.consensus[sl]),
                               rtol=CONS_RTOL)


def _assert_equal(a, b, tail_only=False):
    sl = slice(-1, None) if tail_only else slice(None)
    assert torch.equal(a.stats, b.stats)
    assert torch.equal(a.steps, b.steps)
    assert torch.equal(a.history[sl], b.history[sl])
    assert torch.equal(a.consensus[sl], b.consensus[sl])
    assert (a.eval_lp is None) == (b.eval_lp is None)
    if a.eval_lp is not None:
        assert torch.equal(a.eval_lp[sl], b.eval_lp[sl])


def _kill(directory, step=T, leave_uncommitted=False):
    """Delete step ``step``'s checkpoint; optionally plant an uncommitted
    directory there (a save killed between its sidecar and its npz)."""
    path = os.path.join(directory, f"step_{step:08d}")
    shutil.rmtree(path)
    if leave_uncommitted:
        os.makedirs(path)
        with open(os.path.join(path, "meta.json"), "w") as f:
            f.write("{}")


def _ref_arrays(state):
    out = {f: np.asarray(getattr(state, f)) for f in FIELDS if f != "key"}
    key = state.key
    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        key = jax.random.key_data(key)
    out["key"] = np.asarray(key)
    return out


def _npz_layout(directory, step):
    with np.load(os.path.join(directory, f"step_{step:08d}",
                              "state.npz")) as data:
        return [(k, data[k].dtype.str, data[k].shape) for k in data.files]


# ---------------------------------------------------------------------------
# (a) the TrainState format, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flavour,shards", [("typed", 1), ("legacy", 1),
                                            ("typed", 4)],
                         ids=["typed", "legacy", "typed-vs4"])
def test_reference_train_state_restores_in_port(ref, tmp_path, flavour,
                                                shards):
    key = (jax.random.key(5) if flavour == "typed"
           else jax.random.PRNGKey(5))
    tr = _ref_run(ref, "matching", key=key,
                  config=_ref_cfg(vocab_shards=shards))
    with reference_mode():
        ref_deleda.save_state(str(tmp_path), tr.state)
    like = deleda.state_like(_cfg(), N, "cpu", vocab_shards=shards)
    got = deleda.restore_state(str(tmp_path), like)
    want = _ref_arrays(tr.state)
    for name, arr in train_state_to_numpy(got).items():
        assert arr.dtype == want[name].dtype, name
        np.testing.assert_array_equal(arr, want[name])
    assert got.stats.shape == ((N, 3, 24) if shards == 1
                               else (N, 3, 4, 6))
    assert torch.equal(got.dense_stats(),
                       torch.from_numpy(np.array(tr.stats)))
    # the port writes the reference's keys, dtypes and shapes, in order
    deleda.save_state(str(tmp_path / "port"), got)
    assert (_npz_layout(str(tmp_path / "port"), T)
            == _npz_layout(str(tmp_path), T))
    with pytest.raises(ValueError, match="stats"):
        deleda.restore_state(str(tmp_path), deleda.state_like(
            _cfg(), N, "cpu", vocab_shards=2 if shards == 1 else 1))


@pytest.mark.parametrize("flavour", ["typed", "legacy"])
def test_port_train_state_restores_in_reference(port_corpus, tmp_path,
                                                flavour):
    sched, degs = _inputs("matching")
    tr = deleda.run_deleda(_cfg(), tf3.key(5), port_corpus.words,
                           port_corpus.mask, sched, degs, T,
                           record_every=REC)
    deleda.save_state(str(tmp_path), tr.state)
    meta = ckpt.load_meta(str(tmp_path))
    assert meta["kind"] == "deleda_train_state" and meta["typed_key"]
    with reference_mode():
        like = ref_deleda.init_state(
            _ref_cfg(), jax.random.key(0) if flavour == "typed"
            else jax.random.PRNGKey(0), N)
        got = ref_deleda.restore_state(str(tmp_path), like)
        typed = jnp.issubdtype(got.key.dtype, jax.dtypes.prng_key)
        got = _ref_arrays(got)
    assert typed == (flavour == "typed")
    for name, arr in train_state_to_numpy(tr.state).items():
        assert got[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(got[name], arr)


# ---------------------------------------------------------------------------
# (b) resume across packages, both ways
# ---------------------------------------------------------------------------

RESUME_CASES = [("async", "matching"), ("sync", "edge")]


@pytest.mark.parametrize("mode,kind", RESUME_CASES,
                         ids=["async-matching", "sync-edge"])
def test_port_resumes_reference_checkpoint(ref, tmp_path, mode, kind):
    rcfg = _ref_cfg(mode=mode)
    full = _ref_run(ref, kind, config=rcfg)
    _ref_run(ref, kind, config=rcfg, save_every=REC,
             checkpoint_dir=str(tmp_path))
    _kill(str(tmp_path))
    # the two packages' config digests never match: the port warns
    with pytest.warns(UserWarning, match="digest"):
        resumed = _port_run(ref, _cfg(mode=mode), kind,
                            restore_from=str(tmp_path))
    assert resumed.state.t == T and len(resumed.consensus) == 1
    _assert_close(resumed, full, tail_only=True)


@pytest.mark.parametrize("mode,kind", RESUME_CASES,
                         ids=["async-matching", "sync-edge"])
def test_reference_resumes_port_checkpoint(ref, tmp_path, mode, kind):
    cfg = _cfg(mode=mode)
    full = _port_run(ref, cfg, kind)
    _port_run(ref, cfg, kind, save_every=REC, checkpoint_dir=str(tmp_path))
    _kill(str(tmp_path))
    with pytest.warns(UserWarning, match="digest"):
        resumed = _ref_run(ref, kind, config=_ref_cfg(mode=mode),
                           restore_from=str(tmp_path))
    assert int(resumed.state.t) == T
    _assert_close(full, resumed, tail_only=True)


# ---------------------------------------------------------------------------
# (c) within the port, bit for bit
# ---------------------------------------------------------------------------

def test_train_state_basics():
    st = deleda.init_state(_cfg(), tf3.key(0), N)
    assert st.member.dtype == torch.bool and bool(st.member.all())
    assert st.member.shape == (N,) and st.t == 0 and st.cursor == 0
    like = deleda.state_like(_cfg(), N, "cpu", vocab_shards=4)
    assert like.stats.shape == (N, 3, 4, 6)
    assert like.dense_stats().shape == (N, 3, 24)
    sharded = dataclasses.replace(st, stats=st.stats.reshape(N, 3, 4, 6))
    assert torch.equal(sharded.dense_stats(), st.stats)
    with pytest.raises(ValueError, match="vocab_shards"):
        deleda.state_like(_cfg(), N, "cpu", vocab_shards=5)


def test_segments_equal_one_run(port_corpus, tmp_path):
    sched, degs = _inputs("matching")
    one = deleda.run_deleda(_cfg(), tf3.key(2), port_corpus.words,
                            port_corpus.mask, sched, degs, T,
                            record_every=REC)
    seg = deleda.run_deleda(_cfg(), tf3.key(2), port_corpus.words,
                            port_corpus.mask, sched, degs, T,
                            record_every=REC, save_every=T // 2,
                            checkpoint_dir=str(tmp_path))
    _assert_equal(one, seg)
    assert ckpt.latest_step(str(tmp_path)) == T
    assert seg.state.t == seg.state.stats_version == T


@pytest.mark.parametrize("layout", ["dense", "unique"])
def test_kill_restore_bitwise(port_corpus, tmp_path, layout):
    """Kill at T/2 (an uncommitted step-T directory left behind), resume:
    the tail, the eval trace and the key equal the uninterrupted run's."""
    sched, degs = _inputs("matching")
    spec = evaluation.EvalSpec(words=port_corpus.test_words,
                               mask=port_corpus.test_mask, key=tf3.key(99),
                               n_particles=2, probe_nodes=2, layout=layout)
    cfg = _cfg(eval_every=REC, corpus_layout=layout, decay=(5.0, 0.8))
    kw = dict(record_every=REC, eval_spec=spec)
    args = (cfg, tf3.key(4), port_corpus.words, port_corpus.mask, sched,
            degs, T)
    full = deleda.run_deleda(*args, **kw)
    deleda.run_deleda(*args, save_every=T // 2,
                      checkpoint_dir=str(tmp_path), **kw)
    _kill(str(tmp_path), leave_uncommitted=True)
    assert ckpt.latest_step(str(tmp_path)) == T // 2
    resumed = deleda.run_deleda(*args, restore_from=str(tmp_path), **kw)
    _assert_equal(full, resumed, tail_only=True)
    assert resumed.state.t == T and resumed.state.stats_version == T
    assert torch.equal(resumed.state.key, full.state.key)


def test_restore_validation(port_corpus, tmp_path):
    sched, degs = _inputs("matching")
    args = (_cfg(), tf3.key(4), port_corpus.words, port_corpus.mask, sched,
            degs, T)
    deleda.run_deleda(*args, record_every=REC, save_every=T,
                      checkpoint_dir=str(tmp_path / "done"))
    with pytest.raises(ValueError, match="nothing left"):
        deleda.run_deleda(*args, record_every=REC,
                          restore_from=str(tmp_path / "done"))
    with pytest.raises(ValueError, match="checkpoint_dir"):
        deleda.run_deleda(*args, record_every=REC, save_every=REC)
    with pytest.raises(ValueError, match="init or restore_from"):
        deleda.run_deleda(*args, record_every=REC,
                          init=deleda.init_state(_cfg(), tf3.key(4), N),
                          restore_from=str(tmp_path / "done"))
    # a reference run with vocab_shards > 1 is served, not resumed
    st = deleda.init_state(_cfg(), tf3.key(4), N)
    deleda.save_state(str(tmp_path / "vs4"), dataclasses.replace(
        st, stats=st.stats.reshape(N, 3, 4, 6), t=REC))
    with pytest.raises(NotImplementedError, match="module 13"):
        deleda.run_deleda(*args, record_every=REC,
                          restore_from=str(tmp_path / "vs4"))


def test_checkpoint_shape_mismatch_names_key_and_shapes(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), {"stats": np.zeros((3, 4),
                                                           np.float32)}, 1)
    assert ckpt.stored_shapes(str(tmp_path)) == {"stats": (3, 4)}
    with pytest.raises(ValueError) as e:
        ckpt.restore_checkpoint(str(tmp_path), {"stats": (3, 2, 2)})
    msg = str(e.value)
    assert "stats" in msg and "(3, 4)" in msg and "(3, 2, 2)" in msg
    with pytest.raises(ValueError, match="missing keys"):
        ckpt.restore_checkpoint(str(tmp_path), {"steps": (3,)})


def test_digest_warns_only_on_a_differing_config(tmp_path):
    cfg = _cfg()
    st = deleda.init_state(cfg, tf3.key(0), N)
    deleda.save_state(str(tmp_path), st, config=cfg)
    like = deleda.state_like(cfg, N, "cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = deleda.restore_state(str(tmp_path), like, config=cfg)
        deleda.restore_state(str(tmp_path), like)
    assert torch.equal(got.stats, st.stats)
    with pytest.warns(UserWarning, match="digest"):
        deleda.restore_state(str(tmp_path), like,
                             config=_cfg(batch_size=3))
    assert provenance.config_digest(cfg) == provenance.config_digest(_cfg())
    assert provenance.config_digest(cfg) != provenance.config_digest(
        _cfg(decay=(5.0, 0.8)))


def test_load_meta(tmp_path):
    assert ckpt.load_meta(str(tmp_path)) is None
    cfg = _cfg()
    deleda.save_state(str(tmp_path), deleda.init_state(cfg, tf3.key(0), N),
                      config=cfg)
    meta = ckpt.load_meta(str(tmp_path))
    for k in ("git_commit", "torch_version", "cuda_version", "device"):
        assert k in meta, meta
    assert meta["device"] == "cpu"
    assert meta["config_digest"] == provenance.config_digest(cfg)
    assert meta["kind"] == "deleda_train_state" and meta["typed_key"]
    assert ckpt.load_meta(str(tmp_path), step=0) == meta


# ---------------------------------------------------------------------------
# (d) streamed corpora
# ---------------------------------------------------------------------------

def _stream():
    return synth.make_corpus_stream(CFG, tf3.key(0),
                                    synth.CorpusSpec(**_spec(
                                        refresh_every=REC)))


def test_stream_segments(port_corpus):
    stream = _stream()
    w0, m0 = stream.segment(0)
    assert torch.equal(w0, port_corpus.words)
    assert torch.equal(m0, port_corpus.mask)
    assert torch.equal(stream.base.beta_star, port_corpus.beta_star)
    assert torch.equal(stream.base.test_words, port_corpus.test_words)
    w1, m1 = stream.segment(1)
    assert w1.shape == w0.shape and m1.shape == m0.shape
    assert not torch.equal(w1, w0)
    lens = m1.sum(-1)
    assert int(lens.min()) >= 2 and int(lens.max()) <= KW["doc_len_max"]
    assert bool((w1[~m1] == 0).all())
    w1b, m1b = stream.segment(1)
    assert torch.equal(w1, w1b) and torch.equal(m1, m1b)
    assert not torch.equal(stream.segment(2)[0], w1)


def test_stream_run_matches_frozen_until_first_refresh():
    stream = _stream()
    sched, degs = _inputs("matching")
    head = deleda.comm_mod.GossipSchedule(sched.kind, sched.data[:REC], N)
    frozen = deleda.run_deleda(_cfg(), tf3.key(8), stream.base.words,
                               stream.base.mask, head, degs, REC,
                               record_every=REC)
    streamed = deleda.run_deleda(_cfg(), tf3.key(8), None, None, head, degs,
                                 REC, record_every=REC, stream=stream)
    _assert_equal(frozen, streamed)
    full = deleda.run_deleda(_cfg(), tf3.key(8), stream.base.words,
                             stream.base.mask, sched, degs, T,
                             record_every=REC)
    full_s = deleda.run_deleda(_cfg(), tf3.key(8), None, None, sched, degs,
                               T, record_every=REC, stream=stream)
    assert full_s.state.cursor == 1
    assert torch.equal(full.history[0], full_s.history[0])
    assert not torch.equal(full.stats, full_s.stats)


def test_stream_kill_restore_bitwise(tmp_path):
    stream = _stream()
    sched, degs = _inputs("matching")
    cfg = _cfg(decay=(5.0, 0.8))
    args = (cfg, tf3.key(9), None, None, sched, degs, T)
    full = deleda.run_deleda(*args, record_every=REC, stream=stream)
    deleda.run_deleda(*args, record_every=REC, stream=stream,
                      save_every=REC, checkpoint_dir=str(tmp_path))
    assert deleda.restore_state(
        str(tmp_path), deleda.state_like(cfg, N, "cpu"), step=REC
    ).cursor == 0
    _kill(str(tmp_path))
    resumed = deleda.run_deleda(*args, record_every=REC, stream=stream,
                                restore_from=str(tmp_path))
    _assert_equal(full, resumed, tail_only=True)
    assert resumed.state.cursor == 1


def test_stream_validation():
    with pytest.raises(ValueError):
        synth.CorpusSpec(refresh_every=-1)
    with pytest.raises(ValueError):
        synth.make_corpus_stream(CFG, tf3.key(0),
                                 synth.CorpusSpec(refresh_every=0))
    stream = synth.make_corpus_stream(
        CFG, tf3.key(0), synth.CorpusSpec(**_spec(refresh_every=7)))
    sched, degs = _inputs("matching")
    with pytest.raises(ValueError, match="refresh_every"):
        deleda.run_deleda(_cfg(), tf3.key(0), None, None, sched, degs, T,
                          record_every=REC, stream=stream)
    with pytest.raises(ValueError, match="words/mask or a corpus stream"):
        deleda.run_deleda(_cfg(), tf3.key(0), None, None, sched, degs, T,
                          record_every=REC)
    with pytest.raises(ValueError):
        stream.segment(-1)


@dataclasses.dataclass
class _RefStream:
    """The reference's CorpusStream as the port's run_deleda takes it:
    its segments' arrays, handed over as torch tensors."""

    stream: object

    @property
    def refresh_every(self):
        return self.stream.refresh_every

    @property
    def n_nodes(self):
        return self.stream.n_nodes

    @property
    def base(self):
        return self

    @property
    def words(self):
        return self.segment(0)[0]

    def segment(self, s):
        with reference_mode():
            w, m = self.stream.segment(s)
        return to_torch(w, torch.int64), to_torch(m)


def test_stream_and_decay_match_reference(ref):
    with reference_mode():
        stream = ref_synth.make_corpus_stream(
            ref_lda.LDAConfig(**KW), jax.random.key(0),
            ref_synth.CorpusSpec(**_spec(refresh_every=REC)))
    want = _ref_run(ref, "matching", config=_ref_cfg(decay=(5.0, 0.8)),
                    words=None, mask=None, stream=stream)
    got = _port_run(ref, _cfg(decay=(5.0, 0.8)), "matching", words=None,
                    mask=None, stream=_RefStream(stream))
    assert got.state.cursor == int(want.state.cursor) == 1
    _assert_close(got, want)


# ---------------------------------------------------------------------------
# (e) forgetting
# ---------------------------------------------------------------------------

def test_decay_validation():
    for bad in [(10.0,), (10.0, 1.5), (-1.0, 0.6)]:
        with pytest.raises(ValueError):
            _cfg(decay=bad)
    with pytest.raises(ValueError):
        oem.make_decay_schedule(10.0, 0.0)
    assert _cfg(decay=(5, 1)).decay == (5.0, 1.0)


def test_decay_none_keeps_the_bits(port_corpus):
    sched, degs = _inputs("matching")
    args = (tf3.key(1), port_corpus.words, port_corpus.mask, sched, degs, T)
    plain = deleda.run_deleda(_cfg(), *args, record_every=REC)
    none = deleda.run_deleda(_cfg(decay=None), *args, record_every=REC)
    _assert_equal(plain, none)
    decayed = deleda.run_deleda(_cfg(decay=(5.0, 0.8)), *args,
                                record_every=REC)
    assert not torch.equal(plain.stats, decayed.stats)
    assert torch.equal(plain.steps, decayed.steps)


@pytest.mark.parametrize("mode,kind", [("sync", "matching"),
                                       ("async", "edge")])
def test_decay_matches_reference(ref, mode, kind):
    want = _ref_run(ref, kind, config=_ref_cfg(mode=mode, decay=(5.0, 0.8)))
    got = _port_run(ref, _cfg(mode=mode, decay=(5.0, 0.8)), kind)
    _assert_close(got, want)


# ---------------------------------------------------------------------------
# (f) churn and membership masks
# ---------------------------------------------------------------------------

def _masks():
    """Seeded churn, a late joiner (node 2 from step 8) and a leaver
    (node 5 from step 12)."""
    alive = np.random.default_rng(11).random((T, N)) > 0.2
    member = np.ones((T, N), bool)
    member[:8, 2] = False
    member[12:, 5] = False
    return alive, member


@pytest.mark.parametrize("mode,kind", [("async", "matching"),
                                       ("sync", "matching"),
                                       ("async", "edge"), ("sync", "edge")])
def test_masks_match_reference(ref, mode, kind):
    alive, member = _masks()
    want = _ref_run(ref, kind, config=_ref_cfg(mode=mode),
                    alive=jnp.asarray(alive), member=jnp.asarray(member))
    got = _port_run(ref, _cfg(mode=mode), kind, alive=alive, member=member)
    _assert_close(got, want)
    assert got.state.member.tolist() == member[-1].tolist()
    # a node updates at most once in each step it is alive and a member
    assert (got.steps.numpy() <= (alive & member).sum(0)).all()


def test_masks_none_keep_the_bits(port_corpus):
    sched, degs = _inputs("matching")
    args = (_cfg(), tf3.key(1), port_corpus.words, port_corpus.mask, sched,
            degs, T)
    plain = deleda.run_deleda(*args, record_every=REC)
    ones = np.ones((T, N), bool)
    _assert_equal(plain, deleda.run_deleda(*args, record_every=REC,
                                           alive=ones))
    member = deleda.run_deleda(*args, record_every=REC, member=ones)
    assert torch.equal(plain.stats, member.stats)
    assert torch.equal(plain.steps, member.steps)
    np.testing.assert_allclose(plain.consensus.numpy(),
                               member.consensus.numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="member"):
        deleda.run_deleda(*args, record_every=REC, member=ones[:, :3])


def test_masked_consensus_matches_reference():
    stats = np.random.default_rng(0).normal(size=(4, 2, 3)).astype(
        np.float32)
    member = np.array([True, True, True, False])
    want = float(ref_gossip.consensus_distance(jnp.asarray(stats),
                                               jnp.asarray(member)))
    got = gossip.consensus_distance(torch.from_numpy(stats),
                                    torch.from_numpy(member))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    np.testing.assert_allclose(
        float(got), float(gossip.consensus_distance(
            torch.from_numpy(stats[:3]))), rtol=1e-6)
    assert torch.equal(gossip.consensus_distance(torch.from_numpy(stats)),
                       gossip.consensus_distance(torch.from_numpy(stats),
                                                 None))


# ---------------------------------------------------------------------------
# (g) serve_topics --restore-train
# ---------------------------------------------------------------------------

def _serve(directory, node, shards=1):
    return serve_topics.main([
        "--device", "cpu", "--restore-train", directory, "--restore-node",
        str(node), "--restore-nodes", str(N), "--restore-vocab-shards",
        str(shards), "--topics", "3", "--vocab", "24", "--doc-len", "10",
        "--requests", "8", "--particles", "2", "--closed-loop"])


@pytest.mark.parametrize("shards", [1, 4])
def test_serve_topics_restores_a_reference_node(ref, tmp_path, capsys,
                                                shards):
    tr = _ref_run(ref, "matching", config=_ref_cfg(vocab_shards=shards),
                  save_every=T, checkpoint_dir=str(tmp_path))
    out = _serve(str(tmp_path), 3, shards)
    served = out["serving_state"].stats
    assert torch.equal(served, torch.from_numpy(np.array(tr.stats)[3]))
    assert len(out["results"]) == 8
    assert f"node 3/{N} at round {T}" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="out of range"):
        _serve(str(tmp_path), N, shards)


def test_serve_topics_notes_a_non_member(tmp_path, capsys):
    st = deleda.init_state(_cfg(), tf3.key(0), N)
    member = torch.ones(N, dtype=torch.bool)
    member[4] = False
    deleda.save_state(str(tmp_path), dataclasses.replace(st, member=member,
                                                         t=REC))
    out = _serve(str(tmp_path), 4)
    assert torch.equal(out["serving_state"].stats, st.stats[4])
    assert "node 4 is not a member" in capsys.readouterr().out
