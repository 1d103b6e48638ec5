"""The Scale layer's vocab-sharded simulation against the JAX package.

``DeledaConfig.vocab_shards = S`` carries the statistic as
``[n, K, S, V/S]``. The port trains it through its dense view, so a
vocab-sharded run is the ``vocab_shards = 1`` run bit for bit; the
reference re-associates its denominator across shards, so its ``vs4``
goldens differ from its ``vs1`` ones in the last bits and the port is held
to them at ``tests/test_golden.py``'s tolerances (steps exact, mass and
sumsq rtol 1e-4, probe rtol 3e-3, eval_lp rtol 1e-5). The port runs on the
reference's corpus from the reference's initial statistic and replays its
streams (``tests/test_torch_deleda.py``'s harness).
"""

import dataclasses
import json
import os
import pathlib
import shutil

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import deleda as ref_deleda  # noqa: E402
from repro.core import lda as ref_lda  # noqa: E402
from repro.core.graph import watts_strogatz_graph as ref_ws  # noqa: E402
from repro.data.lda_synthetic import CorpusSpec, make_corpus  # noqa: E402
from repro_torch.core import deleda, evaluation, lda  # noqa: E402
from repro_torch.core.graph import watts_strogatz_graph  # noqa: E402
from torch_parity import port_key, reference_mode, to_torch  # noqa: E402

GOLDEN = json.loads((pathlib.Path(__file__).parent
                     / "golden_deleda.json").read_text())
# tests/test_golden.py's run
KW = dict(n_topics=3, vocab_size=20, alpha=0.5, doc_len_max=8, n_gibbs=4,
          n_gibbs_burnin=2)
N, T, REC, S = 8, 20, 10, 4


@pytest.fixture(scope="module")
def ref_inputs():
    """The reference's corpus and its initial statistic for key(1)."""
    with reference_mode():
        corpus = make_corpus(ref_lda.LDAConfig(**KW), jax.random.key(0),
                             CorpusSpec(n_nodes=N, docs_per_node=4,
                                        n_test=4))
        cfg = ref_deleda.DeledaConfig(lda=ref_lda.LDAConfig(**KW))
        stats0 = np.array(ref_deleda.init_state(cfg, jax.random.key(1),
                                                N).stats)
    return corpus, stats0


def _cfg(shards=S, **kw):
    kw.setdefault("mode", "async")
    return deleda.DeledaConfig(lda=lda.LDAConfig(**KW), batch_size=2,
                               vocab_shards=shards, **kw)


def _spec(corpus, layout="dense"):
    return evaluation.EvalSpec(
        words=to_torch(corpus.test_words, torch.int64),
        mask=to_torch(corpus.test_mask), key=port_key(jax.random.key(7)),
        n_particles=4, probe_nodes=2, layout=layout)


def _port_run(ref_inputs, cfg, kind="matching", eval_spec=None, **kw):
    corpus, stats0 = ref_inputs
    sched, degs = deleda.make_run_inputs(
        watts_strogatz_graph(N, 4, 0.3, seed=0), T, seed=0, kind=kind)
    key = port_key(jax.random.key(1))
    if "restore_from" not in kw:
        st = deleda.init_state(cfg, key, N)
        kw["init"] = dataclasses.replace(
            st, stats=torch.from_numpy(stats0).reshape(st.stats.shape))
    return deleda.run_deleda(cfg, key, to_torch(corpus.words, torch.int64),
                             to_torch(corpus.mask), sched, degs, T,
                             record_every=REC, eval_spec=eval_spec, **kw)


def _fingerprint(trace):
    """tests/test_golden.py's fingerprint of a port trace."""
    stats = trace.stats.double().numpy()
    return {"mass": float(stats.sum()), "sumsq": float((stats ** 2).sum()),
            "probe": [float(v) for v in stats[::3, 1, ::7].reshape(-1)],
            "steps": [int(s) for s in trace.steps],
            "consensus_final": float(trace.consensus[-1])}


def _assert_golden(got, want):
    assert got["steps"] == want["steps"]
    np.testing.assert_allclose(got["mass"], want["mass"], rtol=1e-4)
    np.testing.assert_allclose(got["sumsq"], want["sumsq"], rtol=1e-4)
    np.testing.assert_allclose(got["probe"], want["probe"], rtol=3e-3,
                               atol=1e-5)
    np.testing.assert_allclose(got["consensus_final"],
                               want["consensus_final"], rtol=1e-3,
                               atol=1e-5)


@pytest.mark.parametrize("golden,layout", [
    ("matching:dense:dense:vs4", "dense"),
    ("matching:pallas:pallas:vs4", "dense"),
    ("sparse:matching:dense:pallas:vs4", "unique")])
def test_sharded_trace_matches_golden(ref_inputs, golden, layout):
    """The reference pins its vs4 run per backend pair; the port has one
    communicator and one E-step per device, so one run meets both."""
    trace = _port_run(ref_inputs, _cfg(corpus_layout=layout))
    assert trace.state.stats.shape == (N, 3, S, 20 // S)
    assert trace.stats.shape == (N, 3, 20)           # the trace is dense
    assert trace.history.shape == (T // REC, N, 3, 20)
    _assert_golden(_fingerprint(trace), GOLDEN[golden])


def test_sharded_eval_trace_matches_golden(ref_inputs):
    corpus, _ = ref_inputs
    trace = _port_run(ref_inputs, _cfg(eval_every=REC),
                      eval_spec=_spec(corpus))
    want = GOLDEN["eval:matching:dense:dense:vs4"]
    assert list(trace.eval_lp.shape) == want["shape"]
    np.testing.assert_allclose(trace.eval_lp.double().numpy().reshape(-1),
                               want["eval_lp"], rtol=1e-5)


@pytest.mark.parametrize("kind,mode,layout", [
    ("matching", "async", "dense"), ("matching", "sync", "dense"),
    ("edge", "async", "dense"), ("edge", "sync", "dense"),
    ("matching", "async", "unique")])
def test_sharded_run_equals_dense_run_bitwise(ref_inputs, kind, mode,
                                              layout):
    """The shard axis is a view of the contiguous V axis: the port's vs4
    run is its vs1 run bit for bit (stats, steps, history, consensus, LP)."""
    corpus, _ = ref_inputs
    spec = _spec(corpus, layout)
    runs = [_port_run(ref_inputs, _cfg(shards, mode=mode, eval_every=REC,
                                       corpus_layout=layout),
                      kind=kind, eval_spec=spec) for shards in (1, S)]
    one, four = runs
    for name in ("stats", "steps", "history", "consensus", "eval_lp"):
        assert torch.equal(getattr(one, name), getattr(four, name)), name
    assert torch.equal(four.state.stats.reshape(N, 3, 20), one.state.stats)


def test_vocab_shards_validation_matches_reference():
    for shards in (0, 7):
        with pytest.raises(ValueError) as want:
            ref_deleda.DeledaConfig(lda=ref_lda.LDAConfig(**KW),
                                    vocab_shards=shards)
        with pytest.raises(ValueError) as got:
            deleda.DeledaConfig(lda=lda.LDAConfig(**KW), vocab_shards=shards)
        assert str(got.value) == str(want.value)


def test_init_state_is_a_reshape():
    key = port_key(jax.random.key(3))
    one = deleda.init_state(_cfg(1), key, N)
    four = deleda.init_state(_cfg(S), key, N)
    assert four.stats.shape == (N, 3, S, 5)
    assert torch.equal(four.stats.reshape(N, 3, 20), one.stats)
    assert torch.equal(four.dense_stats(), one.stats)


def _kill(directory, step):
    shutil.rmtree(os.path.join(directory, f"step_{step:08d}"))


def test_reference_sharded_checkpoint_resumes_in_port(ref_inputs, tmp_path):
    """A vocab_shards=4 TrainState saved by the reference mid-run resumes in
    the port's run_deleda and ends where the reference's uninterrupted
    run does."""
    corpus, _ = ref_inputs
    with reference_mode():
        rcfg = ref_deleda.DeledaConfig(lda=ref_lda.LDAConfig(**KW),
                                       batch_size=2, vocab_shards=S)
        sched, degs = ref_deleda.make_run_inputs(ref_ws(N, 4, 0.3, seed=0),
                                                 T, seed=0, kind="matching")
        args = (rcfg, jax.random.key(1), jnp.asarray(corpus.words),
                jnp.asarray(corpus.mask), sched, degs, T)
        full = ref_deleda.run_deleda(*args, record_every=REC)
        ref_deleda.run_deleda(*args, record_every=REC, save_every=REC,
                              checkpoint_dir=str(tmp_path))
    _kill(str(tmp_path), T)
    with pytest.warns(UserWarning, match="digest"):
        resumed = _port_run(ref_inputs, _cfg(),
                            restore_from=str(tmp_path))
    assert resumed.state.t == T and resumed.state.stats.dim() == 4
    assert resumed.steps.tolist() == np.asarray(full.steps).tolist()
    np.testing.assert_allclose(resumed.stats.numpy(), np.asarray(full.stats),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(resumed.consensus.numpy(),
                               np.asarray(full.consensus[-1:]), rtol=1e-5)


@pytest.mark.parametrize("layout", ["dense", "unique"])
def test_port_sharded_kill_restore_bitwise(ref_inputs, tmp_path, layout):
    corpus, _ = ref_inputs
    cfg = _cfg(eval_every=REC, corpus_layout=layout)
    spec = _spec(corpus, layout)
    full = _port_run(ref_inputs, cfg, eval_spec=spec)
    _port_run(ref_inputs, cfg, eval_spec=spec, save_every=REC,
              checkpoint_dir=str(tmp_path))
    _kill(str(tmp_path), T)
    resumed = _port_run(ref_inputs, cfg, eval_spec=spec,
                        restore_from=str(tmp_path))
    assert resumed.state.stats.shape == (N, 3, S, 5)
    assert torch.equal(resumed.state.stats, full.state.stats)
    assert torch.equal(resumed.steps, full.steps)
    assert torch.equal(resumed.history, full.history[-1:])
    assert torch.equal(resumed.consensus, full.consensus[-1:])
    assert torch.equal(resumed.eval_lp, full.eval_lp[-1:])
    # under another vocab_shards the stored shape is refused by name
    with pytest.raises(ValueError, match="vocab_shards"):
        _port_run(ref_inputs, _cfg(1), restore_from=str(tmp_path))
