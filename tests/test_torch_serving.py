"""The port's serving slice against the JAX package's, end to end on CPU.

G-OEM from the reference's initial statistic replays the reference's
streams; the served "ll" answers equal the port's ``evaluate_heldout``
bit for bit and the reference server's at rtol 1e-5; a checkpoint moves
between the two packages with equal bits; ``serve_topics`` runs to the
end on the CPU.
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import restore_checkpoint as ref_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as ref_save  # noqa: E402
from repro.core import lda as ref_lda  # noqa: E402
from repro.core import oem as ref_oem  # noqa: E402
from repro.core import serving as ref_serving  # noqa: E402
from repro.data.lda_synthetic import CorpusSpec, make_corpus  # noqa: E402
from repro_torch.checkpoint import (latest_step, restore_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.convert import (lda_state_from_numpy,  # noqa: E402
                                 lda_state_to_numpy)
from repro_torch.core import evaluation, lda, oem, serving  # noqa: E402
from repro_torch.launch import serve_topics  # noqa: E402
from torch_parity import port_key, reference_mode, to_torch  # noqa: E402

KW = dict(n_topics=5, vocab_size=40, alpha=0.5, doc_len_max=12, n_gibbs=6,
          n_gibbs_burnin=3)
REF_CFG = ref_lda.LDAConfig(**KW)
CFG = lda.LDAConfig(**KW)
KEY = jax.random.key(42)


@pytest.fixture(scope="module")
def corpus():
    with reference_mode():
        return make_corpus(REF_CFG, jax.random.key(0),
                           CorpusSpec(n_nodes=2, docs_per_node=10,
                                      n_test=16))


def _leaves(state):
    return {"stats": np.asarray(state.stats), "step": np.asarray(state.step),
            "stats_version": np.asarray(state.stats_version)}


@pytest.fixture(scope="module")
def trained(corpus):
    """(reference final state, port final state) after 4 G-OEM steps."""
    words = np.asarray(corpus.flat_words)
    mask = np.asarray(corpus.flat_mask)
    with reference_mode():
        ref = ref_oem.run_oem(REF_CFG, KEY, jnp.asarray(words),
                              jnp.asarray(mask), n_steps=4, batch_size=8,
                              record_every=2)
        init = ref_lda.init_state(REF_CFG, jax.random.split(KEY)[0])
    port = oem.run_oem(CFG, port_key(KEY), to_torch(words), to_torch(mask),
                       n_steps=4, batch_size=8, record_every=2,
                       init=lda_state_from_numpy(_leaves(init)))
    return ref, port


def test_run_oem_replays_reference(trained):
    ref, port = trained
    np.testing.assert_allclose(port.state.stats.numpy(),
                               np.asarray(ref.state.stats), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(port.stats_history.numpy(),
                               np.asarray(ref.stats_history), rtol=1e-4,
                               atol=1e-7)
    assert int(port.state.step) == int(ref.state.step) == 4
    assert int(port.state.stats_version) == 4


def _docs(corpus):
    words = np.asarray(corpus.test_words)
    lens = np.asarray(corpus.test_mask).sum(-1).astype(int)
    return [words[i, :max(lens[i], 1)] for i in range(words.shape[0])]


def _serve(server, docs, kinds):
    for i, (d, kind) in enumerate(zip(docs, kinds)):
        server.submit(d, kind=kind, doc_id=i)
    return {(r.doc_id, r.kind): r for r in server.drain()}


def test_topic_server_matches_reference_and_evaluate_heldout(trained,
                                                             corpus):
    ref, _port = trained
    stats = np.asarray(ref.state.stats)
    docs = _docs(corpus)
    kinds = ["ll" if i % 3 else "mixture" for i in range(len(docs))]
    with reference_mode():
        rserver = ref_serving.TopicServer(
            ref_serving.ServingState(jnp.asarray(stats), tau=REF_CFG.tau),
            alpha=REF_CFG.alpha, key=KEY, doc_len_max=REF_CFG.doc_len_max,
            n_particles=4, slab_docs=5, mixture_sweeps=6, mixture_burnin=3)
        want = _serve(rserver, docs, kinds)
    sstate = serving.ServingState(to_torch(stats), tau=CFG.tau)
    server = serving.TopicServer(
        sstate, alpha=CFG.alpha, key=port_key(KEY),
        doc_len_max=CFG.doc_len_max, n_particles=4, slab_docs=5,
        mixture_sweeps=6, mixture_burnin=3)
    got = _serve(server, docs, kinds)
    assert got.keys() == want.keys()
    for key, r in got.items():
        if r.kind == "ll":
            np.testing.assert_allclose(r.value, want[key].value, rtol=1e-5)
        else:
            np.testing.assert_allclose(r.value.sum(), 1.0, rtol=1e-5)
            np.testing.assert_allclose(r.value, want[key].value, rtol=1e-5,
                                       atol=1e-6)
    # "ll" answers == evaluate_heldout of the same docs at the bucket length
    for lb in server.buckets:
        ids = [i for i in range(len(docs)) if kinds[i] == "ll"
               and server.bucket_for(docs[i].size) == lb]
        if not ids:
            continue
        n = max(ids) + 1
        words = np.zeros((n, lb), np.int64)
        mask = np.zeros((n, lb), bool)
        for i in ids:
            words[i, :docs[i].size] = docs[i]
            mask[i, :docs[i].size] = True
        lls = evaluation.evaluate_heldout(
            port_key(KEY), to_torch(words), to_torch(mask),
            beta=sstate.beta(), alpha=CFG.alpha, n_particles=4,
            chunk_docs=3)
        for i in ids:
            assert got[(i, "ll")].value == float(lls[i])


def test_serving_state_cache_and_publish():
    rng = np.random.default_rng(1)
    stats = to_torch(rng.random((4, 20), dtype=np.float32))
    st = serving.ServingState(stats, tau=1e-2)
    assert torch.equal(st.beta(), lda.eta_star(stats, 1e-2))
    assert torch.equal(st.denom(), lda.eta_star_denom(stats, 1e-2))
    assert torch.equal(st.log_eta_star(), lda.log_eta_star(stats, 1e-2))
    st.beta()
    assert st.n_derivations == 1
    st.publish(stats * 2.0)
    assert st.stats_version == 1
    assert torch.equal(st.beta(), lda.eta_star(stats * 2.0, 1e-2))
    assert st.n_derivations == 2
    with pytest.raises(ValueError):
        st.publish(stats, version=1)
    sharded = serving.ServingState(stats.reshape(4, 2, 10), tau=1e-2)
    words = to_torch(rng.integers(0, 20, (3, 5)))
    dense = serving.ServingState(stats, tau=1e-2)
    assert torch.equal(sharded.beta_w(words), dense.beta_w(words))
    with pytest.raises(ValueError):
        sharded.beta()


def test_make_buckets_matches_reference():
    for l, n in [(64, 3), (12, 3), (5, 4), (33, 2), (1, 1)]:
        assert serving.make_buckets(l, n) == ref_serving.make_buckets(l, n)


def test_reference_checkpoint_restores_bitwise(tmp_path, trained):
    ref, _port = trained
    ref_save(str(tmp_path), ref.state, 4)
    like = lda_state_from_numpy(_leaves(ref.state))
    got = restore_checkpoint(str(tmp_path), like)
    for name, arr in _leaves(ref.state).items():
        np.testing.assert_array_equal(getattr(got, name).numpy(), arr)
        assert getattr(got, name).dtype == getattr(like, name).dtype


def test_port_checkpoint_restores_in_reference(tmp_path, trained):
    _ref, port = trained
    save_checkpoint(str(tmp_path), port.state, 4)
    assert latest_step(str(tmp_path)) == 4
    like = ref_lda.init_state(REF_CFG, jax.random.key(0))
    got = ref_restore(str(tmp_path), like)
    for name, arr in lda_state_to_numpy(port.state).items():
        np.testing.assert_array_equal(np.asarray(getattr(got, name)), arr)
    with pytest.raises(ValueError, match="shape"):
        bad = lda_state_from_numpy({"stats": np.zeros((3, 3), np.float32),
                                    "step": np.int32(0)})
        restore_checkpoint(str(tmp_path), bad)


def test_serve_topics_main_runs_on_cpu(tmp_path):
    argv = ["--device", "cpu", "--topics", "5", "--vocab", "100",
            "--doc-len", "16", "--train-steps", "2", "--train-batch", "8",
            "--requests", "30", "--rate", "100000", "--particles", "3",
            "--gossip-every", "2", "--save", str(tmp_path)]
    out = serve_topics.main(argv)
    assert len(out["results"]) == 30
    lls = [r.value for r in out["results"] if r.kind == "ll"]
    mixes = [r.value for r in out["results"] if r.kind == "mixture"]
    assert lls and np.all(np.isfinite(lls))
    for m in mixes:
        np.testing.assert_allclose(m.sum(), 1.0, rtol=1e-5)
    assert out["server"].n_slabs > 1
    assert len({r.stats_version for r in out["results"]}) > 1
    restored = serve_topics.main(argv[:-2] + ["--restore", str(tmp_path),
                                              "--requests", "10"])
    assert restored["train_steps_per_s"] is None
    assert len(restored["results"]) == 10


def test_serve_topics_closed_loop_fills_every_bucket():
    """Uniform request lengths reach every bucket; the closed loop serves
    all requests, one slab per count in ``slabs_by_queue``."""
    argv = ["--device", "cpu", "--topics", "5", "--vocab", "100",
            "--doc-len", "16", "--train-steps", "2", "--train-batch", "8",
            "--requests", "24", "--particles", "3", "--request-len",
            "uniform", "--closed-loop"]
    out = serve_topics.main(argv)
    server, results = out["server"], out["results"]
    assert len(results) == 24
    assert {r.bucket for r in results} == set(server.buckets) == {4, 8, 16}
    assert sum(server.slabs_by_queue.values()) == server.n_slabs
    for (lb, kind), n in server.slabs_by_queue.items():
        assert n >= -(-sum(r.bucket == lb and r.kind == kind
                           for r in results) // server.slab_docs[lb])
    lens = out["corpus"].test_mask.sum(-1)
    assert int(lens.min()) >= 2 and int(lens.max()) <= 16
