"""The port's scenario layer against the JAX package's, on the CPU.

Given the same ``np.random.Generator`` the port's ``GraphSequence`` and
``Scenario.compile`` draw the reference's arrays bit for bit (schedule,
segments, alive, degrees, member and every event count). ``run_deleda``
on a compiled scenario (per-step degrees, drops, churn, a join and a
leave) follows the reference's run on the reference's corpus from its
initial statistic at ``tests/test_golden.py``'s tolerances (steps exact,
mass rtol 1e-4, probe rtol 3e-3, in-loop LP rtol 1e-5). The non-IID
corpus keeps beta*, the held-out set and every IID corpus; its skew
transform is the reference's. The scenario experiment and
``launch/scenario_bench`` run end to end at ``SCENARIO_SMOKE``.
"""

import dataclasses
import hashlib
import os

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import comm as ref_comm  # noqa: E402
from repro.core import deleda as ref_deleda  # noqa: E402
from repro.core import evaluation as ref_eval  # noqa: E402
from repro.core import graph as ref_graph  # noqa: E402
from repro.core import lda as ref_lda  # noqa: E402
from repro.core import scenario as ref_scn  # noqa: E402
from repro.data import lda_synthetic as ref_synth  # noqa: E402
from repro_torch.core import comm, deleda, evaluation, graph, lda  # noqa: E402
from repro_torch.core import scenario as scn  # noqa: E402
from repro_torch.core import threefry as tf3  # noqa: E402
from repro_torch.data import lda_synthetic as synth  # noqa: E402
from repro_torch.launch import deleda_experiment as dexp  # noqa: E402
from repro_torch.launch import scenario_bench  # noqa: E402
from torch_parity import port_key, reference_mode, to_torch  # noqa: E402

# tests/test_golden.py's shapes
KW = dict(n_topics=3, vocab_size=20, alpha=0.5, doc_len_max=8, n_gibbs=4,
          n_gibbs_burnin=2)
CFG = lda.LDAConfig(**KW)
N, T, REC = 8, 20, 10
pytestmark = pytest.mark.filterwarnings(
    "ignore:.*document lengths fell outside:UserWarning")


def _ws(mod, seed, n=N):
    return mod.watts_strogatz_graph(n, 4, 0.3, seed=seed)


def _rewiring(mod_scn, mod_graph, n_segments=2, steps=T // 2, seed=0):
    return mod_scn.GraphSequence.rewiring(
        lambda s: _ws(mod_graph, s), n_segments, steps, seed=seed)


def _mixed(mod_scn, mod_graph, kind):
    """Rewiring, drops, churn, a cold join and a leave in one regime."""
    return mod_scn.Scenario(topology=_rewiring(mod_scn, mod_graph),
                            kind=kind, drop_prob=0.2, churn=0.2,
                            churn_mean_down=4.0, joins=((7, 10),),
                            leaves=((2, 15),), name="mixed")


def _assert_compiled_equal(got, want):
    assert got.schedule.kind == want.schedule.kind
    np.testing.assert_array_equal(got.schedule.data, want.schedule.data)
    np.testing.assert_array_equal(got.schedule.segments,
                                  want.schedule.segments)
    assert got.schedule.n_segments == want.schedule.n_segments
    for name in ("alive", "degrees"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (got.member is None) == (want.member is None)
    if want.member is not None:
        np.testing.assert_array_equal(got.member, want.member)
    for name in ("n_events", "n_dropped", "n_churned", "n_excluded",
                 "n_sponsored"):
        assert getattr(got, name) == getattr(want, name), name


# ---------------------------------------------------------------------------
# GraphSequence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 5])
def test_graph_sequence_matches_reference(seed):
    pairs = [(scn.GraphSequence.static(_ws(graph, seed), 12),
              ref_scn.GraphSequence.static(_ws(ref_graph, seed), 12)),
             (_rewiring(scn, graph, 3, 4, seed),
              _rewiring(ref_scn, ref_graph, 3, 4, seed))]
    for got, want in pairs:
        assert got.name == want.name
        assert (got.n_nodes, got.n_segments, got.n_steps) == (
            want.n_nodes, want.n_segments, want.n_steps)
        for g, w in zip(got.graphs, want.graphs):
            np.testing.assert_array_equal(g.edges, w.edges)
        np.testing.assert_array_equal(got.segment_ids(), want.segment_ids())
        assert got.degrees().dtype == np.int32
        np.testing.assert_array_equal(got.degrees(), want.degrees())
        np.testing.assert_array_equal(got.graph_at(got.n_steps - 1).edges,
                                      want.graph_at(want.n_steps - 1).edges)
        for kind in ("edge", "matching"):
            a = got.draw_schedule(kind, np.random.default_rng(seed))
            b = want.draw_schedule(kind, np.random.default_rng(seed))
            np.testing.assert_array_equal(a.data, b.data)
            np.testing.assert_array_equal(a.segments, b.segments)


@pytest.mark.parametrize("case", ["length", "steps", "nodes", "empty",
                                  "kind"])
def test_graph_sequence_validation_matches_reference(case):
    def build(mod_scn, mod_graph):
        g = _ws(mod_graph, 0)
        if case == "length":
            return mod_scn.GraphSequence((g,), (5, 5))
        if case == "steps":
            return mod_scn.GraphSequence((g,), (0,))
        if case == "nodes":
            return mod_scn.GraphSequence((g, mod_graph.complete_graph(4)),
                                         (5, 5))
        if case == "empty":
            return mod_scn.GraphSequence((), ())
        return mod_scn.GraphSequence.static(g, 4).draw_schedule(
            "smoke-signals", np.random.default_rng(0))

    with pytest.raises(ValueError) as want:
        build(ref_scn, ref_graph)
    with pytest.raises(ValueError) as got:
        build(scn, graph)
    assert str(got.value) == str(want.value)


def test_draw_schedule_respects_segment_topology():
    seq = _rewiring(scn, graph, 3, 8)
    sched = seq.draw_schedule("matching", np.random.default_rng(0))
    partners = sched.partners()
    for t in range(sched.n_rounds):
        edges = {tuple(e) for e in seq.graphs[sched.segments[t]].edges}
        edges |= {(b, a) for a, b in edges}
        for i, p in enumerate(partners[t]):
            assert p == i or (i, int(p)) in edges


# ---------------------------------------------------------------------------
# Scenario.compile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["edge", "matching"])
@pytest.mark.parametrize("name", scn.SCENARIO_NAMES)
def test_compile_matches_reference(name, kind):
    sc = dataclasses.replace(scn.paper_scenario(name, n=12, n_steps=20,
                                                seed=3), kind=kind)
    ref_sc = dataclasses.replace(ref_scn.paper_scenario(name, n=12,
                                                        n_steps=20, seed=3),
                                 kind=kind)
    got = sc.compile(np.random.default_rng(17))
    want = ref_sc.compile(np.random.default_rng(17))
    _assert_compiled_equal(got, want)
    assert sc.topic_skew == ref_sc.topic_skew


@pytest.mark.parametrize("kind", ["edge", "matching"])
def test_compile_drops_churn_joins_leave_match_reference(kind):
    sc = dataclasses.replace(_mixed(scn, graph, kind), drop_prob=0.3,
                             joins=((7, 10), (4, 10)))
    ref_sc = dataclasses.replace(_mixed(ref_scn, ref_graph, kind),
                                 drop_prob=0.3, joins=((7, 10), (4, 10)))
    for seed in (0, 1, 2):
        got = sc.compile(np.random.default_rng(seed))
        _assert_compiled_equal(got, ref_sc.compile(
            np.random.default_rng(seed)))
    assert got.n_dropped + got.n_churned + got.n_excluded > 0
    # an int seed is a default_rng seed, as in the reference
    _assert_compiled_equal(sc.compile(4), ref_sc.compile(4))


_BAD_SCENARIOS = {
    "drop": dict(drop_prob=1.0),
    "churn": dict(churn=-0.1),
    "kind": dict(kind="smoke-signals"),
    "chain": dict(churn=0.9, churn_mean_down=1.0),
    "down": dict(churn_mean_down=0.5),
    "join_node": dict(joins=((8, 3),)),
    "join_step": dict(joins=((1, 20),)),
    "leave_step": dict(leaves=((1, 0),)),
    "twice": dict(joins=((1, 3), (1, 5))),
    "order": dict(joins=((1, 9),), leaves=((1, 9),)),
}


@pytest.mark.parametrize("case", sorted(_BAD_SCENARIOS))
def test_scenario_validation_matches_reference(case):
    kw = _BAD_SCENARIOS[case]
    with pytest.raises(ValueError) as want:
        ref_scn.Scenario(topology=ref_scn.GraphSequence.static(
            _ws(ref_graph, 0), T), **kw)
    with pytest.raises(ValueError) as got:
        scn.Scenario(topology=scn.GraphSequence.static(_ws(graph, 0), T),
                     **kw)
    assert str(got.value) == str(want.value)


def test_paper_scenario_registry_matches_reference():
    assert scn.SCENARIO_NAMES == ref_scn.SCENARIO_NAMES
    for name in scn.SCENARIO_NAMES:
        got = scn.paper_scenario(name, n=12, n_steps=20, seed=1)
        want = ref_scn.paper_scenario(name, n=12, n_steps=20, seed=1)
        for field in ("name", "kind", "drop_prob", "churn",
                      "churn_mean_down", "topic_skew", "joins", "leaves"):
            assert getattr(got, field) == getattr(want, field), field
        assert got.topology.segment_steps == want.topology.segment_steps
    for args in (("carrier-pigeon",), ("rewiring", 12, 21)):
        with pytest.raises(ValueError) as want:
            ref_scn.paper_scenario(*args)
        with pytest.raises(ValueError) as got:
            scn.paper_scenario(*args)
        assert str(got.value) == str(want.value)


def test_draw_alive_stationary_fraction_and_spells():
    sc = scn.Scenario(topology=scn.GraphSequence.static(_ws(graph, 0), 4000),
                      churn=0.25, churn_mean_down=8.0)
    alive = sc.draw_alive(np.random.default_rng(0))
    assert abs((1.0 - alive.mean()) - 0.25) < 0.04
    spells = []
    for node in range(N):
        run = 0
        for up in alive[:, node]:
            if not up:
                run += 1
            elif run:
                spells.append(run)
                run = 0
    assert abs(np.mean(spells) - 8.0) < 2.0


def test_run_inputs_stay_on_the_host():
    compiled = _mixed(scn, graph, "matching").compile(
        np.random.default_rng(0))
    sched, degs, alive, member = compiled.run_inputs()
    assert isinstance(sched, comm.GossipSchedule)
    assert sched.segments is not None and sched.n_segments == 2
    assert all(isinstance(x, np.ndarray) for x in (degs, alive, member))
    assert degs.shape == alive.shape == member.shape == (T, N)
    assert scn.paper_scenario("static", n=N, n_steps=T).compile(
        0).run_inputs()[3] is None


# ---------------------------------------------------------------------------
# GossipSchedule
# ---------------------------------------------------------------------------

def test_schedule_constructors_match_reference():
    for got, want in (
            (comm.GossipSchedule.hypercube(8),
             ref_comm.GossipSchedule.hypercube(8)),
            (comm.GossipSchedule.ring(6, 5), ref_comm.GossipSchedule.ring(6,
                                                                        5)),
            (comm.GossipSchedule.ring(7), ref_comm.GossipSchedule.ring(7))):
        assert (got.kind, got.n_nodes) == (want.kind, want.n_nodes)
        np.testing.assert_array_equal(got.data, want.data)
    seq, ref_seq = _rewiring(scn, graph, 2, 5), _rewiring(ref_scn, ref_graph,
                                                          2, 5)
    got = seq.draw_schedule("edge", np.random.default_rng(3))
    want = ref_seq.draw_schedule("edge", np.random.default_rng(3))
    assert got.n_segments == want.n_segments == 2
    m, rm = got.as_matchings(), want.as_matchings()
    np.testing.assert_array_equal(m.data, rm.data)
    np.testing.assert_array_equal(m.segments, rm.segments)
    np.testing.assert_array_equal(got.partners(), want.partners())
    assert m.as_matchings() is m
    assert comm.GossipSchedule("edge", got.data, N).n_segments == 1
    for bad in (np.zeros(3), np.zeros((10, 1))):
        with pytest.raises(ValueError) as w:
            ref_comm.GossipSchedule("edge", got.data, N, segments=bad)
        with pytest.raises(ValueError) as g:
            comm.GossipSchedule("edge", got.data, N, segments=bad)
        assert str(g.value) == str(w.value)


def test_segmented_run_keeps_segments(monkeypatch, tmp_path):
    seen = []
    real = deleda.train_steps

    def spy(config, state, words, mask, schedule, *args, **kw):
        seen.append(schedule.segments.copy())
        return real(config, state, words, mask, schedule, *args, **kw)

    monkeypatch.setattr(deleda, "train_steps", spy)
    corpus = synth.make_corpus(CFG, tf3.key(0), synth.CorpusSpec(
        n_nodes=N, docs_per_node=4, n_test=4))
    seq = _rewiring(scn, graph, 4, 5)
    sched = seq.draw_schedule("matching", np.random.default_rng(0))
    deleda.run_deleda(deleda.DeledaConfig(lda=CFG, batch_size=2),
                      tf3.key(1), corpus.words, corpus.mask, sched,
                      seq.degrees(), T, record_every=REC, save_every=REC,
                      checkpoint_dir=str(tmp_path))
    assert len(seen) == 2
    np.testing.assert_array_equal(np.concatenate(seen), seq.segment_ids())


# ---------------------------------------------------------------------------
# run_deleda on compiled scenarios, against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_inputs():
    """The reference's corpus arrays and its initial statistic for key 1."""
    with reference_mode():
        corpus = ref_synth.make_corpus(ref_lda.LDAConfig(**KW),
                                       jax.random.key(0),
                                       ref_synth.CorpusSpec(
                                           n_nodes=N, docs_per_node=4,
                                           n_test=4))
        stats0 = np.array(ref_deleda.init_state(
            ref_deleda.DeledaConfig(lda=ref_lda.LDAConfig(**KW)),
            jax.random.key(1), N).stats)
    return dict(words=np.asarray(corpus.words), mask=np.asarray(corpus.mask),
                test_words=np.asarray(corpus.test_words),
                test_mask=np.asarray(corpus.test_mask), stats0=stats0)


def _ref_run(ref, compiled, eval_every=0, degrees=None, **cfg):
    sched, degs, alive, member = compiled.run_inputs()
    spec = None
    if eval_every:
        spec = ref_eval.EvalSpec(words=jnp.asarray(ref["test_words"]),
                                 mask=jnp.asarray(ref["test_mask"]),
                                 key=jax.random.key(7), n_particles=4,
                                 probe_nodes=2)
    with reference_mode():
        return ref_deleda.run_deleda(
            ref_deleda.DeledaConfig(lda=ref_lda.LDAConfig(**KW),
                                    batch_size=2, eval_every=eval_every,
                                    **cfg),
            jax.random.key(1), jnp.asarray(ref["words"]),
            jnp.asarray(ref["mask"]), sched,
            degs if degrees is None else jnp.asarray(degrees), T,
            record_every=REC, alive=alive, member=member, eval_spec=spec)


def _port_run(ref, compiled, eval_every=0, degrees=None, **cfg):
    sched, degs, alive, member = compiled.run_inputs()
    config = deleda.DeledaConfig(lda=CFG, batch_size=2,
                                 eval_every=eval_every, **cfg)
    spec = None
    if eval_every:
        spec = evaluation.EvalSpec(
            words=to_torch(ref["test_words"], torch.int64),
            mask=to_torch(ref["test_mask"]), key=port_key(jax.random.key(7)),
            n_particles=4, probe_nodes=2)
    key = port_key(jax.random.key(1))
    init = dataclasses.replace(deleda.init_state(config, key, N),
                               stats=torch.from_numpy(ref["stats0"]))
    return deleda.run_deleda(
        config, key, to_torch(ref["words"], torch.int64),
        to_torch(ref["mask"]), sched, degs if degrees is None else degrees,
        T, record_every=REC, eval_spec=spec, init=init, alive=alive,
        member=member)


def _assert_golden_close(got, want):
    """tests/test_golden.py's tolerances."""
    assert got.steps.tolist() == np.asarray(want.steps).tolist()
    a = got.stats.double().numpy()
    b = np.asarray(want.stats, np.float64)
    np.testing.assert_allclose(a.sum(), b.sum(), rtol=1e-4)
    np.testing.assert_allclose(a[::3, 1, ::7], b[::3, 1, ::7], rtol=3e-3,
                               atol=1e-5)
    if want.eval_lp is not None:
        np.testing.assert_allclose(got.eval_lp.double().numpy(),
                                   np.asarray(want.eval_lp), rtol=1e-5)


@pytest.mark.parametrize("kind", ["edge", "matching"])
@pytest.mark.parametrize("mode", ["async", "sync"])
def test_scenario_run_matches_reference(ref_inputs, mode, kind):
    compiled = _mixed(scn, graph, kind).compile(np.random.default_rng(5))
    ref_compiled = _mixed(ref_scn, ref_graph, kind).compile(
        np.random.default_rng(5))
    _assert_compiled_equal(compiled, ref_compiled)
    got = _port_run(ref_inputs, compiled, eval_every=REC, mode=mode)
    _assert_golden_close(got, _ref_run(ref_inputs, ref_compiled,
                                       eval_every=REC, mode=mode))
    live = compiled.alive & compiled.member
    assert (got.steps.numpy() <= live.sum(0)).all()


def test_degree_correction_off_matches_reference(ref_inputs):
    compiled = _mixed(scn, graph, "edge").compile(np.random.default_rng(6))
    ref_compiled = _mixed(ref_scn, ref_graph, "edge").compile(
        np.random.default_rng(6))
    got = _port_run(ref_inputs, compiled, degree_correction=False)
    _assert_golden_close(got, _ref_run(ref_inputs, ref_compiled,
                                       degree_correction=False))
    on = _port_run(ref_inputs, compiled)
    assert not torch.equal(on.stats, got.stats)
    # off, the rewired degrees change nothing
    flat = _port_run(ref_inputs, compiled, degrees=np.ones(N, np.int32),
                     degree_correction=False)
    assert torch.equal(flat.stats, got.stats)


def test_per_step_degrees_repeating_the_row_give_its_bits(ref_inputs):
    seq = scn.GraphSequence.static(graph.ring_graph(N), T)
    compiled = scn.Scenario(topology=seq, kind="edge",
                            drop_prob=0.2).compile(1)
    assert compiled.degrees.shape == (T, N)
    row = _port_run(ref_inputs, compiled, degrees=compiled.degrees[0])
    per_step = _port_run(ref_inputs, compiled)
    assert torch.equal(row.stats, per_step.stats)
    assert torch.equal(row.steps, per_step.steps)


def test_all_dropped_round_is_the_identity(ref_inputs):
    idle = comm.GossipSchedule("matching", np.broadcast_to(
        np.arange(N, dtype=np.int32), (T, N)), N)
    compiled = scn.CompiledScenario(
        schedule=idle, alive=np.ones((T, N), bool),
        degrees=np.full((T, N), 4, np.int32), n_events=0, n_dropped=0,
        n_churned=0)
    trace = _port_run(ref_inputs, compiled)
    assert int(trace.steps.sum()) == 0
    assert torch.equal(trace.history[0], trace.history[1])
    assert torch.equal(trace.stats, torch.from_numpy(ref_inputs["stats0"]))


def test_dropped_edge_wakes_no_one(ref_inputs):
    seq = scn.GraphSequence.static(graph.complete_graph(N), T)
    compiled = scn.Scenario(topology=seq, kind="edge",
                            drop_prob=0.4).compile(5)
    data = compiled.schedule.data
    live = int((data[:, 0] != data[:, 1]).sum())
    assert 0 < live < T
    trace = _port_run(ref_inputs, compiled)
    assert int(trace.steps.sum()) == 2 * live


@pytest.mark.parametrize("shape", [(N + 1,), (T - 1, N), (T, N, 1)])
def test_bad_degrees_shape_raises(ref_inputs, shape):
    """The reference's message; its 1-D path broadcasts a wrong [n'] row
    and fails inside the broadcast instead (a ValueError all the same)."""
    compiled = scn.paper_scenario("static", n=N, n_steps=T).compile(0)
    ref_compiled = ref_scn.paper_scenario("static", n=N, n_steps=T).compile(0)
    bad = np.ones(shape, np.int32)
    with pytest.raises(ValueError) as want:
        _ref_run(ref_inputs, ref_compiled, degrees=bad)
    with pytest.raises(ValueError) as got:
        _port_run(ref_inputs, compiled, degrees=bad)
    msg = f"degrees must be [n={N}] or [{T}, {N}], got shape {shape}"
    assert str(got.value) == msg
    if len(shape) > 1:
        assert str(want.value) == msg


# ---------------------------------------------------------------------------
# Non-IID shards
# ---------------------------------------------------------------------------

def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def test_no_skew_keeps_every_corpus():
    """The paper-scale corpus of seed 0 and a stream segment, pinned from
    the tree before topic skew; and LP* 35.686 on the CPU."""
    p = dexp.PAPER
    corpus = synth.make_corpus(p.lda, tf3.key(0), p.corpus)
    assert corpus.node_topic_weights is None
    assert _digest(corpus.words, corpus.mask, corpus.test_words,
                   corpus.test_mask, corpus.beta_star) == (
        "cc23010f346b08c3c5f1d270b8c6d190d1da55c7bffce221308fd65333ff0b70")
    _, lp_star = dexp.make_beta_evaluator(p, corpus, 0)
    assert lp_star == pytest.approx(35.68646240234375, rel=1e-6)
    stream = synth.make_corpus_stream(p.lda, tf3.key(0), synth.CorpusSpec(
        n_nodes=50, docs_per_node=20, n_test=100, refresh_every=10))
    assert stream.alpha_vecs is None
    assert _digest(*stream.segment(2)) == (
        "f7fcc8008091009b9e221194fba97a7c11295ecc91ddd8ff21ee8cded7d38472")


def test_skew_rebiases_only_the_training_shards():
    spec = synth.CorpusSpec(n_nodes=6, docs_per_node=5, n_test=7)
    base = synth.make_corpus(CFG, tf3.key(3), spec)
    skewed = synth.make_corpus(CFG, tf3.key(3), dataclasses.replace(
        spec, topic_skew=0.3))
    for name in ("beta_star", "test_words", "test_mask", "mask"):
        assert torch.equal(getattr(skewed, name), getattr(base, name)), name
    assert not torch.equal(skewed.words, base.words)
    w = skewed.node_topic_weights
    assert w.shape == (6, 3)
    torch.testing.assert_close(w.sum(-1), torch.ones(6))
    assert torch.equal(w, synth.node_alpha_vectors(
        CFG, tf3.fold_in_data(tf3.key(3), 0x5157), 6, 0.3)[0])


@pytest.mark.parametrize("skew", [0.02, 0.5, 5.0])
def test_skew_transform_matches_reference(monkeypatch, skew):
    """The port's weights through the reference's own transform (its
    Dirichlet draw replaced by them) give the port's priors."""
    weights, alphas = synth.node_alpha_vectors(CFG, tf3.key(int(skew * 100)),
                                               40, skew)
    torch.testing.assert_close(alphas.sum(-1), torch.full(
        (40,), CFG.n_topics * CFG.alpha), rtol=1e-6, atol=0)
    assert float(weights.min()) >= 1e-6 * 0.99
    # the drawn weights before the floor, replayed into the reference
    g = torch.clamp(torch._standard_gamma(
        torch.full((40, CFG.n_topics), skew),
        generator=lda.generator_from_key(tf3.key(int(skew * 100)))),
        min=1e-30)
    drawn = (g / g.sum(-1, keepdim=True)).numpy()
    monkeypatch.setattr(jax.random, "dirichlet",
                        lambda key, a, shape=None: jnp.asarray(drawn))
    ref_w, ref_a = ref_synth.node_alpha_vectors(ref_lda.LDAConfig(**KW),
                                                jax.random.key(0), 40, skew)
    np.testing.assert_allclose(weights.numpy(), np.asarray(ref_w),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(alphas.numpy(), np.asarray(ref_a), rtol=1e-6,
                               atol=0)


def test_skew_weights_follow_the_dirichlet():
    """Moments of the port's node weights against Dirichlet(skew) and
    against the reference's draw."""
    n, k, skew = 4000, CFG.n_topics, 0.5
    w = synth.node_alpha_vectors(CFG, tf3.key(11), n, skew)[0].numpy()
    with reference_mode():
        rw = np.asarray(ref_synth.node_alpha_vectors(
            ref_lda.LDAConfig(**KW), jax.random.key(11), n, skew)[0])
    var = (1 / k) * (1 - 1 / k) / (k * skew + 1)
    for x in (w, rw):
        np.testing.assert_allclose(x.mean(0), 1 / k, atol=0.015)
        np.testing.assert_allclose(x.var(0), var, rtol=0.1)
    assert abs(w.max(-1).mean() - rw.max(-1).mean()) < 0.02


def test_skewed_stream_redraws_with_the_skewed_priors(monkeypatch):
    spec = synth.CorpusSpec(n_nodes=4, docs_per_node=3, n_test=5,
                            topic_skew=0.2, refresh_every=10)
    stream = synth.make_corpus_stream(CFG, tf3.key(2), spec)
    node = stream.base.node_topic_weights
    want = (CFG.n_topics * CFG.alpha * node).repeat_interleave(3, dim=0)
    torch.testing.assert_close(stream.alpha_vecs, want, rtol=1e-6, atol=0)
    seen = []
    real = synth.sample_documents

    def spy(config, gen, beta, lengths, alpha_vec=None):
        seen.append(alpha_vec)
        return real(config, gen, beta, lengths, alpha_vec)

    monkeypatch.setattr(synth, "sample_documents", spy)
    words, _ = stream.segment(1)
    assert len(seen) == 1 and torch.equal(seen[0], stream.alpha_vecs)
    assert not torch.equal(words, stream.base.words)


def test_paper_corpus_and_skew_validation_match_reference(monkeypatch):
    config, corpus = synth.paper_corpus(tf3.key(0), doc_len_max=24)
    # the reference's config and spec, without drawing its corpus
    monkeypatch.setattr(ref_synth, "make_corpus",
                        lambda cfg, key, spec: spec)
    want, ref_spec = ref_synth.paper_corpus(jax.random.key(0),
                                            doc_len_max=24)
    for field in ("n_topics", "vocab_size", "alpha", "doc_len_max",
                  "n_gibbs", "n_gibbs_burnin", "tau"):
        assert getattr(config, field) == getattr(want, field)
    assert (ref_spec.n_nodes, ref_spec.docs_per_node, ref_spec.n_test,
            ref_spec.topic_skew) == (50, 20, 100, None)
    assert tuple(corpus.words.shape) == (50, 20, 24)
    assert tuple(corpus.test_words.shape) == (100, 24)
    assert corpus.node_topic_weights is None
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError) as w:
            ref_synth.CorpusSpec(topic_skew=bad)
        with pytest.raises(ValueError) as g:
            synth.CorpusSpec(topic_skew=bad)
        assert str(g.value) == str(w.value)


# ---------------------------------------------------------------------------
# The experiment and the bench at SCENARIO_SMOKE
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_sweep():
    return dexp.run_scenario_experiment(dexp.SCENARIO_SMOKE, seeds=(0, 1),
                                        device="cpu", verbose=False)


def test_scenario_scales_match_reference():
    from benchmarks import _deleda_experiment as ref_exp

    for name in ("scenario_paper", "scenario_smoke"):
        got, want = dexp.get_scale(name), ref_exp.get_scale(name)
        for field in ("n_steps", "record_every", "batch_size", "ws_k",
                      "n_particles", "probe_nodes"):
            assert getattr(got, field) == getattr(want, field)
        for field in ("n_topics", "vocab_size", "alpha", "doc_len_max",
                      "n_gibbs", "n_gibbs_burnin"):
            assert getattr(got.lda, field) == getattr(want.lda, field)
        for field in ("n_nodes", "docs_per_node", "n_test"):
            assert getattr(got.corpus, field) == getattr(want.corpus, field)


def test_scenario_experiment_events_match_reference(smoke_sweep):
    scale = dexp.SCENARIO_SMOKE
    for seed, res in smoke_sweep["per_seed"].items():
        assert set(res["runs"]) == set(scn.SCENARIO_NAMES)
        for name, run in res["runs"].items():
            want = ref_scn.paper_scenario(
                name, n=scale.corpus.n_nodes, n_steps=scale.n_steps,
                seed=seed, ws_k=scale.ws_k).compile(
                np.random.default_rng(seed + 17))
            assert run["events"] == {
                "drawn": want.n_events, "dropped": want.n_dropped,
                "churned": want.n_churned, "excluded": want.n_excluded,
                "sponsored": want.n_sponsored}, (seed, name)
            assert run["n_segments"] == want.schedule.n_segments
            assert np.isfinite(run["rel_perplexity"])
        assert res["runs"]["static"]["lp_ratio_vs_static"] == 0.0
        assert res["runs"]["coldjoin"]["tail_within_envelope"] >= 0.0


def test_seeds_option_equals_single_seed_calls(smoke_sweep):
    one = dexp.run_scenario_experiment(
        dexp.SCENARIO_SMOKE, scenario_names=("static", "drop10"), seed=1,
        device="cpu", verbose=False)
    per = smoke_sweep["per_seed"][1]["runs"]
    for name in ("static", "drop10"):
        for key in ("rel_perplexity", "consensus", "events",
                    "mean_steps_per_node"):
            assert one["runs"][name][key] == per[name][key], (name, key)
        # D is a float32 least-squares solve: LAPACK may round it apart
        # in the last bits between two calls on the same statistic
        assert one["runs"][name]["beta_distance"] == pytest.approx(
            per[name]["beta_distance"], rel=1e-6)
    over = smoke_sweep["regimes_over_seeds"]
    for name in scn.SCENARIO_NAMES:
        for key in ("rel_perplexity", "beta_distance", "lp_ratio_vs_static"):
            vals = [r["runs"][name][key]
                    for r in smoke_sweep["per_seed"].values()]
            assert over[name][key] == dexp.spread(vals)
            assert over[name][key]["min"] <= over[name][key]["mean"] <= \
                over[name][key]["max"]


def test_fig1_seeds_option_reports_claims_over_seeds():
    scale = dexp.ExperimentScale(
        lda=lda.LDAConfig(n_topics=3, vocab_size=24, alpha=0.5,
                          doc_len_max=10, n_gibbs=4, n_gibbs_burnin=2),
        corpus=synth.CorpusSpec(n_nodes=6, docs_per_node=4, n_test=6),
        n_steps=12, record_every=6, batch_size=2, ws_k=2, n_particles=3,
        probe_nodes=2)
    res = dexp.run_experiment(scale, device="cpu", verbose=False,
                              seeds=(1, 2))
    assert res["seeds"] == [1, 2]
    single = dexp.run_experiment(scale, seed=2, device="cpu", verbose=False)
    assert dexp.claims(single) == res["per_seed"][2]["claims"]
    over = res["claims_over_seeds"]
    for name, c1 in over["C1"].items():
        gaps = [res["per_seed"][s]["claims"]["C1"][name]["gap_to_goem"]
                for s in (1, 2)]
        assert {k: c1[k] for k in ("mean", "min", "max")} == dexp.spread(gaps)
        assert c1["seeds"] == 2 and 0 <= c1["holds"] <= 2
    assert set(over["C3_sync_minus_async"]) == {"complete", "watts_strogatz"}
    assert set(over["C2_ws_minus_complete"]) == {"async", "sync"}


def test_scenario_bench_smoke_cli(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    res = scenario_bench.main(["--scale", "smoke", "--device", "cpu",
                               "--resume-smoke"])
    assert res["accept"] is True
    assert res["resume_bitwise"] == {"static": True, "coldjoin": True}
    # the CPU runs the plain versions: no kernel launched
    assert res["kernel_launches"] == {"gossip_mix": 0, "lda_gibbs": 0,
                                      "lda_l2r": 0}
    assert os.listdir(tmp_path) == []          # no file by default
    assert "accept=True" in capsys.readouterr().out


def test_scenario_bench_gates():
    def runs(rewiring, drop, tail):
        return {"runs": {"rewiring": {"lp_ratio_vs_static": rewiring},
                         "drop10": {"lp_ratio_vs_static": drop},
                         "coldjoin": {"tail_within_envelope": tail}}}

    assert all(ok for _v, ok in scenario_bench.gates(
        runs(0.0999, -0.05, 1.0)).values())
    got = scenario_bench.gates(runs(-0.11, 0.01, 0.75))
    assert [got[k][1] for k in ("rewiring", "drop10", "coldjoin")] == [
        False, True, False]
    assert scenario_bench.ACCEPT_RATIO == 0.10
    assert scenario_bench.COLDJOIN_TAIL_FRAC == 1.0


def test_scenario_bench_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        scenario_bench.main(["--scale", "smoke"])


def test_scenario_sweep_on_reference_corpus_matches_reference():
    """Level 3's separation: on the reference's corpus the port's sweep
    gives the reference's numbers, so a miss of the port's own sweep
    comes from its corpus draw (``tests/torch_level3.py``)."""
    import torch_level3

    names = ("static", "noniid", "coldjoin")   # the skew and a membership
    ref = torch_level3.reference_sweep("scenario_smoke", 0, names)
    port = torch_level3.port_sweep_on_reference_corpus("scenario_smoke", 0,
                                                       names)
    assert port["lp_star"] == pytest.approx(ref["lp_star"], rel=1e-5)
    for name in names:
        for m in torch_level3.METRICS:
            assert port["runs"][name][m] == pytest.approx(
                ref["runs"][name][m], abs=1e-4), (name, m)
        assert port["runs"][name]["events"] == {
            k: ref["runs"][name]["events"].get(k, 0)
            for k in port["runs"][name]["events"]}
