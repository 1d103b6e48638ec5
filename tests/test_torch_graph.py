"""The port's graphs and gossip schedules against the JAX package's.

Both are host-side numpy drawn from ``np.random.default_rng(seed)``, so
edges, degrees, lambda2, matchings and schedules are equal bit for bit
for the same seed. The one documented difference: the port's
``erdos_renyi_graph`` retries a draw with no edges where the reference
raises (ROADMAP R3).
"""

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import comm as ref_comm  # noqa: E402
from repro.core import deleda as ref_deleda  # noqa: E402
from repro.core import gossip as ref_gossip  # noqa: E402
from repro.core import graph as ref_graph  # noqa: E402
from repro_torch.core import comm, deleda, gossip, graph  # noqa: E402

CONSTRUCTORS = [
    ("complete_graph", (7,)), ("complete_graph", (2,)),
    ("ring_graph", (9,)), ("star_graph", (6,)), ("grid_graph", (3, 4)),
    ("hypercube_graph", (4,)),
    ("watts_strogatz_graph", (20, 4, 0.3, 0)),
    ("watts_strogatz_graph", (50, 4, 0.3, 0)),
    ("watts_strogatz_graph", (16, 6, 0.5, 3)),
    ("erdos_renyi_graph", (12, 0.3, 1)),
    ("erdos_renyi_graph", (30, 0.2, 7)),
]
SEEDS = (0, 1, 17)


def _same_graph(got, want):
    np.testing.assert_array_equal(got.edges, want.edges)
    assert got.edges.dtype == want.edges.dtype
    assert got.n_nodes == want.n_nodes and got.name == want.name
    np.testing.assert_array_equal(got.degrees, want.degrees)
    np.testing.assert_array_equal(got.adjacency(), want.adjacency())
    np.testing.assert_array_equal(got.expected_w(), want.expected_w())
    assert got.lambda2() == want.lambda2()
    assert got.spectral_gap() == want.spectral_gap()
    assert got.is_connected() == want.is_connected()


@pytest.mark.parametrize("name,args", CONSTRUCTORS,
                         ids=[f"{n}{a}" for n, a in CONSTRUCTORS])
def test_constructors_match_reference(name, args):
    _same_graph(getattr(graph, name)(*args), getattr(ref_graph, name)(*args))


@pytest.mark.parametrize("seed", SEEDS)
def test_paper_graphs_match_reference(seed):
    got, want = graph.paper_graphs(50, seed), ref_graph.paper_graphs(50, seed)
    assert list(got) == list(want)
    for k in got:
        _same_graph(got[k], want[k])


@pytest.mark.parametrize("seed", SEEDS)
def test_random_matching_matches_reference(seed):
    g = graph.watts_strogatz_graph(20, 4, 0.3, seed)
    rg = ref_graph.watts_strogatz_graph(20, 4, 0.3, seed)
    for _ in range(3):
        np.testing.assert_array_equal(
            graph.random_matching(g, np.random.default_rng(seed)),
            ref_graph.random_matching(rg, np.random.default_rng(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["edge", "matching"])
def test_schedules_match_reference(seed, kind):
    g = graph.watts_strogatz_graph(16, 4, 0.3, seed)
    rg = ref_graph.watts_strogatz_graph(16, 4, 0.3, seed)
    if kind == "edge":
        got = gossip.draw_edge_schedule(g, 40, np.random.default_rng(seed))
        want = ref_gossip.draw_edge_schedule(rg, 40,
                                             np.random.default_rng(seed))
        sched = comm.GossipSchedule.draw_edges(g, 40,
                                               np.random.default_rng(seed))
    else:
        got = gossip.draw_matching_schedule(g, 40,
                                            np.random.default_rng(seed))
        want = ref_gossip.draw_matching_schedule(
            rg, 40, np.random.default_rng(seed))
        sched = comm.GossipSchedule.draw_matchings(
            g, 40, np.random.default_rng(seed))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(sched.data, want)
    assert sched.kind == kind and sched.n_rounds == 40
    ps, pd = deleda.make_run_inputs(g, 40, seed=seed, kind=kind)
    rs, rd = ref_deleda.make_run_inputs(rg, 40, seed=seed, kind=kind)
    assert ps.kind == kind and ps.n_nodes == g.n_nodes
    np.testing.assert_array_equal(ps.data, np.asarray(rs))
    np.testing.assert_array_equal(pd, np.asarray(rd))


@pytest.mark.parametrize("n", [2, 5, 8])
def test_fixed_matchings_match_reference(n):
    np.testing.assert_array_equal(gossip.ring_matchings(n),
                                  ref_gossip.ring_matchings(n))
    if n & (n - 1) == 0:
        np.testing.assert_array_equal(gossip.hypercube_partners(n),
                                      ref_gossip.hypercube_partners(n))
    p = gossip.ring_matchings(n)[0]
    np.testing.assert_array_equal(gossip.mixing_matrix_matching(p),
                                  ref_gossip.mixing_matrix_matching(p))
    np.testing.assert_array_equal(gossip.mixing_matrix_edge(n, 0, n - 1),
                                  ref_gossip.mixing_matrix_edge(n, 0, n - 1))


def test_erdos_renyi_empty_draw_retries():
    """R3: seed 131 draws no edge for n=3, p=0.6 on its first attempt.
    The reference raises in ``Graph``; the port retries and connects."""
    with pytest.raises(ValueError, match="edges must be"):
        ref_graph.erdos_renyi_graph(3, 0.6, seed=131)
    g = graph.erdos_renyi_graph(3, 0.6, seed=131)
    assert g.n_edges >= 2 and g.is_connected()
    assert 0.0 < g.lambda2() < 1.0


def test_schedule_validation_matches_reference():
    good = np.array([[1, 0, 2, 3]])
    for cls in (comm.GossipSchedule, ref_comm.GossipSchedule):
        assert cls("matching", good, 4).n_rounds == 1
        with pytest.raises(ValueError, match="involution"):
            cls("matching", np.array([[1, 2, 0, 3]]), 4)
        with pytest.raises(ValueError, match="out of range"):
            cls("edge", np.array([[0, 4]]), 4)
        with pytest.raises(ValueError):
            cls("edges", good, 4)
