"""Device rules of the port, and its separation from the JAX package.

Entry points run on CUDA unless the caller asks for the CPU, and raise
without a GPU; the port and ``chip_smoke.py`` import neither ``jax`` nor
``repro``; the package imports with no ``triton`` and no ``nvcc``. The
kernels' agreement with their plain versions needs the card and is held
by ``chip_smoke.py`` and by the tests here that take ``cuda_device``,
which skip without one.
"""

import ast
import importlib
import pathlib
import pkgutil

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.launch import serve_topics  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.resolve_device()
    with pytest.raises(RuntimeError):
        repro_torch.resolve_device("cuda")
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        repro_torch.resolve_device("meta")


def test_serve_topics_defaults_to_cuda(no_gpu):
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_topics.main(["--requests", "1"])


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    assert path.exists(), path
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_package_imports_without_triton_or_nvcc(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    names = [m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch.")]
    assert "repro_torch.kernels.lda_gibbs.ops" in names
    for name in names:
        importlib.import_module(name)
    import sys
    assert "triton" not in sys.modules
    assert not common._LIBS, "no kernel is loaded at import"


def test_cuda_tensor_is_never_served_by_plain_code():
    """A tensor that is not on the CPU goes to the kernel wrapper, which
    refuses a non-CUDA device instead of falling back."""
    from repro_torch.kernels.lda_gibbs import ops as gibbs_ops
    from repro_torch.kernels.lda_l2r import ops as l2r_ops

    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        gibbs_ops.gibbs_sweeps(torch.empty(2, 3, 4, device=meta),
                               torch.empty(2, 3, device=meta),
                               torch.empty(5, 2, 3, device=meta),
                               torch.empty(2, 3, dtype=torch.int64,
                                           device=meta),
                               alpha=0.5, n_sweeps=5, burnin=2)
    with pytest.raises(ValueError, match="CUDA"):
        l2r_ops.l2r_scores(torch.empty(2, 2, dtype=torch.int64, device=meta),
                           torch.empty(2, 3, 4, device=meta),
                           torch.empty(2, 3, device=meta), 0.5,
                           n_particles=3)


def test_sparse_cuda_tensor_is_never_served_by_plain_code():
    """lda_sparse, like the other wrappers, refuses a non-CUDA device
    that is not the CPU instead of falling back."""
    from repro_torch.kernels.lda_sparse import ops as sparse_ops

    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        sparse_ops.sparse_sweeps(torch.empty(2, 3, 4, device=meta),
                                 torch.empty(2, 3, device=meta),
                                 torch.empty(5, 2, 3, device=meta),
                                 torch.empty(2, 3, dtype=torch.int64,
                                             device=meta),
                                 alpha=0.5, n_sweeps=5, burnin=2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernels run only on "
                    "the card")
    return torch.device("cuda")


def test_kernels_match_plain_on_card(cuda_device):
    from repro_torch.core import estep, evaluation
    from repro_torch.core import threefry as tf3
    from repro_torch.kernels.lda_gibbs import ops as gibbs_ops
    from repro_torch.kernels.lda_l2r import ops as l2r_ops

    rng = np.random.default_rng(0)
    b, l, k, s = 11, 16, 7, 6
    bw = torch.from_numpy(rng.random((b, l, k), dtype=np.float32) + 1e-3)
    mask = torch.from_numpy((rng.random((b, l)) < 0.8).astype(np.float32))
    u = torch.from_numpy(rng.random((s, b, l), dtype=np.float32))
    z0 = torch.from_numpy(rng.integers(0, k, (b, l)))
    args = [x.to(cuda_device) for x in (bw, mask, u, z0)]
    got = gibbs_ops.gibbs_sweeps(*args, alpha=0.5, n_sweeps=s, burnin=3)
    want = estep.gibbs_sweeps_dense(*args, alpha=0.5, n_sweeps=s, burnin=3)
    assert torch.equal(got[1], want[1])       # the same draws
    for g, w in (got[0], want[0]), (got[2], want[2]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    kd = tf3.fold_in_data(tf3.key(1, cuda_device),
                          torch.arange(b, device=cuda_device))
    got = l2r_ops.l2r_scores(kd, args[0], args[1], 0.5, n_particles=4)
    want = evaluation.l2r_position_scores(kd, args[0], args[1], 0.5, 4)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


def test_gossip_mix_matches_plain_on_card(cuda_device):
    """K1 in place over the matched pairs equals ``0.5 * (S + S[p])``
    exactly, on the float4 path and on the one-float path, and counts one
    launch per call."""
    from repro_torch.kernels.gossip_mix import ops as mix_ops
    from repro_torch.kernels.gossip_mix import ref as mix_ref

    rng = np.random.default_rng(0)
    for shape in ((9, 4, 64), (9, 5, 51)):
        s = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(
            cuda_device)
        p = np.arange(shape[0])
        p[[0, 3, 5, 8]] = [3, 0, 8, 5]
        want = mix_ref.mix_matching_ref(s, p)
        before = mix_ops.launches
        got = mix_ops.mix_pairs_(s.clone(), mix_ops.pairs_of(p))
        torch.cuda.synchronize()
        assert mix_ops.launches == before + 1
        assert torch.equal(got, want)
    # more pairs than one launch's parameters hold: two launches
    n = 2 * mix_ops.MAX_PAIRS + 41
    s = torch.from_numpy(rng.random((n, 3, 4), dtype=np.float32)).to(
        cuda_device)
    p = np.arange(n)
    order = rng.permutation(n)[:2 * (mix_ops.MAX_PAIRS + 7)]
    p[order[0::2]], p[order[1::2]] = order[1::2], order[0::2]
    before = mix_ops.launches
    by_shape = dict(mix_ops.launches_by_shape)
    got = mix_ops.mix_pairs_(s.clone(), mix_ops.pairs_of(p))
    torch.cuda.synchronize()
    assert mix_ops.launches == before + 2
    for key in ((n, 3, 4, mix_ops.MAX_PAIRS), (n, 3, 4, 7)):
        assert mix_ops.launches_by_shape[key] == by_shape.get(key, 0) + 1
    assert torch.equal(got, mix_ref.mix_matching_ref(s, p))


def test_sparse_kernel_matches_plain_on_card(cuda_device):
    """K4 makes its plain version's draws (m equal) with counts in
    {0, 1, >1}, counts one launch by shape, and gives K2's bits on sorted
    documents without repeats."""
    from repro_torch.core import estep
    from repro_torch.kernels.lda_gibbs import ops as gibbs_ops
    from repro_torch.kernels.lda_sparse import ops as sparse_ops

    rng = np.random.default_rng(1)
    b, l, k, s = 13, 24, 9, 6
    words = torch.from_numpy(rng.integers(0, 8, (b, l)))
    mask = torch.from_numpy(np.arange(l)[None, :]
                            < rng.integers(1, l + 1, (b, 1)))
    uw, counts = estep.unique_view(words, mask)
    u = uw.shape[1]
    bw = torch.from_numpy(rng.random((b, u, k), dtype=np.float32) + 1e-3)
    un = torch.from_numpy(rng.random((s, b, u), dtype=np.float32))
    z0 = torch.from_numpy(rng.integers(0, k, (b, u)))
    args = [x.to(cuda_device) for x in (bw, counts.float(), un, z0)]
    kw = dict(alpha=0.5, n_sweeps=s, burnin=3)
    before = sparse_ops.launches_by_shape.get((b, u, k, s), 0)
    got = sparse_ops.sparse_sweeps(*args, **kw)
    torch.cuda.synchronize()
    assert sparse_ops.launches_by_shape[(b, u, k, s)] == before + 1
    want = estep.gibbs_sweeps_sparse(*args, **kw)
    assert torch.equal(got[1], want[1])       # the same draws
    for g, w in (got[0], want[0]), (got[2], want[2]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    # counts in {0, 1}: the sparse kernel is the dense kernel
    mf = (torch.arange(l)[None, :] < torch.arange(1, b + 1)[:, None]
          ).float().to(cuda_device)
    bw = torch.from_numpy(rng.random((b, l, k), dtype=np.float32)).to(
        cuda_device)
    un = torch.from_numpy(rng.random((s, b, l), dtype=np.float32)).to(
        cuda_device)
    z0 = torch.from_numpy(rng.integers(0, k, (b, l))).to(cuda_device)
    dense = gibbs_ops.gibbs_sweeps(bw, mf, un, z0, **kw)
    sparse = sparse_ops.sparse_sweeps(bw, mf, un, z0, **kw)
    assert torch.equal(sparse[0], dense[0])
    assert torch.equal(sparse[2], dense[2])
    onehot = torch.nn.functional.one_hot(dense[1], k).float()
    assert torch.equal(sparse[1], onehot * mf[..., None])


GIBBS_EDGE_CASES = [(kernel, k, b) for kernel in ("lda_gibbs", "lda_sparse")
                    for k in (1, 31, 32, 33, 100, 128) for b in (1, 7, 133)]


@pytest.mark.parametrize("kernel,k,b", GIBBS_EDGE_CASES,
                         ids=lambda v: str(v))
def test_gibbs_warp_kernels_match_plain_on_card(cuda_device, kernel, k, b):
    """K2 and K4 (one warp per document, ``csrc/gibbs_warp.cuh``) against
    their plain versions where lanes own 0 to 4 topics (K = 1 ... 128) and
    the last block is ragged (B = 1, 7, 133). With B >= 7: a document with
    no active position, one whose only active position is its last, and
    uniforms at 0.0 and at 1 - 2**-24. Draws equal; outputs as the K = 7 /
    9 tests hold them; one launch counted at the shape."""
    from repro_torch.core import estep
    from repro_torch.kernels.lda_gibbs import ops as gibbs_ops
    from repro_torch.kernels.lda_sparse import ops as sparse_ops

    rng = np.random.default_rng(k * 1000 + b)
    n, s, burnin = 12, 5, 2
    bw = rng.random((b, n, k), dtype=np.float32) + 1e-3
    if kernel == "lda_gibbs":
        w = (rng.random((b, n)) < 0.8).astype(np.float32)
    else:
        w = rng.integers(0, 4, (b, n)).astype(np.float32)
    u = rng.random((s, b, n), dtype=np.float32)
    if b >= 7:
        w[1] = 0.0
        w[2] = 0.0
        w[2, -1] = 1.0
        u[:, 3] = 0.0
        u[:, 4] = np.float32(1 - 2.0 ** -24)
    z0 = rng.integers(0, k, (b, n))
    args = [torch.from_numpy(x).to(cuda_device) for x in (bw, w, u, z0)]
    kw = dict(alpha=0.5, n_sweeps=s, burnin=burnin)
    ops = gibbs_ops if kernel == "lda_gibbs" else sparse_ops
    plain = (estep.gibbs_sweeps_dense if kernel == "lda_gibbs"
             else estep.gibbs_sweeps_sparse)
    before = ops.launches_by_shape.get((b, n, k, s), 0)
    got = (gibbs_ops.gibbs_sweeps(*args, **kw) if kernel == "lda_gibbs"
           else sparse_ops.sparse_sweeps(*args, **kw))
    torch.cuda.synchronize()
    assert ops.launches_by_shape[(b, n, k, s)] == before + 1
    want = plain(*args, **kw)
    assert torch.equal(got[1], want[1])       # the same draws (z, or m)
    for g, w_ in (got[0], want[0]), (got[2], want[2]):
        torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kernel", ["lda_gibbs", "lda_sparse"])
def test_gibbs_warp_kernels_refuse_what_does_not_fit(cuda_device, kernel):
    """A document whose rows do not fit one warp's shared memory (40,000
    positions) is refused with a ValueError, and nothing is counted."""
    from repro_torch.kernels.lda_gibbs import ops as gibbs_ops
    from repro_torch.kernels.lda_sparse import ops as sparse_ops

    ops = gibbs_ops if kernel == "lda_gibbs" else sparse_ops
    fn = (gibbs_ops.gibbs_sweeps if kernel == "lda_gibbs"
          else sparse_ops.sparse_sweeps)
    n = 40_000
    before = ops.launches
    with pytest.raises(ValueError, match="shared memory"):
        fn(torch.ones((1, n, 2), device=cuda_device),
           torch.ones((1, n), device=cuda_device),
           torch.rand((2, 1, n), device=cuda_device),
           torch.zeros((1, n), dtype=torch.int64, device=cuda_device),
           alpha=0.5, n_sweeps=2, burnin=1)
    assert ops.launches == before


def test_count_weighted_l2r_matches_plain_on_card(cuda_device):
    """K3 in the count-weighted mode against its plain version, at U = L
    with padding slots (the in-loop evaluator's layout)."""
    from repro_torch.core import estep, evaluation
    from repro_torch.core import threefry as tf3
    from repro_torch.kernels.lda_l2r import ops as l2r_ops

    rng = np.random.default_rng(2)
    b, l, k, p = 9, 20, 6, 4
    words = torch.from_numpy(rng.integers(0, 7, (b, l)))
    mask = torch.from_numpy(np.arange(l)[None, :]
                            < rng.integers(2, l + 1, (b, 1)))
    uw, counts = estep.dense_to_unique(words, mask)
    stats = torch.from_numpy(rng.random((k, 7), dtype=np.float32))
    bw = estep.beta_w_from_stats(stats, uw, 1e-2).to(cuda_device)
    cf = counts.float().to(cuda_device)
    kd = tf3.fold_in_data(tf3.key(3, cuda_device),
                          torch.arange(b, device=cuda_device))
    before = l2r_ops.launches_by_shape.get((b, l, k, p, True), 0)
    got = l2r_ops.l2r_scores(kd, bw, cf, 0.5, n_particles=p,
                             count_weighted=True)
    torch.cuda.synchronize()
    assert l2r_ops.launches_by_shape[(b, l, k, p, True)] == before + 1
    want = evaluation.l2r_position_scores(kd, bw, cf, 0.5, p,
                                          count_weighted=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


# every G = ceil(K / 16) instance of K3, P from one warp of one particle
# to warps of two and three particles, B from 1 to more documents than an
# H100 has SMs (its blocks then take the documents longest first)
L2R_CASES = [(k, p, b) for k in (1, 5, 16, 17, 31, 32, 33, 100, 128)
             for p, b in ((1, 7), (3, 133), (10, 7), (32, 1), (33, 7))]


def _edge_keys(b, p, rng):
    """[B, 2] key words; with B >= 7, documents 3 and 4 take the keys whose
    first draw (position 0, particle 0) is the smallest and the largest
    uniform of 4,096 candidates (within about 2.4e-4 of 0 and of 1)."""
    from repro_torch.core import threefry as tf3

    kd = torch.from_numpy(rng.integers(0, 2 ** 32, (b, 2), dtype=np.int64))
    if b >= 7:
        cand = torch.from_numpy(rng.integers(0, 2 ** 32, (4096, 2),
                                             dtype=np.int64))
        dr = tf3.split2_data(tf3.fold_in_data(cand, 0))[1]
        u0 = tf3.uniform_halves(dr, p)[:, 0]
        kd[3], kd[4] = cand[u0.argmin()], cand[u0.argmax()]
    return kd


@pytest.mark.parametrize("k,p,b", L2R_CASES, ids=lambda v: str(v))
def test_l2r_matches_plain_per_position_on_card(cuda_device, k, p, b):
    """K3 (a warp per particle chain) against its plain version, every
    per-position score [L, B] within rtol 1e-5 / atol 1e-6, in both modes.
    Dense documents: with B >= 7, an empty one, one whose only position is
    its last, one of one position and one of full length; count-weighted
    ones with weight-0 slots inside them; keys whose first draw is near 0
    and near 1. One launch counted at each shape."""
    from repro_torch.core import evaluation
    from repro_torch.kernels.lda_l2r import ops as l2r_ops

    rng = np.random.default_rng(k * 1000 + p * 10 + b)
    n = 24
    bw = rng.random((b, n, k), dtype=np.float32) + 1e-3
    mask = (np.arange(n)[None, :] < rng.integers(1, n + 1, (b, 1))).astype(
        np.float32)
    counts = rng.integers(0, 4, (b, n)).astype(np.float32)
    if b >= 7:
        mask[1] = 0.0
        mask[2] = 0.0
        mask[2, -1] = 1.0
        mask[5] = 0.0
        mask[5, 0] = 1.0
        mask[6] = 1.0
        counts[1] = 0.0
    kd = _edge_keys(b, p, rng).to(cuda_device)
    bw = torch.from_numpy(bw).to(cuda_device)
    for cw, w in ((False, mask), (True, counts)):
        w = torch.from_numpy(w).to(cuda_device)
        shape = (b, n, k, p, cw)
        before = l2r_ops.launches_by_shape.get(shape, 0)
        got = l2r_ops.l2r_scores(kd, bw, w, 0.5, n_particles=p,
                                 count_weighted=cw)
        torch.cuda.synchronize()
        assert l2r_ops.launches_by_shape[shape] == before + 1
        want = evaluation.l2r_position_scores(kd, bw, w, 0.5, p, cw)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_l2r_matches_plain_per_position_at_length_256_on_card(cuda_device):
    """K3 at L = 256 (the Zipf corpus's cap) and K=100, P=10: a dense
    document of full length and one of 200 positions, and the
    count-weighted view of such documents at U = L (distinct words first,
    then padding slots), per position within rtol 1e-5 / atol 1e-6."""
    from repro_torch.core import estep, evaluation
    from repro_torch.kernels.lda_l2r import ops as l2r_ops

    rng = np.random.default_rng(256)
    b, n, k, v = 2, 256, 100, 300
    words = torch.from_numpy(rng.integers(0, v, (b, n)))
    mask = torch.arange(n)[None, :] < torch.tensor([[n], [200]])
    stats = torch.from_numpy(rng.random((k, v), dtype=np.float32))
    kd = _edge_keys(b, 10, rng).to(cuda_device)
    uw, counts = estep.dense_to_unique(words, mask)
    for cw, wd, w in ((False, words, mask), (True, uw, counts)):
        bw = estep.beta_w_from_stats(stats, wd, 1e-2).to(cuda_device)
        w = w.float().to(cuda_device)
        got = l2r_ops.l2r_scores(kd, bw, w, 0.5, n_particles=10,
                                 count_weighted=cw)
        want = evaluation.l2r_position_scores(kd, bw, w, 0.5, 10, cw)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_l2r_refuses_what_it_does_not_take_on_card(cuda_device):
    """K3 raises a ValueError, and counts nothing, for K=129 topics, for 0
    and 1,025 particles, and for documents whose list of active positions
    and topic rows do not fit a block's shared memory (40,000 positions)."""
    from repro_torch.kernels.lda_l2r import ops as l2r_ops

    for k, p, n, what in ((129, 10, 8, "topics"), (5, 0, 8, "n_particles"),
                          (5, 1025, 8, "n_particles"),
                          (2, 1, 40_000, "shared memory")):
        kd = torch.zeros((1, 2), dtype=torch.int64, device=cuda_device)
        before = l2r_ops.launches
        with pytest.raises(ValueError, match=what):
            l2r_ops.l2r_scores(kd, torch.rand((1, n, k), device=cuda_device),
                               torch.ones((1, n), device=cuda_device), 0.5,
                               n_particles=p)
        assert l2r_ops.launches == before


def test_attention_on_a_non_cpu_device_is_never_served_by_plain_code():
    """flash_attention, like the other wrappers, refuses a tensor that is
    neither on the CPU nor on a CUDA device instead of falling back."""
    from repro_torch.kernels.flash_attention import ops as flash_ops

    q = torch.empty(1, 4, 2, 16, device="meta")
    k = torch.empty(1, 4, 1, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_ops.flash_attention(q, k, k)


# the reference kernel test's seven cases (tests/test_kernels.py), then
# gemma2-2b's head: D=256, GQA 8/4, window and softcap, in bf16; then the
# variants' edges: bf16 prefill at D 64 / 128 / 256 with Sq and Sk off
# the 64 and 128 tiles, windows under 64 and across tile edges, no
# softcap, groups 1, 2 and 8, q_offset > 0 with Sq > 1, decode at offsets
# 0 and Sk - 1, and a long cache (Sk=4096, split over blocks) with and
# without a window. Each case names the variant it must count under.
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, {}, torch.float32, 2e-5, "fma"),
    (1, 100, 100, 2, 2, 32, {}, torch.float32, 2e-5, "fma"),
    (1, 64, 64, 2, 2, 16, {}, torch.float32, 2e-5, "decode"),
    (1, 192, 192, 4, 1, 64, {"window": 64}, torch.float32, 2e-5, "fma"),
    (1, 128, 128, 2, 2, 64, {"softcap": 30.0}, torch.float32, 2e-5, "fma"),
    (2, 1, 192, 4, 2, 64, {"q_offset": 191}, torch.float32, 2e-5,
     "decode"),
    (1, 128, 128, 4, 4, 32, {"window": 32, "softcap": 50.0}, torch.float32,
     2e-5, "fma"),
    (2, 300, 300, 8, 4, 256, {"window": 128, "softcap": 50.0},
     torch.bfloat16, 3e-2, "wgmma"),
    (4, 1, 192, 8, 4, 256, {"window": 64, "softcap": 50.0,
                            "q_offset": 150}, torch.bfloat16, 3e-2,
     "decode"),
    (1, 200, 200, 4, 4, 64, {}, torch.bfloat16, 3e-2, "wgmma"),
    (2, 333, 333, 2, 1, 128, {"softcap": 30.0}, torch.bfloat16, 3e-2,
     "wgmma"),
    (1, 190, 190, 8, 1, 128, {}, torch.bfloat16, 3e-2, "wgmma"),
    (1, 257, 257, 4, 2, 128, {"window": 40}, torch.bfloat16, 3e-2, "wgmma"),
    (1, 400, 400, 8, 4, 256, {"window": 100, "softcap": 50.0},
     torch.bfloat16, 3e-2, "wgmma"),
    (1, 77, 300, 8, 4, 256, {"q_offset": 223, "softcap": 50.0},
     torch.bfloat16, 3e-2, "wgmma"),
    (1, 100, 100, 4, 2, 32, {}, torch.bfloat16, 3e-2, "fma"),
    (2, 1, 150, 8, 1, 64, {"q_offset": 0}, torch.bfloat16, 3e-2, "decode"),
    (3, 1, 150, 4, 2, 256, {"q_offset": 149, "softcap": 50.0},
     torch.bfloat16, 3e-2, "decode"),
    (1, 16, 300, 4, 2, 64, {"q_offset": 284, "window": 50},
     torch.bfloat16, 3e-2, "decode"),
    (1, 1, 100, 2, 1, 16, {"q_offset": 50}, torch.float32, 2e-5, "decode"),
    (2, 1, 4096, 8, 4, 256, {"q_offset": 4095, "softcap": 50.0},
     torch.bfloat16, 3e-2, "decode"),
    (2, 1, 4096, 8, 4, 256, {"q_offset": 4000, "window": 1500,
                             "softcap": 50.0}, torch.bfloat16, 3e-2,
     "decode"),
    (1, 1, 4096, 4, 2, 128, {"q_offset": 3000}, torch.float32, 2e-5,
     "decode"),
    (1, 32, 300, 8, 4, 256, {"q_offset": 268, "window": 16,
                             "softcap": 50.0}, torch.bfloat16, 3e-2,
     "decode"),
    (1, 8, 1200, 8, 1, 128, {"q_offset": 1192}, torch.float32, 2e-5,
     "decode"),
]
# each output row's error (RMS over D) within this share of the row's RMS
FLASH_ROW_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[f"flash{i}" for i in range(len(FLASH_CASES))])
def test_flash_attention_matches_plain_on_card(cuda_device, case):
    """K5 against its plain version (and each output row against its own
    size), one launch counted under its shape and under the variant the
    case names."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    b, sq, sk, h, hkv, d, kw, dtype, atol, var = case
    assert flash_ops.variant(dtype, sq, d, h // hkv) == var
    rng = np.random.default_rng(sq + sk + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(cuda_device, dtype)
               for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d)))
    key = flash_ops.shape_key(q, k, kw.get("window"), kw.get("softcap"))
    before = flash_ops.launches_by_shape.get(key, 0)
    before_var = flash_ops.launches_by_variant.get(var, 0)
    got = flash_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_ops.launches_by_shape[key] == before + 1
    assert flash_ops.launches_by_variant[var] == before_var + 1
    want = attention_ref(*(x.transpose(1, 2).reshape(-1, x.shape[1], d)
                           for x in (q, k, v)), **kw)
    want = want.reshape(b, h, sq, d).transpose(1, 2)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    err = (got.double() - want.double()).pow(2).mean(-1).sqrt()
    size = want.double().pow(2).mean(-1).sqrt().clamp_min(1e-6)
    assert float((err / size).max()) <= FLASH_ROW_TOL[dtype]


def test_flash_attention_refuses_bad_launches_on_card(cuda_device):
    """A CPU tensor beside CUDA ones, or a non-contiguous CUDA tensor,
    raises; nothing is launched."""
    from repro_torch.kernels.flash_attention import ops as flash_ops

    q = torch.randn(1, 8, 2, 32, device=cuda_device)
    k = torch.randn(1, 8, 2, 32, device=cuda_device)
    before = flash_ops.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_ops.flash_attention(q, k.cpu(), k)
    with pytest.raises(ValueError, match="contiguous"):
        flash_ops.flash_attention(q.transpose(1, 2).contiguous()
                                  .transpose(1, 2), k, k)
    with pytest.raises(ValueError, match="head_dim"):
        flash_ops.flash_attention(q[..., :24].contiguous(),
                                  k[..., :24].contiguous(),
                                  k[..., :24].contiguous())
    assert flash_ops.launches == before


def test_generator_from_key_is_a_cpu_generator():
    """The corpus generator is a CPU one, seeded by the key's words alone
    (a CUDA key gets one too: test_corpus_on_cuda_equals_cpu_corpus)."""
    from repro_torch.core import lda
    from repro_torch.core import threefry as tf3

    gen = lda.generator_from_key(tf3.key(5))
    assert gen.device == torch.device("cpu")
    again = lda.generator_from_key(tf3.key(5))
    assert torch.equal(torch.rand(4, generator=gen),
                       torch.rand(4, generator=again))


def test_corpus_on_cuda_equals_cpu_corpus(cuda_device):
    """make_corpus on a CUDA key gives the CPU corpus bit for bit at the
    reduced §4 scale: words, mask, beta* and the lengths."""
    from repro_torch.core import lda
    from repro_torch.core import threefry as tf3
    from repro_torch.data.lda_synthetic import make_corpus
    from repro_torch.launch.deleda_experiment import REDUCED

    gen = lda.generator_from_key(tf3.key(0, cuda_device))
    assert gen.device == torch.device("cpu")
    on_cpu = make_corpus(REDUCED.lda, tf3.key(0), REDUCED.corpus)
    on_gpu = make_corpus(REDUCED.lda, tf3.key(0, cuda_device),
                         REDUCED.corpus)
    for name in ("words", "mask", "test_words", "test_mask", "beta_star"):
        got = getattr(on_gpu, name)
        assert got.device.type == "cuda", name
        assert torch.equal(got.cpu(), getattr(on_cpu, name)), name
    assert torch.equal(on_gpu.mask.sum(-1).cpu(), on_cpu.mask.sum(-1))
    assert on_gpu.length_truncation_frac == on_cpu.length_truncation_frac


def test_serve_main_draws_the_same_model_on_cuda_and_cpu(cuda_device):
    """serve.main's weights and prompt are the seed's on both devices."""
    from repro_torch.launch import serve

    argv = ["--batch", "2", "--prompt-len", "4", "--gen", "2", "--seed", "3"]
    on_cpu = serve.main(argv + ["--device", "cpu"])
    on_gpu = serve.main(argv + ["--device", "cuda"])
    assert torch.equal(on_gpu["prompt"].cpu(), on_cpu["prompt"])

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}/{i}")
        else:
            yield path, tree

    want = dict(leaves(on_cpu["params"]))
    got = dict(leaves(on_gpu["params"]))
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        assert leaf.device.type == "cuda", path
        assert torch.equal(leaf.cpu(), want[path]), path


def _lifecycle_inputs(dev, layout="dense"):
    """A small DELEDA run's corpus, schedule and config on ``dev``."""
    from repro_torch.core import deleda, evaluation
    from repro_torch.core import threefry as tf3
    from repro_torch.core.graph import watts_strogatz_graph
    from repro_torch.core.lda import LDAConfig
    from repro_torch.data import lda_synthetic as synth

    lcfg = LDAConfig(n_topics=3, vocab_size=24, alpha=0.5, doc_len_max=10,
                     n_gibbs=4, n_gibbs_burnin=2)
    stream = synth.make_corpus_stream(
        lcfg, tf3.key(0, dev), synth.CorpusSpec(
            n_nodes=10, docs_per_node=4, n_test=6, refresh_every=10))
    sched, degs = deleda.make_run_inputs(
        watts_strogatz_graph(10, 4, 0.3, seed=0), 20, seed=1,
        kind="matching")
    spec = evaluation.EvalSpec(words=stream.base.test_words,
                               mask=stream.base.test_mask,
                               key=tf3.key(99, dev), n_particles=2,
                               probe_nodes=2, layout=layout)
    cfg = deleda.DeledaConfig(lda=lcfg, batch_size=2, eval_every=10,
                              corpus_layout=layout, decay=(5.0, 0.8))
    return cfg, stream, sched, degs, spec


@pytest.mark.parametrize("layout", ["dense", "unique"])
def test_kill_restore_bitwise_on_card(cuda_device, tmp_path, layout):
    """A streamed run with forgetting, killed at step 10 and resumed on the
    card, equals the uninterrupted run bit for bit."""
    import shutil

    from repro_torch.core import deleda
    from repro_torch.core import threefry as tf3

    cfg, stream, sched, degs, spec = _lifecycle_inputs(cuda_device, layout)
    args = (cfg, tf3.key(4, cuda_device), None, None, sched, degs, 20)
    kw = dict(record_every=10, eval_spec=spec, stream=stream)
    full = deleda.run_deleda(*args, **kw)
    deleda.run_deleda(*args, save_every=10, checkpoint_dir=str(tmp_path),
                      **kw)
    shutil.rmtree(tmp_path / "step_00000020")
    resumed = deleda.run_deleda(*args, restore_from=str(tmp_path), **kw)
    assert resumed.stats.device.type == "cuda"
    for name in ("stats", "steps", "eval_lp"):
        assert torch.equal(getattr(full, name)[-1:],
                           getattr(resumed, name)[-1:]), name
    assert torch.equal(full.consensus[-1], resumed.consensus[-1])
    assert resumed.state.cursor == 1 and resumed.state.t == 20


def test_card_checkpoint_restores_on_cpu(cuda_device, tmp_path):
    """A TrainState saved from CUDA tensors restores on the CPU with equal
    arrays; a streamed segment drawn for the card is the CPU's."""
    from repro_torch.convert import train_state_to_numpy
    from repro_torch.core import deleda
    from repro_torch.core import threefry as tf3

    cfg, stream, sched, degs, _spec = _lifecycle_inputs(cuda_device)
    cfg = deleda.DeledaConfig(lda=cfg.lda, batch_size=2)
    tr = deleda.run_deleda(cfg, tf3.key(4, cuda_device), None, None, sched,
                           degs, 20, record_every=10, stream=stream)
    deleda.save_state(str(tmp_path), tr.state, config=cfg)
    got = deleda.restore_state(str(tmp_path),
                               deleda.state_like(cfg, 10, "cpu"), config=cfg)
    assert got.stats.device.type == "cpu"
    want = train_state_to_numpy(tr.state)
    for name, arr in train_state_to_numpy(got).items():
        np.testing.assert_array_equal(arr, want[name])
    _, cpu_stream, *_ = _lifecycle_inputs(torch.device("cpu"))
    for a, b in zip(stream.segment(1), cpu_stream.segment(1)):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


def _scenario_masks_and_counts(kind, mode, seed=3):
    """A compiled churn-and-drop scenario on 13 nodes, its live mask and
    the updating nodes of each round as run_deleda plans them."""
    from repro_torch.core import deleda, lda, scenario
    from repro_torch.core.graph import watts_strogatz_graph

    seq = scenario.GraphSequence.rewiring(
        lambda s: watts_strogatz_graph(13, 4, 0.3, seed=s), 2, 10)
    compiled = scenario.Scenario(
        topology=seq, kind=kind, drop_prob=0.2, churn=0.3,
        churn_mean_down=3.0, joins=((12, 10),), leaves=((2, 15),)).compile(
        np.random.default_rng(seed))
    cfg = deleda.DeledaConfig(lda=lda.LDAConfig(n_topics=5, vocab_size=50,
                                                doc_len_max=16),
                              mode=mode, batch_size=3)
    live = compiled.alive & compiled.member
    _ev, counts, _rows = deleda._plan_segment(cfg, compiled.schedule, live,
                                              "cpu")
    return compiled, live, [13 if c < 0 else c for c in counts]


def test_gibbs_at_scenario_batch_sizes_on_card(cuda_device):
    """K2 at the fused batch sizes a compiled scenario gives it (sync
    updates every live node, so B = 3 x m is odd where m is): the
    smallest B and an odd one, against the plain version."""
    from repro_torch.core import estep
    from repro_torch.kernels.lda_gibbs import ops as gibbs_ops

    _c, _live, counts = _scenario_masks_and_counts("matching", "sync")
    ms = sorted(set(counts) - {0})
    odd = [m for m in ms if (3 * m) % 2]
    assert odd, counts
    rng = np.random.default_rng(1)
    for b in sorted({3 * ms[0], 3 * odd[0]}):
        bw = torch.from_numpy(rng.random((b, 16, 5), dtype=np.float32)
                              + np.float32(1e-3)).to(cuda_device)
        lengths = rng.integers(1, 17, size=b)
        mask = torch.from_numpy((np.arange(16)[None, :] < lengths[:, None])
                                .astype(np.float32)).to(cuda_device)
        u = torch.from_numpy(rng.random((10, b, 16),
                                        dtype=np.float32)).to(cuda_device)
        z0 = torch.from_numpy(rng.integers(0, 5, (b, 16))).to(cuda_device)
        before = gibbs_ops.launches
        got = gibbs_ops.gibbs_sweeps(bw, mask, u, z0, alpha=0.5,
                                     n_sweeps=10, burnin=5)
        assert gibbs_ops.launches == before + 1
        want = estep.gibbs_sweeps_dense(bw, mask, u, z0, alpha=0.5,
                                        n_sweeps=10, burnin=5)
        assert torch.equal(got[1], want[1]), b
        for g, w in (got[0], want[0]), (got[2], want[2]):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["edge", "matching"])
def test_scenario_frozen_rows_on_card(cuda_device, kind):
    """The full-width scenario phase's properties at a small width, every
    round recorded: a node down or not a member in a round keeps its row
    bit for bit; each node's step counter is its live updates; K1 and K2
    launch once per round with a live pair."""
    from repro_torch.core import deleda, lda
    from repro_torch.core import threefry as tf3
    from repro_torch.data.lda_synthetic import CorpusSpec, make_corpus
    from repro_torch.kernels.gossip_mix import ops as mix_ops
    from repro_torch.kernels.lda_gibbs import ops as gibbs_ops

    compiled, live, counts = _scenario_masks_and_counts(kind, "async")
    lcfg = lda.LDAConfig(n_topics=5, vocab_size=50, doc_len_max=16,
                         n_gibbs=4, n_gibbs_burnin=2)
    corpus = make_corpus(lcfg, tf3.key(0, cuda_device),
                         CorpusSpec(n_nodes=13, docs_per_node=4, n_test=4))
    cfg = deleda.DeledaConfig(lda=lcfg, mode="async", batch_size=3)
    sched, degs, alive, member = compiled.run_inputs()
    state = deleda.init_state(cfg, tf3.key(2, cuda_device), 13)
    m0, g0 = mix_ops.launches, gibbs_ops.launches
    tr = deleda.run_deleda(cfg, state.key, corpus.words, corpus.mask, sched,
                           degs, 20, record_every=1, init=state,
                           alive=alive, member=member)
    n_live = sum(c > 0 for c in counts)
    assert mix_ops.launches - m0 == n_live
    assert gibbs_ops.launches - g0 == n_live
    prev = state.stats
    for t in range(20):
        for i in np.nonzero(~live[t])[0]:
            assert torch.equal(tr.history[t][i], prev[i]), (t, i)
        prev = tr.history[t]
    data = sched.data if kind == "matching" else sched.partners()
    ids = np.arange(13)
    ok = live & np.take_along_axis(live, data, 1) & (data != ids)
    assert tr.steps.cpu().tolist() == ok.sum(0).tolist()
