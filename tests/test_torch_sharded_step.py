"""``launch.steps.build``'s sharded steps against the unsharded ones, on a
real world of 4 gloo ranks as a 2 x 2 ``("data", "model")`` DeviceMesh.

The ranks are spawned by ``gossip_sim.launch`` (gloo, start method
"spawn") once for the module and run every case; they import this file,
so it imports jax nowhere. Every rank holds the same seeded parameters
and batch (float32 smoke variants, B=4, S=16); ``LoweredStep.place``
distributes them by the rules, and the results are gathered whole.

- Each of the ten archs under ``LOGICAL_RULES`` (tensor parallel over
  "model", batch over "data"; the MoE experts over "model", the Mamba2
  and xLSTM blocks data parallel with their weights gathered), kimi-k2
  under ``FSDP_RULES`` and xlstm-125m under ``DP_ONLY_RULES``:
  - two train steps against ``make_train_step`` on a copy of the same
    state: the losses within rel ``LOSS_RTOL``, ``grad_norm`` within rel
    1e-5, and the parameters within the optimizers' bound for one run
    against another whose float32 sums differ in the last bits (the
    argument of ``tests/test_torch_train.py`` and
    ``tests/test_torch_train_families.py``: both optimizers normalise
    the gradient, so no element moves by more than about the lr a step
    in either run, every element within twice the summed lr; where each
    step's gradient is at least ``GRAD_REL`` of its leaf's largest the
    sign is fixed, and there an element is within a tenth of the summed
    lr, at most 1e-4 of a leaf's elements beyond 1e-6; a leaf whose
    gradient is rounding noise, below 1e-6 of the largest, fixes none);
  - a prefill step's last logits and three decode steps' logits (the
    caches placed by the rules and written in place) within rel 1e-5
    of the unsharded steps'.
- ``attn_chunk_q``: arctic's query-sequence constraint at smoke width
  (``attn_chunk_q=8``, S=16): the attention kernel runs on each rank's 8
  query rows, and the prefill logits and the train loss equal the
  unsharded ones within the same bounds.
- ``TokenPipeline.sharded_batch``: the same tokens in two fresh worlds
  (two spawns), each rank drawing its own shard, and ``targets ==
  roll(tokens, -1)``.
- A mutation that places the heads over "data" in the attention's
  ``local_map`` fails the prefill check.
"""

import copy

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

LOSS_RTOL = 1e-5
LOGIT_RTOL = 1e-5
GRAD_REL = 1e-4
B, S = 4, 16
ARCHS = ["kimi_k2_1t_a32b", "arctic_480b", "whisper_small", "gemma2_2b",
         "gemma2_9b", "granite_3_8b", "pixtral_12b", "zamba2_2p7b",
         "qwen2_72b", "xlstm_125m"]
CASES = ([(a, "logical") for a in ARCHS]
         + [("kimi_k2_1t_a32b", "fsdp"), ("xlstm_125m", "dp_only")])


def _rules(name):
    from repro_torch.sharding import DP_ONLY_RULES, FSDP_RULES, LOGICAL_RULES
    return {"logical": LOGICAL_RULES, "fsdp": FSDP_RULES,
            "dp_only": DP_ONLY_RULES}[name]


def _full(t):
    from repro_torch.sharding.local import is_dtensor
    return t.full_tensor() if is_dtensor(t) else t


def _inputs(cfg, b=B, s=S, seed=0):
    from repro_torch.models import encdec as ed
    from repro_torch.models import frontends as fe
    from repro_torch.models import transformer as tf
    g = torch.Generator().manual_seed(seed)
    init = ed.init_encdec if cfg.family == "encdec" else tf.init_decoder_lm
    params = init(cfg, g)
    s_text = s - (cfg.n_image_tokens if cfg.family == "vlm" else 0)
    toks = torch.randint(0, cfg.vocab_size, (b, s_text + 1), generator=g,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "targets": toks[:, 1:].contiguous(),
             "mask": torch.ones(b, s_text, dtype=torch.bool)}
    if cfg.family == "vlm":
        batch["image_embeds"] = fe.image_patches_stub(cfg, g, b)
    if cfg.family == "encdec":
        batch["frames"] = fe.audio_frames_stub(cfg, g, b)
    return params, batch


def _param_report(got, want, grads, lr_sum):
    """Per leaf: the largest difference, and where every step's gradient
    fixes the sign its largest difference and the share beyond 1e-6."""
    from torch.utils import _pytree as pytree
    out = []
    top = max(float(g.abs().max()) for step in grads
              for g in pytree.tree_leaves(step))
    for i, (g, w) in enumerate(zip(pytree.tree_leaves(got),
                                   pytree.tree_leaves(want))):
        d = (_full(g).double() - w.double()).abs()
        fixed = torch.ones_like(d, dtype=torch.bool)
        for step in grads:
            gr = pytree.tree_leaves(step)[i]
            # a leaf whose gradient is rounding noise (a key bias without
            # RoPE: the softmax cancels it) fixes no sign
            fixed &= (gr.abs() >= GRAD_REL * gr.abs().max()) \
                & (gr.abs().max() >= 1e-6 * top)
        df = d[fixed]
        out.append((float(d.max()), float(df.max()) if df.numel() else 0.0,
                    float((df > 1e-6).double().mean()) if df.numel()
                    else 0.0))
    return {"leaves": out, "lr_sum": lr_sum}


def _case(cfg, rules, mesh):
    from repro_torch.configs import InputShape
    from repro_torch.launch import steps
    from repro_torch.models import encdec as ed
    from repro_torch.models import transformer as tf
    from repro_torch.optim import make_lr_schedule
    params, batch = _inputs(cfg)
    out = {}
    # train: two steps against the unsharded step on a copy
    st = steps.build(cfg, InputShape("t", S, B, "train"), mesh, rules=rules)
    train_step, opt = steps.make_train_step(cfg)
    plain = steps.TrainState(copy.deepcopy(params), opt.init(params), 0)
    state, pb = st.place(steps.TrainState(copy.deepcopy(params),
                                          opt.init(params), 0), batch)
    metrics, grads = [], []
    for _ in range(2):
        grads.append(steps.value_and_grad(
            lambda p: steps.loss_fn(cfg, p, batch), plain.params)[1])
        plain, m0 = train_step(plain, batch)
        state, m1 = st(state, pb)
        metrics.append(tuple(float(m[k]) for m in (m0, m1)
                             for k in ("loss", "grad_norm")))
    lr = make_lr_schedule("cosine", 3e-4)
    out["train"] = metrics
    out["params"] = _param_report(state.params, plain.params, grads,
                                  sum(float(lr(t)) for t in range(2)))
    # prefill
    ps = steps.build(cfg, InputShape("p", S, B, "prefill"), mesh,
                     rules=rules)
    pbatch = {k: v for k, v in batch.items()
              if k in ("tokens", "image_embeds", "frames")}
    want = steps.make_prefill_step(cfg)(params, pbatch)
    got = _full(ps(*ps.place(params, pbatch)))
    out["prefill"] = float((got - want).abs().max() / want.abs().max())
    # decode: three steps, the caches placed by the rules
    if cfg.decode_shapes:
        ds = steps.build(cfg, InputShape("d", S, B, "decode"), mesh,
                         rules=rules)
        dec = steps.make_decode_step(cfg)
        caches = (ed.init_encdec_caches(cfg, params, batch["frames"], B, S)
                  if cfg.family == "encdec"
                  else tf.init_caches(cfg, B, S, "cpu"))
        c0 = copy.deepcopy(caches)
        pp, db = ds.place(params, {"caches": caches})
        c1 = db["caches"]
        errs = []
        for i in range(3):
            tok = batch["tokens"][:, i:i + 1].contiguous()
            l0, c0 = dec(params, {"tokens": tok, "index": i, "caches": c0})
            tb = ds.place(None, {"tokens": tok})[1]["tokens"]
            l1, c1 = ds(pp, {"tokens": tb, "index": i, "caches": c1})
            errs.append(float((_full(l1) - l0).abs().max()
                              / l0.abs().max()))
        out["decode"] = errs
    return out


def _chunk_case(mesh):
    """arctic with attn_chunk_q=8 at S=16: the query rows a launch."""
    import dataclasses

    from repro_torch.configs import InputShape, get_config, smoke_variant
    from repro_torch.launch import steps
    from repro_torch.models import attention as attn_mod
    cfg = dataclasses.replace(smoke_variant(get_config("arctic_480b")),
                              attn_chunk_q=8)
    params, batch = _inputs(cfg)
    rules = _rules("logical")
    rows = []
    inner = attn_mod.flash_ops.flash_attention

    def recording(q, k, v, **kw):
        rows.append(int(q.shape[1]))
        return inner(q, k, v, **kw)

    ps = steps.build(cfg, InputShape("p", S, B, "prefill"), mesh,
                     rules=rules)
    pbatch = {"tokens": batch["tokens"]}
    want = steps.make_prefill_step(cfg)(params, pbatch)
    placed = ps.place(params, pbatch)
    attn_mod.flash_ops.flash_attention = recording
    try:
        got = _full(ps(*placed))
    finally:
        attn_mod.flash_ops.flash_attention = inner
    st = steps.build(cfg, InputShape("t", S, B, "train"), mesh, rules=rules)
    train_step, opt = steps.make_train_step(cfg)
    plain = steps.TrainState(copy.deepcopy(params), opt.init(params), 0)
    state, pb = st.place(steps.TrainState(copy.deepcopy(params),
                                          opt.init(params), 0), batch)
    _, m0 = train_step(plain, batch)
    _, m1 = st(state, pb)
    return {"rows": rows,
            "prefill": float((got - want).abs().max() / want.abs().max()),
            "loss": (float(m0["loss"]), float(m1["loss"]))}


def _mutation_case(mesh):
    """The heads over "data" in the attention's local_map."""
    import torch.distributed.tensor.experimental as exp
    from torch.distributed.tensor import Shard

    from repro_torch.configs import InputShape, get_config, smoke_variant
    from repro_torch.launch import steps
    cfg = smoke_variant(get_config("gemma2_2b"))
    params, batch = _inputs(cfg)
    ps = steps.build(cfg, InputShape("p", S, B, "prefill"), mesh,
                     rules=_rules("logical"))
    pbatch = {"tokens": batch["tokens"]}
    want = steps.make_prefill_step(cfg)(params, pbatch)
    placed = ps.place(params, pbatch)
    real = exp.local_map

    def heads_over_data(pls):
        return tuple(Shard(2) if i == 0 else p for i, p in enumerate(pls))

    def mutated(fn, out_placements, in_placements, in_grad_placements,
                device_mesh, redistribute_inputs):
        # the kernel's output, a batch shard, declared a heads shard: the
        # same shapes on every rank, so every rank goes on alike
        return real(fn, tuple(heads_over_data(p) for p in out_placements),
                    in_placements, in_grad_placements, device_mesh,
                    redistribute_inputs=redistribute_inputs)

    exp.local_map = mutated
    try:
        got = _full(ps(*placed))
        return float((got - want).abs().max() / want.abs().max())
    except Exception as e:          # a refused placement fails it too
        return repr(e)
    finally:
        exp.local_map = real


def _rank_jobs():
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_config, smoke_variant
    torch.set_num_threads(1)
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    out = {"cases": {}}
    for arch, rules in CASES:
        out["cases"][f"{arch}/{rules}"] = _case(
            smoke_variant(get_config(arch)), _rules(rules), mesh)
    out["chunk"] = _chunk_case(mesh)
    out["mutation"] = _mutation_case(mesh)
    return out


def _rank_batch():
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.data.lm_pipeline import TokenPipeline
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    pipe = TokenPipeline(vocab_size=512, seq_len=S, batch_size=B, seed=3)
    b = pipe.sharded_batch(mesh, (Shard(0), Replicate()))
    return {k: _full(getattr(b, k)) for k in ("tokens", "targets", "mask")} \
        | {"local": tuple(b.tokens.to_local().shape)}


@pytest.fixture(scope="module")
def ranks():
    from repro_torch.launch import gossip_sim
    return gossip_sim.launch(_rank_jobs, 4, "gloo", timeout_s=900)


@pytest.fixture(scope="module")
def batches():
    from repro_torch.launch import gossip_sim
    return [gossip_sim.launch(_rank_batch, 4, "gloo", timeout_s=300)
            for _ in range(2)]


@pytest.mark.parametrize("case", [f"{a}/{r}" for a, r in CASES])
def test_sharded_train_step_matches_unsharded(ranks, case):
    res = ranks["cases"][case]
    for loss0, gn0, loss1, gn1 in res["train"]:
        np.testing.assert_allclose(loss1, loss0, rtol=LOSS_RTOL)
        np.testing.assert_allclose(gn1, gn0, rtol=1e-5)
    lr_sum = res["params"]["lr_sum"]
    for i, (d_all, d_fixed, over) in enumerate(res["params"]["leaves"]):
        assert d_all <= 2 * lr_sum, (case, i, d_all)
        assert d_fixed < 0.1 * lr_sum, (case, i, d_fixed)
        assert over <= 1e-4, (case, i, over)


@pytest.mark.parametrize("case", [f"{a}/{r}" for a, r in CASES])
def test_sharded_prefill_and_decode_match_unsharded(ranks, case):
    res = ranks["cases"][case]
    assert res["prefill"] <= LOGIT_RTOL, res["prefill"]
    if "decode" in res:
        assert len(res["decode"]) == 3
        assert max(res["decode"]) <= LOGIT_RTOL, res["decode"]


def test_query_sequence_constraint(ranks):
    res = ranks["chunk"]
    # two layers' launches, each on the rank's 8 of the 16 query rows
    assert res["rows"] and set(res["rows"]) == {S // 2}, res["rows"]
    assert res["prefill"] <= LOGIT_RTOL, res["prefill"]
    np.testing.assert_allclose(res["loss"][1], res["loss"][0],
                               rtol=LOSS_RTOL)


def test_heads_over_data_mutation_fails(ranks):
    res = ranks["mutation"]
    assert isinstance(res, str) or res > 100 * LOGIT_RTOL, res


def test_sharded_batch_is_stable_across_processes(batches):
    a, b = batches
    assert a["local"] == (B // 2, S)
    for k in ("tokens", "targets", "mask"):
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(a["targets"], torch.roll(a["tokens"], -1, dims=1))
    assert a["mask"].all()
    # the two data shards drew different tokens
    assert not torch.equal(a["tokens"][:B // 2], a["tokens"][B // 2:])
