"""The port's ``launch.train`` for every decoder family against the JAX
package's, on the CPU.

- The default arch is the reference's, xlstm-125m.
- ``main --device cpu`` trains kimi-k2 (moe: a dense first layer, the
  aux loss, Adafactor), zamba2 (hybrid), xlstm (ssm, the default, no
  ``--arch``) and pixtral (vlm, on its text as the reference's) 2 steps
  from ``--init-from`` a checkpoint of the reference's initial params,
  with losses within ``LOSS_RTOL`` of the reference's
  ``train_standard``; each run's ``--ckpt`` is restored by the
  reference's ``restore_checkpoint`` bit for bit, and the reference's by
  the port's ``load_params``.
- ``--arch whisper_small`` is refused, as the reference refuses it, with
  the route that trains it (``steps.make_train_step``).
- ``train_decentralized`` for xlstm's smoke variant in 2 gloo ranks
  (H = 2 local AdamW steps, 2 gossip-ring[1] syncs) against a
  composition of the reference's functions in this process, as
  ``tests/test_torch_decentralized.py`` does for gemma2-2b: losses
  within ``LOSS_RTOL``, the parameters within its bound where the
  gradient is above rounding noise. The ranks
  import this file, so it imports JAX only inside functions.
"""

import argparse
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
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.launch import gossip_sim, train  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from test_torch_mesh import LAUNCH_TIMEOUT_S  # noqa: E402

LOSS_RTOL = 1e-5               # tests/test_torch_train.py
GRAD_REL = 1e-4                # of a leaf's max |g|, the same file
STEPS, BATCH, SEQ, LR = 2, 2, 16, 1e-2
N, H, DSTEPS, DLR, SEED = 2, 2, 2, 1e-3, 0
FAMILIES = ["kimi_k2_1t_a32b", "zamba2_2p7b", "xlstm_125m", "pixtral_12b"]


def _ref():
    import jax
    import jax.numpy as jnp

    from repro.checkpoint import restore_checkpoint, save_checkpoint
    from repro.configs import get_config as r_get_config
    from repro.configs import smoke_variant as r_smoke
    from repro.core import decentralized as r_dec
    from repro.data.lm_pipeline import TokenPipeline
    from repro.launch import train as r_train
    from repro.launch.mesh import make_host_mesh as r_host_mesh
    from repro.models import transformer as r_tf
    from repro.optim import make_lr_schedule, make_optimizer
    import torch_parity
    return dict(jax=jax, jnp=jnp, save=save_checkpoint,
                restore=restore_checkpoint, dec=r_dec,
                cfg=lambda a: r_smoke(r_get_config(a)), tf=r_tf,
                train=r_train, mesh=r_host_mesh, pipe=TokenPipeline,
                sched=make_lr_schedule, make_opt=make_optimizer,
                parity=torch_parity)


def _assert_tree_equal(got: dict, want, jax):
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_array_equal(
            np.asarray(g), np.asarray(w), err_msg=jax.tree_util.keystr(path))


def test_default_arch_is_the_references():
    assert train.parse_args([]).arch == "xlstm_125m"
    assert "xlstm-125m" in train.__doc__


@pytest.fixture(scope="module", params=FAMILIES)
def family_runs(request, tmp_path_factory):
    """The reference's train_standard and the port's main (no --arch for
    the default) from the reference's initial params, both with
    --ckpt."""
    arch = request.param
    r = _ref()
    jax = r["jax"]
    tmp = tmp_path_factory.mktemp(arch)
    init, ref_ckpt, port_ckpt = (str(tmp / n) for n in ("init", "ref",
                                                        "port"))
    ref_cfg = r["cfg"](arch)
    with r["parity"].reference_mode():
        params0 = r["tf"].init_decoder_lm(ref_cfg, jax.random.key(0))
        r["save"](init, params0, 0)
        ref_losses = r["train"].train_standard(
            ref_cfg, argparse.Namespace(
                arch=arch, steps=STEPS, batch=BATCH, seq=SEQ, lr=LR,
                seed=0, log_every=5, ckpt=ref_ckpt, full=False),
            r["mesh"]())
    argv = ["--device", "cpu", "--steps", str(STEPS), "--batch",
            str(BATCH), "--seq", str(SEQ), "--lr", str(LR), "--init-from",
            init, "--ckpt", port_ckpt]
    if arch != "xlstm_125m":
        argv += ["--arch", arch]
    log = train.main(argv)
    return dict(arch=arch, ref_losses=ref_losses, log=log, like=params0,
                ref_ckpt=ref_ckpt, port_ckpt=port_ckpt)


def test_main_trains_the_family_as_the_reference(family_runs):
    log = family_runs["log"]
    np.testing.assert_allclose(log.losses, family_runs["ref_losses"],
                               rtol=LOSS_RTOL)
    assert len(log.losses) == STEPS and all(np.isfinite(log.grad_norms))


def test_family_checkpoints_restore_both_ways(family_runs):
    r = _ref()
    jax = r["jax"]
    cfg = smoke_variant(get_config(family_runs["arch"]))
    like = family_runs["like"]
    got = r["restore"](family_runs["port_ckpt"], like)
    _assert_tree_equal(convert.decoder_lm_to_numpy(
        family_runs["log"].state.params), got, jax)
    want = r["restore"](family_runs["ref_ckpt"], like)
    port = train.load_params(family_runs["ref_ckpt"], cfg, "cpu")
    _assert_tree_equal(convert.decoder_lm_to_numpy(port), want, jax)


def test_encoder_decoder_is_refused_with_its_route():
    with pytest.raises(SystemExit, match="make_train_step"):
        train.main(["--device", "cpu", "--arch", "whisper_small",
                    "--steps", "1"])


# ---------------------------------------------------------------------------
# Decentralized xlstm in 2 gloo ranks
# ---------------------------------------------------------------------------

def _dargs(init_dir):
    return train.parse_args(
        ["--device", "cpu", "--mode", "decentralized", "--nodes", str(N),
         "--sync", "gossip-ring[1]", "--local-steps", str(H), "--steps",
         str(DSTEPS), "--batch", str(BATCH), "--seq", str(SEQ), "--lr",
         str(DLR), "--seed", str(SEED), "--init-from", init_dir,
         "--log-every", "1"])


def _rank_job(init_dir):
    """What each rank runs (no JAX here)."""
    torch.set_num_threads(1)
    args = _dargs(init_dir)
    log = train.train_decentralized(train.config_of(args), args,
                                    make_host_mesh())
    mine = {"params": convert.decoder_lm_to_numpy(log.state.params),
            "losses": log.losses, "step": log.state.step,
            "spreads": log.spreads}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    assert "jax" not in sys.modules and "repro.core" not in sys.modules
    return every


def _compose(params0):
    """The reference's decentralized step_fn, node by node (H local
    steps of its lm_loss / value_and_grad / opt.update, the loss after
    them), then its sync_tree_sim of the node-stacked params."""
    r = _ref()
    jax, jnp = r["jax"], r["jnp"]
    cfg = r["cfg"]("xlstm_125m")
    spec = r["dec"].parse_sync("gossip-ring[1]")
    opt = r["make_opt"](cfg.optimizer, r["sched"]("constant", DLR))

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
        pipe = r["pipe"](cfg.vocab_size, SEQ, N * H * BATCH, seed=SEED)
        losses, step = [], jnp.zeros((), jnp.int32)
        for _t, batch in zip(range(DSTEPS), pipe.batches()):
            shp = (N, H, BATCH, SEQ)
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


@pytest.fixture(scope="module")
def xlstm_world2():
    """The reference's consensus start (the mean of its N draws from the
    split key), saved as a params checkpoint, and the 2-rank run."""
    r = _ref()
    jax = r["jax"]
    cfg = r["cfg"]("xlstm_125m")
    with r["parity"].reference_mode():
        keys = jax.random.split(jax.random.key(SEED), N)
        stacked = jax.vmap(lambda k: r["tf"].init_decoder_lm(cfg, k))(keys)
        params0 = jax.tree.map(lambda x: np.asarray(x.mean(0)), stacked)
    tmp = tempfile.mkdtemp(prefix="dec_xlstm_")
    try:
        r["save"](os.path.join(tmp, "init"), params0, 0)
        got = gossip_sim.launch(_rank_job, N, "gloo",
                                (os.path.join(tmp, "init"),),
                                timeout_s=LAUNCH_TIMEOUT_S)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return params0, got


def _resolved(params0):
    """Per leaf, the elements whose gradient the reference's first local
    step (node 0's first microbatch) puts at or above ``GRAD_REL`` of the
    leaf's max |g|: the resolution at which the port's gradients are held
    (``tests/test_torch_train_families.py``). Below it the gradient is
    rounding noise in both packages, and AdamW's sign-like steps move
    such an element by up to lr either way. In xlstm these are the
    sLSTM's input-gate biases: the gate scales both c and n of the
    normalised state c / n, so their gradients cancel."""
    r = _ref()
    jax, jnp = r["jax"], r["jnp"]
    cfg = r["cfg"]("xlstm_125m")
    with r["parity"].reference_mode():
        batch = next(r["pipe"](cfg.vocab_size, SEQ, N * H * BATCH,
                               seed=SEED).batches())
        b = {k: jnp.asarray(np.asarray(x).reshape(N, H, BATCH, SEQ)[0, 0])
             for k, x in zip(("tokens", "targets", "mask"), batch)}
        g = jax.grad(lambda q: r["tf"].lm_loss(cfg, q, b))(
            jax.tree.map(jnp.asarray, params0))
    return jax.tree.map(
        lambda x: np.abs(np.asarray(x)) >= GRAD_REL * np.abs(
            np.asarray(x)).max(), g)


def test_decentralized_xlstm_matches_composed_reference(xlstm_world2):
    """Losses within ``LOSS_RTOL``; the parameters within
    ``tests/test_torch_decentralized.py``'s bound: every element within
    a tenth of the summed lr, and at most 1e-3 of a leaf's elements
    beyond 1e-6 among those the gradient resolves (``_resolved``). A
    leaf the loss does not reach (each layer's idle block) moves by
    weight decay alone, the same on both sides."""
    jax = _ref()["jax"]
    params0, got = xlstm_world2
    want_nodes, want_losses = _compose(params0)
    sure = _resolved(params0)
    lr_sum = DLR * H * DSTEPS
    assert len(got) == N
    for rank in range(N):
        np.testing.assert_allclose(got[rank]["losses"], want_losses,
                                   rtol=LOSS_RTOL)
        assert got[rank]["step"] == DSTEPS * H
        for path, w in jax.tree_util.tree_flatten_with_path(
                want_nodes[rank])[0]:
            g = got[rank]["params"]
            for k in path:
                g = g[k.key]
            d = np.abs(g - w)
            name = jax.tree_util.keystr(path)
            assert d.max() < 0.1 * lr_sum, (name, d.max())
            m = sure
            for k in path:
                m = m[k.key]
            d = d[m]
            assert (d > 1e-6).mean() <= 1e-3, (name, (d > 1e-6).sum())
    # gossip-ring[1] over 2 nodes is exact: one mean, the same on both
    for a, b in zip(torch.utils._pytree.tree_leaves(got[0]["params"]),
                    torch.utils._pytree.tree_leaves(got[1]["params"])):
        np.testing.assert_array_equal(a, b)
