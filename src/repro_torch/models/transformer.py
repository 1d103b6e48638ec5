"""Decoder LM of every decoder family: init, forward and decode step.

The port's copy of the JAX package's ``models/transformer.py``. Family
dispatch, as the reference's:

  dense / vlm   [norm attn (post) norm mlp (post)] x L; gemma2's
                local/global window alternation, logit softcaps and
                sandwich norms; vlm prepends image patch embeddings
  moe           ``first_dense_layers`` dense layers, then MoE layers
                (attention + ``models/moe``); the per-layer aux loss
                averaged
  hybrid        Mamba2 backbone; one SHARED attn+mlp block applied after
                every ``attn_every`` layers (zamba2), one KV cache per
                application
  ssm           mLSTM blocks with an sLSTM block at ``i % slstm_every ==
                slstm_every - 1`` (xlstm)

The tied unembedding and the one-token cached step of serving are common
to all. Parameters are plain dicts of tensors with the reference's
names; the reference's layer stacks (one array per leaf, layers on axis
0, for ``lax.scan``) are lists of per-layer dicts here, run by a Python
loop (``layers``, ``dense_layers``); zamba2's ``shared_attn`` is one
dict, as in the reference. Every attention goes through the
``flash_attention`` kernel (whose gradient is a
``torch.autograd.Function``). ``lm_loss`` is the training objective;
with gradients on, ``forward`` recomputes each layer in the backward as
``cfg.remat`` / ``cfg.remat_policy`` say (``_maybe_remat``,
``torch.utils.checkpoint``).

The ssm family: the reference runs both blocks of every layer and keeps
one with ``jnp.where``. A layer's kind is fixed by its index, so the
port runs the selected block only: the logits are the same, and the
other block's cache, which the reference updates but never reads, stays
as ``init_caches`` made it. The encoder-decoder (whisper) is
``models/encdec.py``; ``init_decoder_lm`` refuses it, as the
reference's does.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Any, NamedTuple, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import GLOBAL_WINDOW
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xl
from repro_torch.sharding.local import data_parallel, like

__all__ = ["GLOBAL_WINDOW", "ForwardOutput", "init_decoder_lm",
           "decoder_lm_axes", "embed_inputs", "forward", "init_caches",
           "decode_step", "lm_loss", "DecoderLM"]


class ForwardOutput(NamedTuple):
    logits: torch.Tensor
    caches: Any
    aux_loss: torch.Tensor


# ============================================================================
# Param init
# ============================================================================

def _norm_init(cfg: ModelConfig, dtype, device):
    return (L.init_rmsnorm(cfg.d_model, dtype, device)
            if cfg.norm == "rmsnorm"
            else L.init_layernorm(cfg.d_model, dtype, device))


def _norm_axes(cfg: ModelConfig):
    return (L.rmsnorm_axes() if cfg.norm == "rmsnorm"
            else L.layernorm_axes())


def _apply_norm(cfg: ModelConfig, p, x):
    return (L.apply_rmsnorm(p, x) if cfg.norm == "rmsnorm"
            else L.apply_layernorm(p, x))


def _init_mlp(cfg: ModelConfig, gen, dtype):
    p = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype)
    if not cfg.mlp_gated:
        p.pop("w_gate")
    return p


def _mlp_axes(cfg: ModelConfig):
    a = L.mlp_axes()
    if not cfg.mlp_gated:
        a.pop("w_gate")
    return a


def _apply_mlp(cfg: ModelConfig, p, x):
    if cfg.mlp_gated:
        return like(L.apply_mlp(p, x, cfg.act), x)
    return like(L.activation(cfg.act)(x @ p["w_up"]) @ p["w_down"], x)


def _init_attention(cfg: ModelConfig, gen, dtype, qkv_bias=None) -> dict:
    return attn_mod.init_attention(
        gen, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, dtype,
        cfg.qkv_bias if qkv_bias is None else qkv_bias)


def _init_dense_layer(cfg: ModelConfig, gen, dtype) -> dict:
    p = {
        "ln1": _norm_init(cfg, dtype, gen.device),
        "attn": _init_attention(cfg, gen, dtype),
        "ln2": _norm_init(cfg, dtype, gen.device),
        "mlp": _init_mlp(cfg, gen, dtype),
    }
    if cfg.post_norms:
        p["ln1_post"] = _norm_init(cfg, dtype, gen.device)
        p["ln2_post"] = _norm_init(cfg, dtype, gen.device)
    return p


def _dense_layer_axes(cfg: ModelConfig) -> dict:
    a = {
        "ln1": _norm_axes(cfg),
        "attn": attn_mod.attention_axes(cfg.qkv_bias),
        "ln2": _norm_axes(cfg),
        "mlp": _mlp_axes(cfg),
    }
    if cfg.post_norms:
        a["ln1_post"] = _norm_axes(cfg)
        a["ln2_post"] = _norm_axes(cfg)
    return a


def _init_moe_layer(cfg: ModelConfig, gen, dtype) -> dict:
    return {
        "ln1": _norm_init(cfg, dtype, gen.device),
        "attn": _init_attention(cfg, gen, dtype),
        "ln2": _norm_init(cfg, dtype, gen.device),
        "moe": moe_mod.init_moe(gen, cfg.d_model, cfg.n_experts,
                                cfg.moe_d_ff, cfg.top_k, dtype,
                                cfg.shared_expert_d_ff,
                                cfg.dense_residual_d_ff),
    }


def _moe_layer_axes(cfg: ModelConfig) -> dict:
    return {
        "ln1": _norm_axes(cfg),
        "attn": attn_mod.attention_axes(cfg.qkv_bias),
        "ln2": _norm_axes(cfg),
        "moe": moe_mod.moe_axes(bool(cfg.shared_expert_d_ff),
                                bool(cfg.dense_residual_d_ff)),
    }


def _mamba_dims(cfg: ModelConfig) -> m2.Mamba2Dims:
    return m2.Mamba2Dims(d_model=cfg.d_model, d_state=cfg.ssm_state,
                         head_dim=cfg.ssm_head_dim,
                         conv_kernel=cfg.conv_kernel, chunk=cfg.ssd_chunk)


def _xlstm_dims(cfg: ModelConfig) -> xl.XLSTMDims:
    return xl.XLSTMDims(d_model=cfg.d_model, n_heads=cfg.n_heads,
                        conv_kernel=cfg.conv_kernel,
                        chunk=cfg.xlstm_chunk)


def _n_stages(cfg: ModelConfig) -> int:
    """zamba2's applications of the shared block: one after every
    ``attn_every`` Mamba2 layers (the depth must be a multiple)."""
    if cfg.attn_every < 1 or cfg.n_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not a "
                         f"multiple of attn_every={cfg.attn_every}")
    return cfg.n_layers // cfg.attn_every


def _is_slstm(cfg: ModelConfig, i: int) -> bool:
    return bool(cfg.slstm_every) and i % cfg.slstm_every == \
        cfg.slstm_every - 1


def _put(tree: dict, dev) -> dict:
    return {k: _put(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def init_decoder_lm(cfg: ModelConfig, gen: torch.Generator,
                    device=None) -> dict:
    """Random parameters from ``gen``, in the config's dtype (the
    reference's init laws and tree, not its bits). They are drawn on
    ``gen``'s device and moved to ``device`` (default: ``gen``'s) a layer
    at a time, so a CPU generator gives the same weights on every
    device, and a CUDA one draws a large model on the card."""
    dtype = cfg.torch_dtype
    dev = gen.device if device is None else torch.device(device)

    def stack(n, init_one):
        return [_put(init_one(), dev) for _ in range(n)]

    params: dict = {
        "embed": _put(L.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                       dtype), dev),
        "final_norm": _put(_norm_init(cfg, dtype, gen.device), dev),
    }
    if cfg.family in ("dense", "vlm"):
        params["layers"] = stack(
            cfg.n_layers, lambda: _init_dense_layer(cfg, gen, dtype))
    elif cfg.family == "moe":
        params["layers"] = stack(cfg.n_layers - cfg.first_dense_layers,
                                 lambda: _init_moe_layer(cfg, gen, dtype))
        if cfg.first_dense_layers:
            params["dense_layers"] = stack(
                cfg.first_dense_layers,
                lambda: _init_dense_layer(cfg, gen, dtype))
    elif cfg.family == "hybrid":
        _n_stages(cfg)
        dims = _mamba_dims(cfg)
        params["layers"] = stack(
            cfg.n_layers,
            lambda: {"ln": _norm_init(cfg, dtype, gen.device),
                     "mamba": m2.init_mamba2(gen, dims, dtype)})
        params["shared_attn"] = _put(_init_dense_layer(cfg, gen, dtype), dev)
    elif cfg.family == "ssm":
        dims = _xlstm_dims(cfg)
        params["layers"] = stack(
            cfg.n_layers,
            lambda: {"ln": _norm_init(cfg, dtype, gen.device),
                     "mlstm": xl.init_mlstm(gen, dims, dtype),
                     "slstm": xl.init_slstm(gen, dims, dtype)})
    else:
        raise ValueError(f"init_decoder_lm: unsupported family {cfg.family}")
    return params


def _stacked_axes(n: int, axes_one) -> list:
    """The axes of a layer stack: the port keeps a list of ``n``
    per-layer dicts where the reference stacks each leaf on a leading
    "layers" axis (which every rule set replicates), so each layer's
    leaves carry ``axes_one`` as they are."""
    return [copy.deepcopy(axes_one) for _ in range(n)]


def decoder_lm_axes(cfg: ModelConfig) -> dict:
    """Logical axes of ``init_decoder_lm``'s tree, leaf for leaf."""
    axes: dict = {
        "embed": L.embedding_axes(),
        "final_norm": _norm_axes(cfg),
    }
    if cfg.family in ("dense", "vlm"):
        axes["layers"] = _stacked_axes(cfg.n_layers, _dense_layer_axes(cfg))
    elif cfg.family == "moe":
        axes["layers"] = _stacked_axes(cfg.n_layers - cfg.first_dense_layers,
                                       _moe_layer_axes(cfg))
        if cfg.first_dense_layers:
            axes["dense_layers"] = _stacked_axes(cfg.first_dense_layers,
                                                 _dense_layer_axes(cfg))
    elif cfg.family == "hybrid":
        axes["layers"] = _stacked_axes(
            cfg.n_layers, {"ln": _norm_axes(cfg), "mamba": m2.mamba2_axes()})
        axes["shared_attn"] = _dense_layer_axes(cfg)
    elif cfg.family == "ssm":
        axes["layers"] = _stacked_axes(
            cfg.n_layers, {"ln": _norm_axes(cfg),
                           "mlstm": xl.mlstm_axes(),
                           "slstm": xl.slstm_axes()})
    return axes


# ============================================================================
# Per-layer application
# ============================================================================

def _apply_dense_layer(cfg: ModelConfig, p: dict, x, start: int, window,
                       cache=None):
    h = _apply_norm(cfg, p["ln1"], x)
    h, new_cache = attn_mod.apply_attention(
        p["attn"], h, start, window=window, cap=cfg.attn_softcap,
        rope_theta=None if cfg.pos_embed != "rope" else cfg.rope_theta,
        query_scale=cfg.query_scale, cache=cache, chunk_q=cfg.attn_chunk_q)
    if cfg.post_norms:
        h = _apply_norm(cfg, p["ln1_post"], h)
    x = x + h
    h = _apply_norm(cfg, p["ln2"], x)
    h = _apply_mlp(cfg, p["mlp"], h)
    if cfg.post_norms:
        h = _apply_norm(cfg, p["ln2_post"], h)
    return x + h, new_cache


def _apply_moe_layer(cfg: ModelConfig, p: dict, x, start: int, cache=None):
    h = _apply_norm(cfg, p["ln1"], x)
    h, new_cache = attn_mod.apply_attention(
        p["attn"], h, start, window=None, cap=cfg.attn_softcap,
        rope_theta=cfg.rope_theta, query_scale=cfg.query_scale, cache=cache,
        chunk_q=cfg.attn_chunk_q)
    x = x + h
    h = _apply_norm(cfg, p["ln2"], x)
    out = moe_mod.apply_moe(p["moe"], h, cfg.top_k, impl=cfg.moe_impl,
                            capacity_factor=cfg.moe_capacity_factor)
    return x + out.y, new_cache, out.aux_loss


def _apply_mamba_layer(cfg: ModelConfig, p: dict, x, cache=None):
    h, new_cache = data_parallel(
        lambda pm, h, c: m2.apply_mamba2(pm, _mamba_dims(cfg), h, cache=c),
        p["mamba"], _apply_norm(cfg, p["ln"], x), cache)
    return x + h, new_cache


def _apply_xlstm_layer(cfg: ModelConfig, p: dict, x, slstm: bool,
                       cache=None):
    """The layer's own block only (see the module docstring)."""
    h = _apply_norm(cfg, p["ln"], x)
    block = xl.apply_slstm if slstm else xl.apply_mlstm
    h, new_cache = data_parallel(
        lambda pb, h, c: block(pb, _xlstm_dims(cfg), h, cache=c),
        p["slstm" if slstm else "mlstm"], h, cache)
    return x + h.to(x.dtype), new_cache


def _layer_windows(cfg: ModelConfig) -> list[int]:
    """Per-layer window sizes: gemma2 alternates local / global."""
    if cfg.local_global_pattern and cfg.window:
        return [cfg.window if i % 2 == 0 else GLOBAL_WINDOW
                for i in range(cfg.n_layers)]
    return [cfg.window or GLOBAL_WINDOW] * cfg.n_layers


def embed_inputs(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                 image_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Token embeddings; a vlm prepends (stub) image patch embeddings."""
    x = L.apply_embedding(params["embed"], tokens)
    if cfg.family == "vlm" and image_embeds is not None:
        x = torch.cat([image_embeds.to(x.dtype), x], dim=1)
    return x


def _logits(cfg: ModelConfig, params: dict, x) -> torch.Tensor:
    x = _apply_norm(cfg, params["final_norm"], x)
    logits = L.apply_unembed(params["embed"], x)
    return L.softcap(logits, cfg.final_softcap)


def _save_matmuls(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The "dots" policy: keep the outputs of products without batch
    dims (the reference's ``dots_with_no_batch_dims_saveable``: the
    projections and the MLP), recompute the rest."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(cfg: ModelConfig, fn):
    """``fn`` recomputed in the backward: "full" recomputes everything,
    "dots" keeps the matmul outputs, "none" (or ``remat=False``) keeps
    everything. Without gradients it is ``fn`` itself."""
    if (not cfg.remat or cfg.remat_policy == "none"
            or not torch.is_grad_enabled()):
        return fn
    if cfg.remat_policy == "dots":
        ctx_fn = functools.partial(create_selective_checkpoint_contexts,
                                   _save_matmuls)
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=ctx_fn)
    if cfg.remat_policy != "full":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    return functools.partial(checkpoint, fn, use_reentrant=False)


# ============================================================================
# Forward (train / prefill) and decode_step
# ============================================================================

def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            image_embeds: Optional[torch.Tensor] = None) -> ForwardOutput:
    """Full-sequence forward (training, prefill). tokens [B, S]; a vlm's
    image embeddings [B, N, d] come first, positions 0..N+S-1."""
    x = embed_inputs(cfg, params, tokens, image_embeds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    if cfg.family in ("dense", "vlm"):
        def body(x, p, w):
            return _apply_dense_layer(cfg, p, x, 0, w)[0]

        layer = _maybe_remat(cfg, body)
        for p, w in zip(params["layers"], _layer_windows(cfg)):
            x = layer(x, p, w)

    elif cfg.family == "moe":
        dense = _maybe_remat(
            cfg, lambda x, p: _apply_dense_layer(cfg, p, x, 0, None)[0])
        for p in params.get("dense_layers", []):
            x = dense(x, p)

        def body(x, p):
            x, _, aux_l = _apply_moe_layer(cfg, p, x, 0)
            return x, aux_l

        layer = _maybe_remat(cfg, body)
        auxes = []
        for p in params["layers"]:
            x, aux_l = layer(x, p)
            auxes.append(aux_l)
        aux = torch.stack(auxes).mean()

    elif cfg.family == "hybrid":
        mamba = _maybe_remat(
            cfg, lambda x, p: _apply_mamba_layer(cfg, p, x)[0])
        for stage in range(_n_stages(cfg)):
            for i in range(stage * cfg.attn_every,
                           (stage + 1) * cfg.attn_every):
                x = mamba(x, params["layers"][i])
            x, _ = _apply_dense_layer(cfg, params["shared_attn"], x, 0,
                                      None)

    elif cfg.family == "ssm":
        def body(x, p, slstm):
            return _apply_xlstm_layer(cfg, p, x, slstm)[0]

        layer = _maybe_remat(cfg, body)
        for i, p in enumerate(params["layers"]):
            x = layer(x, p, _is_slstm(cfg, i))
    else:
        raise ValueError(f"forward: unsupported family {cfg.family}")

    return ForwardOutput(logits=_logits(cfg, params, x), caches=None,
                         aux_loss=aux)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device):
    """Empty caches for decode: one KV cache per attention layer (dense,
    vlm, moe: a list; kimi's dense first layers take its leading slots);
    hybrid ``{"mamba": [one per layer], "attn": [one per stage]}``; ssm
    ``{"mlstm": [...], "slstm": [...]}``, both per layer."""
    dtype = cfg.torch_dtype

    def kv():
        return attn_mod.init_kv_cache(batch, max_len, cfg.n_kv, cfg.hd,
                                      dtype, device)

    if cfg.family in ("dense", "vlm", "moe"):
        return [kv() for _ in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        dims = _mamba_dims(cfg)
        return {"mamba": [m2.init_mamba_cache(dims, batch, dtype, device)
                          for _ in range(cfg.n_layers)],
                "attn": [kv() for _ in range(_n_stages(cfg))]}
    if cfg.family == "ssm":
        dims = _xlstm_dims(cfg)
        return {"mlstm": [xl.init_mlstm_cache(dims, batch, dtype, device)
                          for _ in range(cfg.n_layers)],
                "slstm": [xl.init_slstm_cache(dims, batch, dtype, device)
                          for _ in range(cfg.n_layers)]}
    raise ValueError(f"init_caches: unsupported family {cfg.family}")


def decode_step(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                caches, index: int) -> ForwardOutput:
    """One-token decode. tokens [B, 1]; index: the filled length, which
    is every row's position. KV caches are written in place; the
    recurrent states (Mamba2, xLSTM) come back new."""
    x = L.apply_embedding(params["embed"], tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    if cfg.family in ("dense", "vlm"):
        new_caches = []
        for p, w, cache in zip(params["layers"], _layer_windows(cfg),
                               caches):
            x, nc = _apply_dense_layer(cfg, p, x, index, w,
                                       cache=cache._replace(index=index))
            new_caches.append(nc)

    elif cfg.family == "moe":
        # the first_dense_layers share the caches' leading slots
        n_d = cfg.first_dense_layers
        new_caches = []
        for p, cache in zip(params.get("dense_layers", []), caches[:n_d]):
            x, nc = _apply_dense_layer(cfg, p, x, index, None,
                                       cache=cache._replace(index=index))
            new_caches.append(nc)
        for p, cache in zip(params["layers"], caches[n_d:]):
            x, nc, _ = _apply_moe_layer(cfg, p, x, index,
                                        cache=cache._replace(index=index))
            new_caches.append(nc)

    elif cfg.family == "hybrid":
        new_m, new_a = [], []
        for stage, ac in enumerate(caches["attn"]):
            for i in range(stage * cfg.attn_every,
                           (stage + 1) * cfg.attn_every):
                x, nm = _apply_mamba_layer(cfg, params["layers"][i], x,
                                           cache=caches["mamba"][i])
                new_m.append(nm)
            x, na = _apply_dense_layer(cfg, params["shared_attn"], x, index,
                                       None, cache=ac._replace(index=index))
            new_a.append(na)
        new_caches = {"mamba": new_m, "attn": new_a}

    elif cfg.family == "ssm":
        new_ml, new_sl = list(caches["mlstm"]), list(caches["slstm"])
        for i, p in enumerate(params["layers"]):
            if _is_slstm(cfg, i):
                x, new_sl[i] = _apply_xlstm_layer(cfg, p, x, True,
                                                  cache=new_sl[i])
            else:
                x, new_ml[i] = _apply_xlstm_layer(cfg, p, x, False,
                                                  cache=new_ml[i])
        new_caches = {"mlstm": new_ml, "slstm": new_sl}
    else:
        raise ValueError(f"decode_step: unsupported family {cfg.family}")

    return ForwardOutput(logits=_logits(cfg, params, x), caches=new_caches,
                         aux_loss=aux)


# ----------------------------------------------------------------------------
# Loss
# ----------------------------------------------------------------------------

def lm_loss(cfg: ModelConfig, params: dict, batch: dict,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Mean next-token cross-entropy (+ the MoE aux term): float32
    log-softmax, masked mean over ``batch["mask"]``; a vlm's loss is on
    the text positions only."""
    image_embeds = batch.get("image_embeds")
    out = forward(cfg, params, batch["tokens"], image_embeds=image_embeds)
    logits = out.logits
    if cfg.family == "vlm" and image_embeds is not None:
        logits = logits[:, image_embeds.shape[1]:]
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, batch["targets"].long()[..., None])[..., 0]
    maskf = batch["mask"].float()
    loss = -(ll * maskf).sum() / torch.clamp(maskf.sum(), min=1.0)
    return loss + aux_weight * out.aux_loss


@dataclasses.dataclass(frozen=True)
class DecoderLM:
    """Convenience holder used by examples."""

    cfg: ModelConfig

    def init(self, gen: torch.Generator, device=None) -> dict:
        return init_decoder_lm(self.cfg, gen, device)

    def __call__(self, params, tokens, **kw):
        return forward(self.cfg, params, tokens, **kw)
