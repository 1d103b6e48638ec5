"""Decoder LM, dense family: init, full-sequence forward and decode step.

The port's copy of the dense branch of the JAX package's
``models/transformer.py``: ``[norm attn (post) norm mlp (post)] x L``
with gemma2's local/global window alternation, logit softcaps and
sandwich norms, the tied unembedding, and the one-token cached step of
serving. Parameters are plain dicts of tensors with the reference's
names; the reference's layer stack (one array per leaf, layers on axis
0, for ``lax.scan``) is a list of per-layer dicts here, run by a Python
loop. Attention goes through the ``flash_attention`` kernel (whose
gradient is a ``torch.autograd.Function``). ``lm_loss`` is the training
objective; with gradients on, ``forward`` recomputes each layer in the
backward as ``cfg.remat`` / ``cfg.remat_policy`` say (``_maybe_remat``,
``torch.utils.checkpoint``). The other families (moe, hybrid, ssm, vlm,
encdec) wait for later slices of the port.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import GLOBAL_WINDOW
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L

__all__ = ["GLOBAL_WINDOW", "ForwardOutput", "init_decoder_lm",
           "embed_inputs", "forward", "init_caches", "decode_step",
           "lm_loss", "DecoderLM"]


class ForwardOutput(NamedTuple):
    logits: torch.Tensor
    caches: Any
    aux_loss: torch.Tensor


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet (the "
            f"port runs the dense decoder; the rest of the LM scaffold is "
            f"slice 7 in ROADMAP.md)")


def _norm_init(cfg: ModelConfig, dtype, device):
    return (L.init_rmsnorm(cfg.d_model, dtype, device)
            if cfg.norm == "rmsnorm"
            else L.init_layernorm(cfg.d_model, dtype, device))


def _apply_norm(cfg: ModelConfig, p, x):
    return (L.apply_rmsnorm(p, x) if cfg.norm == "rmsnorm"
            else L.apply_layernorm(p, x))


def _init_mlp(cfg: ModelConfig, gen, dtype):
    p = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype)
    if not cfg.mlp_gated:
        p.pop("w_gate")
    return p


def _apply_mlp(cfg: ModelConfig, p, x):
    if cfg.mlp_gated:
        return L.apply_mlp(p, x, cfg.act)
    return L.activation(cfg.act)(x @ p["w_up"]) @ p["w_down"]


def _init_dense_layer(cfg: ModelConfig, gen, dtype) -> dict:
    p = {
        "ln1": _norm_init(cfg, dtype, gen.device),
        "attn": attn_mod.init_attention(gen, cfg.d_model, cfg.n_heads,
                                        cfg.n_kv, cfg.hd, dtype,
                                        cfg.qkv_bias),
        "ln2": _norm_init(cfg, dtype, gen.device),
        "mlp": _init_mlp(cfg, gen, dtype),
    }
    if cfg.post_norms:
        p["ln1_post"] = _norm_init(cfg, dtype, gen.device)
        p["ln2_post"] = _norm_init(cfg, dtype, gen.device)
    return p


def _apply_dense_layer(cfg: ModelConfig, p: dict, x, start: int, window,
                       cache=None):
    h = _apply_norm(cfg, p["ln1"], x)
    h, new_cache = attn_mod.apply_attention(
        p["attn"], h, start, window=window, cap=cfg.attn_softcap,
        rope_theta=None if cfg.pos_embed != "rope" else cfg.rope_theta,
        query_scale=cfg.query_scale, cache=cache)
    if cfg.post_norms:
        h = _apply_norm(cfg, p["ln1_post"], h)
    x = x + h
    h = _apply_norm(cfg, p["ln2"], x)
    h = _apply_mlp(cfg, p["mlp"], h)
    if cfg.post_norms:
        h = _apply_norm(cfg, p["ln2_post"], h)
    return x + h, new_cache


def _layer_windows(cfg: ModelConfig) -> list[int]:
    """Per-layer window sizes: gemma2 alternates local / global."""
    if cfg.local_global_pattern and cfg.window:
        return [cfg.window if i % 2 == 0 else GLOBAL_WINDOW
                for i in range(cfg.n_layers)]
    return [cfg.window or GLOBAL_WINDOW] * cfg.n_layers


def init_decoder_lm(cfg: ModelConfig, gen: torch.Generator,
                    device=None) -> dict:
    """Random parameters from ``gen``, in the config's dtype (the
    reference's init laws, not its bits). They are drawn on ``gen``'s
    device and moved to ``device`` (default: ``gen``'s) a layer at a
    time, so a CPU generator gives the same weights on every device."""
    _require_dense(cfg)
    dtype = cfg.torch_dtype
    dev = gen.device if device is None else torch.device(device)

    def put(tree: dict) -> dict:
        return {k: put(v) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}

    params: dict = {
        "embed": put(L.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                      dtype)),
        "final_norm": put(_norm_init(cfg, dtype, gen.device)),
    }
    params["layers"] = [put(_init_dense_layer(cfg, gen, dtype))
                        for _ in range(cfg.n_layers)]
    return params


def embed_inputs(cfg: ModelConfig, params: dict,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings (the reference's VLM image prefix is not ported)."""
    return L.apply_embedding(params["embed"], tokens)


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


def forward(cfg: ModelConfig, params: dict,
            tokens: torch.Tensor) -> ForwardOutput:
    """Full-sequence forward (training, prefill). tokens [B, S],
    positions 0..S-1."""
    _require_dense(cfg)
    x = embed_inputs(cfg, params, tokens)

    def body(x, p, w):
        return _apply_dense_layer(cfg, p, x, 0, w)[0]

    layer = _maybe_remat(cfg, body)
    for p, w in zip(params["layers"], _layer_windows(cfg)):
        x = layer(x, p, w)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return ForwardOutput(logits=_logits(cfg, params, x), caches=None,
                         aux_loss=aux)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device) -> list[attn_mod.KVCache]:
    """One empty KV cache per layer for decode."""
    _require_dense(cfg)
    return [attn_mod.init_kv_cache(batch, max_len, cfg.n_kv, cfg.hd,
                                   cfg.torch_dtype, device)
            for _ in range(cfg.n_layers)]


def decode_step(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                caches: list[attn_mod.KVCache], index: int) -> ForwardOutput:
    """One-token decode. tokens [B, 1]; index: the filled length, which
    is every row's position. The caches are written in place."""
    _require_dense(cfg)
    x = L.apply_embedding(params["embed"], tokens)
    new_caches = []
    for p, w, cache in zip(params["layers"], _layer_windows(cfg), caches):
        x, nc = _apply_dense_layer(cfg, p, x, index, w,
                                   cache=cache._replace(index=index))
        new_caches.append(nc)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return ForwardOutput(logits=_logits(cfg, params, x), caches=new_caches,
                         aux_loss=aux)


# ----------------------------------------------------------------------------
# Loss
# ----------------------------------------------------------------------------

def lm_loss(cfg: ModelConfig, params: dict, batch: dict,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Mean next-token cross-entropy (+ the MoE aux term, 0 for the dense
    family): float32 log-softmax, masked mean over ``batch["mask"]``."""
    out = forward(cfg, params, batch["tokens"])
    logp = torch.log_softmax(out.logits.float(), dim=-1)
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
