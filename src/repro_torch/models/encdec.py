"""Whisper-style encoder-decoder backbone.

The port's copy of the JAX package's ``models/encdec.py``. The mel
spectrogram and conv feature extractor are the allowed stub: the encoder
takes precomputed frame embeddings [B, T_src, d_model]
(``models/frontends``). Encoder: non-causal self-attention without RoPE,
LayerNorm; the frontend adds the positions. Decoder: learned positions
(no sqrt(d) scale on the embedding), causal self-attention, cross-
attention over the encoder memory and the MLP. Decode carries a KV cache
per layer for the self-attention and each layer's cross K/V, computed
once per utterance by ``init_encdec_caches``. Every attention goes
through the ``flash_attention`` kernel, whose gradient reaches the
encoder through every cross-attention's K and V. Layer stacks are lists
of per-layer dicts (``encoder``, ``decoder``), run by Python loops.
``encdec_loss`` is the training objective.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models.transformer import (ForwardOutput, _apply_mlp,
                                            _apply_norm, _init_attention,
                                            _init_mlp, _maybe_remat,
                                            _mlp_axes, _norm_axes,
                                            _norm_init, _put, _stacked_axes)

__all__ = ["init_encdec", "encdec_axes", "encode", "forward_encdec",
           "EncDecCaches", "init_encdec_caches", "decode_step_encdec",
           "encdec_loss"]


def _init_enc_layer(cfg: ModelConfig, gen, dtype) -> dict:
    return {
        "ln1": _norm_init(cfg, dtype, gen.device),
        "attn": _init_attention(cfg, gen, dtype, qkv_bias=True),
        "ln2": _norm_init(cfg, dtype, gen.device),
        "mlp": _init_mlp(cfg, gen, dtype),
    }


def _init_dec_layer(cfg: ModelConfig, gen, dtype) -> dict:
    return {
        "ln1": _norm_init(cfg, dtype, gen.device),
        "self_attn": _init_attention(cfg, gen, dtype, qkv_bias=True),
        "lnx": _norm_init(cfg, dtype, gen.device),
        "cross_attn": _init_attention(cfg, gen, dtype, qkv_bias=True),
        "ln2": _norm_init(cfg, dtype, gen.device),
        "mlp": _init_mlp(cfg, gen, dtype),
    }


def init_encdec(cfg: ModelConfig, gen: torch.Generator,
                device=None) -> dict:
    """Random parameters from ``gen`` (the reference's laws and tree),
    drawn on ``gen``'s device and moved to ``device`` a layer at a
    time."""
    dtype = cfg.torch_dtype
    dev = gen.device if device is None else torch.device(device)
    return {
        "embed": _put(L.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                       dtype), dev),
        "pos_embed": L.trunc_normal(gen, (cfg.max_source_len * 4,
                                          cfg.d_model), dtype,
                                    fan_in=cfg.d_model).to(dev),
        "encoder": [_put(_init_enc_layer(cfg, gen, dtype), dev)
                    for _ in range(cfg.n_encoder_layers)],
        "enc_norm": _put(_norm_init(cfg, dtype, gen.device), dev),
        "decoder": [_put(_init_dec_layer(cfg, gen, dtype), dev)
                    for _ in range(cfg.n_layers)],
        "final_norm": _put(_norm_init(cfg, dtype, gen.device), dev),
    }


def encdec_axes(cfg: ModelConfig) -> dict:
    """Logical axes of ``init_encdec``'s tree, leaf for leaf."""
    enc = {"ln1": _norm_axes(cfg),
           "attn": attn_mod.attention_axes(qkv_bias=True),
           "ln2": _norm_axes(cfg), "mlp": _mlp_axes(cfg)}
    dec = {"ln1": _norm_axes(cfg),
           "self_attn": attn_mod.attention_axes(qkv_bias=True),
           "lnx": _norm_axes(cfg),
           "cross_attn": attn_mod.attention_axes(qkv_bias=True),
           "ln2": _norm_axes(cfg), "mlp": _mlp_axes(cfg)}
    return {
        "embed": L.embedding_axes(),
        "pos_embed": ("seq", "embed"),
        "encoder": _stacked_axes(cfg.n_encoder_layers, enc),
        "enc_norm": _norm_axes(cfg),
        "decoder": _stacked_axes(cfg.n_layers, dec),
        "final_norm": _norm_axes(cfg),
    }


def encode(cfg: ModelConfig, params: dict,
           frames: torch.Tensor) -> torch.Tensor:
    """frames [B, T_src, d_model] (the stub frontend's output) ->
    memory: non-causal self-attention, no RoPE."""
    def body(x, p):
        h = _apply_norm(cfg, p["ln1"], x)
        h, _ = attn_mod.apply_attention(p["attn"], h, 0, causal=False,
                                        rope_theta=None)
        x = x + h
        h = _apply_norm(cfg, p["ln2"], x)
        return x + _apply_mlp(cfg, p["mlp"], h)

    layer = _maybe_remat(cfg, body)
    x = frames
    for p in params["encoder"]:
        x = layer(x, p)
    return _apply_norm(cfg, params["enc_norm"], x)


def _embed_dec(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
               start: int = 0) -> torch.Tensor:
    """Token embeddings (no sqrt(d) scale) plus the learned positions
    ``start ..`` (modulo the table's length, as the reference)."""
    x = L.apply_embedding(params["embed"], tokens, scale_by_sqrt_d=False)
    table = params["pos_embed"]
    pos = (start + torch.arange(tokens.shape[1], device=x.device)) % \
        table.shape[0]
    return x + table[pos][None]


def _dec_layer(cfg: ModelConfig, p: dict, x, start: int, memory=None,
               cross=None, kv=None):
    h = _apply_norm(cfg, p["ln1"], x)
    h, new_kv = attn_mod.apply_attention(p["self_attn"], h, start,
                                         rope_theta=None, cache=kv)
    x = x + h
    h = _apply_norm(cfg, p["lnx"], x)
    x = x + attn_mod.apply_cross_attention(p["cross_attn"], h, memory=memory,
                                           cross_cache=cross)
    h = _apply_norm(cfg, p["ln2"], x)
    return x + _apply_mlp(cfg, p["mlp"], h), new_kv


def forward_encdec(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                   frames: torch.Tensor) -> ForwardOutput:
    """Teacher-forced pass. tokens [B, S], frames [B, T, d]."""
    memory = encode(cfg, params, frames)
    x = _embed_dec(cfg, params, tokens)
    layer = _maybe_remat(
        cfg, lambda x, p: _dec_layer(cfg, p, x, 0, memory=memory)[0])
    for p in params["decoder"]:
        x = layer(x, p)
    x = _apply_norm(cfg, params["final_norm"], x)
    return ForwardOutput(logits=L.apply_unembed(params["embed"], x),
                         caches=None,
                         aux_loss=torch.zeros((), dtype=torch.float32,
                                              device=x.device))


# ----------------------------------------------------------------------------
# Decode
# ----------------------------------------------------------------------------

class EncDecCaches(NamedTuple):
    self_kv: list        # one KVCache per decoder layer
    cross: list          # one CrossCache per decoder layer (fixed)


def init_encdec_caches(cfg: ModelConfig, params: dict, frames: torch.Tensor,
                       batch: int, max_len: int) -> EncDecCaches:
    """Run the encoder once and precompute every layer's cross K/V."""
    memory = encode(cfg, params, frames)
    self_kv = [attn_mod.init_kv_cache(batch, max_len, cfg.n_kv, cfg.hd,
                                      cfg.torch_dtype, frames.device)
               for _ in range(cfg.n_layers)]
    cross = [attn_mod.precompute_cross_cache(p["cross_attn"], memory)
             for p in params["decoder"]]
    return EncDecCaches(self_kv=self_kv, cross=cross)


def decode_step_encdec(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                       caches: EncDecCaches, index: int) -> ForwardOutput:
    """One-token decode. tokens [B, 1]; index: the filled length. The
    self-attention caches are written in place."""
    x = _embed_dec(cfg, params, tokens, start=index)
    new_kv = []
    for p, kv, cross in zip(params["decoder"], caches.self_kv,
                            caches.cross):
        x, nk = _dec_layer(cfg, p, x, index, cross=cross,
                           kv=kv._replace(index=index))
        new_kv.append(nk)
    x = _apply_norm(cfg, params["final_norm"], x)
    return ForwardOutput(logits=L.apply_unembed(params["embed"], x),
                         caches=EncDecCaches(self_kv=new_kv,
                                             cross=caches.cross),
                         aux_loss=torch.zeros((), dtype=torch.float32,
                                              device=x.device))


def encdec_loss(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Mean next-token cross-entropy of the teacher-forced decoder:
    float32 log-softmax, masked mean over ``batch["mask"]``."""
    out = forward_encdec(cfg, params, batch["tokens"], batch["frames"])
    logp = torch.log_softmax(out.logits.float(), dim=-1)
    ll = logp.gather(-1, batch["targets"].long()[..., None])[..., 0]
    maskf = batch["mask"].float()
    return -(ll * maskf).sum() / torch.clamp(maskf.sum(), min=1.0)
