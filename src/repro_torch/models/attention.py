"""Grouped-query attention with RoPE, KV cache, window, softcap, cross-attn.

The port's copy of the JAX package's ``models/attention.py``: GQA with
any (n_heads, n_kv), an optional QKV bias (qwen2, whisper), the logit
softcap (gemma2), a per-layer sliding window, causal or not (whisper's
encoder), the KV cache of decode, and cross-attention over encoder
memory with its precomputed K/V (whisper's decoder). Where the reference
scores queries against keys with XLA einsums, every branch here calls
``kernels.flash_attention``: the hand-written kernel on the card, its
plain version on the CPU. The projections stay ``torch.matmul``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import apply_rope, trunc_normal

__all__ = ["KVCache", "init_kv_cache", "init_attention", "apply_attention",
           "CrossCache", "precompute_cross_cache", "apply_cross_attention"]


class KVCache(NamedTuple):
    k: torch.Tensor      # [B, S_max, H_kv, head_dim]
    v: torch.Tensor      # [B, S_max, H_kv, head_dim]
    index: int           # number of filled positions


def init_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                  dtype, device) -> KVCache:
    shape = (batch, max_len, n_kv, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   index=0)


def init_attention(gen: torch.Generator, d: int, n_heads: int, n_kv: int,
                   head_dim: int, dtype, qkv_bias: bool = False) -> dict:
    p = {
        "wq": trunc_normal(gen, (d, n_heads, head_dim), dtype, fan_in=d),
        "wk": trunc_normal(gen, (d, n_kv, head_dim), dtype, fan_in=d),
        "wv": trunc_normal(gen, (d, n_kv, head_dim), dtype, fan_in=d),
        "wo": trunc_normal(gen, (n_heads, head_dim, d), dtype,
                           fan_in=n_heads * head_dim),
    }
    if qkv_bias:
        for name, heads in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros((heads, head_dim), dtype=dtype,
                                  device=gen.device)
    return p


def _project(p: dict, x: torch.Tensor):
    def proj(w):
        return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])
    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def apply_attention(p: dict, x: torch.Tensor, start: int, *,
                    causal: bool = True, window: Optional[int] = None,
                    cap: Optional[float] = None,
                    rope_theta: Optional[float] = 10000.0,
                    query_scale: Optional[float] = None,
                    cache: Optional[KVCache] = None,
                    ) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Self-attention. x [B, S, d]; every row's queries sit at absolute
    positions ``start .. start + S - 1``.

    The reference takes per-row positions [B, S]; its callers give every
    row the same ones (``forward`` from 0, ``decode_step`` from the cache
    index), and the port passes that start. ``causal=False`` (whisper's
    encoder) lets every query see every key; no caller asks for it with
    a cache, and the port refuses that (the kernel would see the unfilled
    cache past the query, which only the causal mask hides).

    Without a cache: the full sequence (prefill), ``q_offset = 0``. With
    a cache: this segment's K/V are written at ``cache.index`` in place
    (the reference returns a new cache, a copy of 3 MB a layer a step at
    gemma2-2b, B=4, S_max=192) and the queries attend over the filled
    prefix, ``q_offset = cache.index``. The reference's ``chunk_q`` has
    no counterpart: the kernel never builds the [S, S] scores, and the
    result is the same.
    """
    q, k, v = _project(p, x)
    b, s = x.shape[:2]
    head_dim = q.shape[-1]
    scale = query_scale if query_scale is not None else head_dim ** -0.5
    if rope_theta is not None:
        positions = torch.arange(start, start + s,
                                 device=x.device).expand(b, s)
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)

    if cache is None:
        out = flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                        softcap=cap, scale=scale, q_offset=0)
        new_cache = None
    else:
        if not causal:
            raise ValueError("apply_attention: a cache needs causal=True")
        assert start == cache.index, "rows sit at the cache index"
        idx = cache.index
        cache.k[:, idx:idx + s] = k.to(cache.k.dtype)
        cache.v[:, idx:idx + s] = v.to(cache.v.dtype)
        new_cache = KVCache(k=cache.k, v=cache.v, index=idx + s)
        # the causal mask hides the unfilled cache past the query
        out = flash_ops.flash_attention(q, cache.k, cache.v, window=window,
                                        softcap=cap, scale=scale,
                                        q_offset=idx)
    o = out.reshape(b, s, -1) @ p["wo"].reshape(-1, p["wo"].shape[-1])
    return o, new_cache


# ----------------------------------------------------------------------------
# Cross-attention (whisper decoder over encoder memory)
# ----------------------------------------------------------------------------

class CrossCache(NamedTuple):
    k: torch.Tensor   # [B, T_mem, H_kv, head_dim] precomputed from memory
    v: torch.Tensor


def precompute_cross_cache(p: dict, memory: torch.Tensor) -> CrossCache:
    """The memory's keys and values (with the bias where there is one),
    computed once per utterance."""
    def proj(w):
        return (memory @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])
    k, v = proj(p["wk"]), proj(p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return CrossCache(k=k, v=v)


def apply_cross_attention(p: dict, x: torch.Tensor,
                          memory: Optional[torch.Tensor] = None,
                          cross_cache: Optional[CrossCache] = None
                          ) -> torch.Tensor:
    """x [B, S, d] queries against memory [B, T, d] (or its precomputed
    ``CrossCache``): one non-causal ``flash_attention`` launch, ``S``
    queries against ``T`` keys at ``q_offset`` 0, no window, no softcap,
    the scale ``head_dim ** -0.5``.

    The reference's ``mem_mask`` (a [B, T] key mask) is left out: no
    caller passes one, and the kernel takes a causal limit and a window,
    not a mask of keys, so it could not honour it.
    """
    q = (x @ p["wq"].reshape(p["wq"].shape[0], -1)).unflatten(
        -1, p["wq"].shape[1:])
    if "bq" in p:
        q = q + p["bq"]
    if cross_cache is None:
        cross_cache = precompute_cross_cache(p, memory)
    b, s = x.shape[:2]
    out = flash_ops.flash_attention(q, cross_cache.k, cross_cache.v,
                                    causal=False, scale=q.shape[-1] ** -0.5,
                                    q_offset=0)
    return out.reshape(b, s, -1) @ p["wo"].reshape(-1, p["wo"].shape[-1])
