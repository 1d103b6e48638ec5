"""Grouped-query attention with RoPE, KV cache, window, softcap, cross-attn.

The port's copy of the JAX package's ``models/attention.py``: GQA with
any (n_heads, n_kv), an optional QKV bias (qwen2, whisper), the logit
softcap (gemma2), a per-layer sliding window, causal or not (whisper's
encoder), the KV cache of decode, and cross-attention over encoder
memory with its precomputed K/V (whisper's decoder). Where the reference
scores queries against keys with XLA einsums, every branch here calls
``kernels.flash_attention``: the hand-written kernel on the card, its
plain version on the CPU. The projections stay ``torch.matmul``.

On DTensors (``launch.steps.build`` over a ``DeviceMesh``) the kernel,
which has no sharding rule, runs on each rank's shard through
``local_map`` (:func:`_attend_sharded`): the placements are read off
``q`` (batch over its mesh dims, heads where they divide, query rows
under the ``qseq`` constraint), and ``k`` / ``v`` follow or are gathered.
A KV cache held as a DTensor is written on each rank's own rows
(:func:`_write_cache`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import apply_rope, trunc_normal
from repro_torch.sharding.ctx import constrain
from repro_torch.sharding.local import (is_dtensor, like, local_offset,
                                       placed)

__all__ = ["KVCache", "init_kv_cache", "kv_cache_axes", "init_attention",
           "attention_axes", "apply_attention", "CrossCache",
           "precompute_cross_cache", "apply_cross_attention"]


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


def kv_cache_axes() -> KVCache:
    """Logical axes of a ``KVCache``; its int ``index`` has none."""
    return KVCache(k=("batch", "cache_seq", "kv_heads", "head_dim"),
                   v=("batch", "cache_seq", "kv_heads", "head_dim"),
                   index=())


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


def attention_axes(qkv_bias: bool = False) -> dict:
    a = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }
    if qkv_bias:
        a["bq"] = ("heads", "head_dim")
        a["bk"] = ("kv_heads", "head_dim")
        a["bv"] = ("kv_heads", "head_dim")
    return a


def _project(p: dict, x: torch.Tensor):
    def proj(w):
        return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])
    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _attend_sharded(q, k, v, **kw) -> torch.Tensor:
    """``flash_attention`` on DTensors, one launch a rank on its shard.

    Per mesh dim, from ``q``'s placement: batch-sharded, every operand
    keeps it; heads-sharded (the rules put heads on one mesh dim), ``k``
    / ``v`` shard their heads too when those divide, or are gathered and
    sliced to the local heads' KV heads when those heads map onto whole
    KV heads (else everything is gathered); query rows sharded (the
    ``qseq`` constraint), ``k`` / ``v`` are gathered and the rank's first
    row is added to ``q_offset``; anything else is gathered. Where ``k``
    / ``v`` are gathered but ``q`` is split, each rank's gradient of them
    is a partial sum (``in_grad_placements``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    h, hkv = q.shape[2], k.shape[2]
    group = h // hkv
    pq, pkv, gkv = [], [], []
    slice_heads = False
    for i, pl in enumerate(q.placements):
        n = mesh.size(i)
        if pl == Shard(0):
            pq.append(pl), pkv.append(pl), gkv.append(pl)
        elif pl == Shard(2) and hkv % n == 0:
            pq.append(pl), pkv.append(pl), gkv.append(pl)
        elif pl == Shard(2) and ((h // n) % group == 0
                                 or group % (h // n) == 0):
            pq.append(pl), pkv.append(Replicate()), gkv.append(Partial())
            slice_heads = True
        elif pl == Shard(1):
            pq.append(pl), pkv.append(Replicate()), gkv.append(Partial())
        else:
            pq.append(Replicate()), pkv.append(Replicate())
            gkv.append(Replicate())
    shape, offset = local_offset(q, pq)
    q_offset = kw.pop("q_offset") + offset[1]
    kv = slice(None)
    if slice_heads:         # the local query heads' KV heads
        kv = slice(offset[2] // group, (offset[2] + shape[2] - 1) // group + 1)

    def local(ql, kl, vl):
        return flash_ops.flash_attention(ql, kl[:, :, kv], vl[:, :, kv],
                                         q_offset=q_offset, **kw)

    pq, pkv, gkv = tuple(pq), tuple(pkv), tuple(gkv)
    if any(p.is_partial() for p in gkv):
        # reduce the ranks' partial gradients of k and v right here, into
        # k and v's own placements
        k, v = _GradPlacedLike.apply(k), _GradPlacedLike.apply(v)
    return local_map(local, out_placements=(pq,), in_placements=(pq, pkv, pkv),
                     in_grad_placements=(pq, gkv, gkv), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


class _GradPlacedLike(torch.autograd.Function):
    """The identity on a DTensor; its gradient placed like the input."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(grad.device_mesh, ctx.placements)


def _attend(q, k, v, **kw) -> torch.Tensor:
    if is_dtensor(q):
        return _attend_sharded(q, k, v, **kw)
    return flash_ops.flash_attention(q, k, v, **kw)


def _write_cache(cache: torch.Tensor, new: torch.Tensor, idx: int) -> None:
    """``cache[:, idx:idx + s] = new`` in place. A DTensor cache (rows
    over a mesh dim when its KV heads do not divide: "cache_seq") is
    written on each rank's own rows, ``new`` placed like the cache but
    whole along the rows."""
    if not is_dtensor(cache):
        cache[:, idx:idx + new.shape[1]] = new.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if p == Shard(1) else p for p in cache.placements]
    new = new.to(cache.dtype).redistribute(cache.device_mesh, pl)
    shape, offset = local_offset(cache)
    lo, s = offset[1], new.shape[1]
    a, e = max(idx, lo), min(idx + s, lo + shape[1])
    if a < e:
        cache._local_tensor[:, a - lo:e - lo] = \
            new._local_tensor[:, a - idx:e - idx]


def apply_attention(p: dict, x: torch.Tensor, start: int, *,
                    causal: bool = True, window: Optional[int] = None,
                    cap: Optional[float] = None,
                    rope_theta: Optional[float] = 10000.0,
                    query_scale: Optional[float] = None,
                    cache: Optional[KVCache] = None,
                    chunk_q: int = 0,
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
    prefix, ``q_offset = cache.index``.

    ``chunk_q``: the reference scores query blocks of ``chunk_q`` rows
    so that the [S, S] scores never exist, each block constrained to
    ``("batch", "qseq", "heads", "head_dim")``. The kernel never builds
    them either, so there are no blocks here; under an activation-
    sharding context (``launch.steps.build``) the queries and the output
    take the same constraint whole, and each rank's launch covers its
    query rows (``q_offset`` its first row). Outside a context it is a
    no-op, as in the reference.
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
        chunked = chunk_q and s > chunk_q and s % chunk_q == 0
        if chunked:
            heads = q.placements if is_dtensor(q) else None
            q = constrain(q, ("batch", "qseq", "heads", "head_dim"))
        out = _attend(q, k, v, causal=causal, window=window, softcap=cap,
                      scale=scale, q_offset=0)
        if chunked:
            out = constrain(out, ("batch", "qseq", "heads", "head_dim"))
            if heads is not None:       # whole rows again for the projection
                out = placed(out, heads)
        new_cache = None
    else:
        if not causal:
            raise ValueError("apply_attention: a cache needs causal=True")
        assert start == cache.index, "rows sit at the cache index"
        idx = cache.index
        _write_cache(cache.k, k, idx)
        _write_cache(cache.v, v, idx)
        new_cache = KVCache(k=cache.k, v=cache.v, index=idx + s)
        # the causal mask hides the unfilled cache past the query
        out = _attend(q, cache.k, cache.v, window=window, softcap=cap,
                      scale=scale, q_offset=idx)
    o = out.reshape(b, s, -1) @ p["wo"].reshape(-1, p["wo"].shape[-1])
    return like(o, x), new_cache


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
    out = _attend(q, cross_cache.k, cross_cache.v, causal=False,
                  scale=q.shape[-1] ** -0.5, q_offset=0)
    o = out.reshape(b, s, -1) @ p["wo"].reshape(-1, p["wo"].shape[-1])
    return like(o, x)
