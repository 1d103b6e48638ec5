"""Mixture-of-Experts block: top-k router and the expert FFN.

The port's copy of the JAX package's ``models/moe.py``, which covers both
MoE archs: kimi-k2 (384 experts, top-8, one shared expert, a leading
dense layer) and arctic (128 experts, top-2, a parallel dense residual
MLP). Softmax router in float32, top-k renormalised among the chosen
experts; the (token, slot) assignments sorted by expert (a stable sort);
the switch-style load-balance aux loss and the router entropy.

The reference computes the expert products outside any Pallas kernel,
and so does the port, with ``torch.matmul``:

- ``impl="ragged"``: the reference's ``ragged_dot`` over the contiguous
  groups is a loop over the non-empty groups here, each group's rows
  times its expert's weights (no token is dropped);
- ``impl="capacity"``: the reference's Switch/GShard static dispatch,
  sorted tokens scattered into ``[E, capacity, d]`` blocks, the expert
  FFN as one batched product over all experts, tokens past an expert's
  capacity dropped.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import apply_mlp, init_mlp, trunc_normal

__all__ = ["MoEOutput", "init_moe", "apply_moe", "capacity"]


class MoEOutput(NamedTuple):
    y: torch.Tensor               # [B, S, d]
    aux_loss: torch.Tensor        # scalar load-balance loss
    router_entropy: torch.Tensor


def _expert_weights(gen: torch.Generator, shape, dtype,
                    fan_in: int) -> torch.Tensor:
    """``[E, ...]`` expert weights drawn one expert at a time (the same
    law as one draw; its float32 scratch is one expert's, not 2x the
    whole stack, which at kimi's 384 experts is 22 GB a leaf)."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for e in range(shape[0]):
        out[e] = trunc_normal(gen, shape[1:], dtype, fan_in=fan_in)
    return out


def init_moe(gen: torch.Generator, d: int, n_experts: int, d_ff: int,
             top_k: int, dtype, shared_d_ff: int = 0,
             dense_d_ff: int = 0) -> dict:
    del top_k
    p = {
        "router": trunc_normal(gen, (d, n_experts), torch.float32,
                               fan_in=d),
        "w_gate": _expert_weights(gen, (n_experts, d, d_ff), dtype, d),
        "w_up": _expert_weights(gen, (n_experts, d, d_ff), dtype, d),
        "w_down": _expert_weights(gen, (n_experts, d_ff, d), dtype, d_ff),
    }
    if shared_d_ff:
        p["shared"] = init_mlp(gen, d, shared_d_ff, dtype)
    if dense_d_ff:
        p["dense"] = init_mlp(gen, d, dense_d_ff, dtype)
    return p


def capacity(t: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots an expert has for ``t`` tokens: the reference's
    ``capacity_factor * T * k / E``, at least 1, up to a multiple of 8."""
    cap = max(int(capacity_factor * t * top_k / n_experts), 1)
    return -(-cap // 8) * 8


def _expert_ffn(xs, w_gate, w_up, w_down):
    return (F.silu(xs @ w_gate) * (xs @ w_up)) @ w_down


def apply_moe(p: dict, x: torch.Tensor, top_k: int, impl: str = "ragged",
              capacity_factor: float = 1.25) -> MoEOutput:
    """x [B, S, d] -> MoEOutput (see the module docstring for ``impl``)."""
    b, s, d = x.shape
    n_experts = p["router"].shape[1]
    flat = x.reshape(-1, d)                                   # [T, d]
    t = flat.shape[0]

    logits = flat.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)                     # [T, E]
    top_p, top_i = torch.topk(probs, top_k, dim=-1)           # [T, k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # ---- sort (token, slot) assignments by expert id
    expert_flat = top_i.reshape(-1)                           # [T*k]
    order = torch.argsort(expert_flat, stable=True)
    token_of = order // top_k                                 # source token
    expert_sorted = expert_flat[order]
    group_sizes = torch.bincount(expert_flat, minlength=n_experts)

    if impl == "ragged":
        xs = flat[token_of]
        ys = torch.empty_like(xs)
        start = 0
        for e, n in enumerate(group_sizes.tolist()):
            if n:
                ys[start:start + n] = _expert_ffn(
                    xs[start:start + n], p["w_gate"][e], p["w_up"][e],
                    p["w_down"][e])
            start += n
    elif impl == "capacity":
        cap = capacity(t, top_k, n_experts, capacity_factor)
        offsets = torch.cumsum(group_sizes, 0) - group_sizes  # [E] starts
        pos_in_group = (torch.arange(t * top_k, device=x.device)
                        - offsets[expert_sorted])
        keep = pos_in_group < cap
        dest = torch.where(keep, expert_sorted * cap + pos_in_group,
                           n_experts * cap)                   # drop slot
        xe = torch.zeros((n_experts * cap + 1, d), dtype=x.dtype,
                         device=x.device)
        xe[dest] = flat[token_of]
        xe = xe[:-1].reshape(n_experts, cap, d)               # [E, cap, d]
        ye = _expert_ffn(xe, p["w_gate"], p["w_up"], p["w_down"])
        ys = torch.cat([ye.reshape(n_experts * cap, d),
                        ye.new_zeros((1, d))])[dest]
        ys = torch.where(keep[:, None], ys, 0.0)              # [T*k, d]
    else:
        raise ValueError(f"unknown moe impl {impl!r}")

    # ---- unsort and combine with router weights
    y_slots = torch.empty_like(ys)
    y_slots[order] = ys
    y = (y_slots.reshape(t, top_k, d)
         * top_p[..., None].to(ys.dtype)).sum(1)              # [T, d]

    # ---- switch-style load-balance aux loss + router entropy
    frac_routed = torch.zeros(n_experts, dtype=torch.float32,
                              device=x.device).index_add_(
        0, expert_flat, torch.ones(t * top_k, device=x.device)) / (t * top_k)
    mean_prob = probs.mean(0)
    aux = n_experts * (frac_routed * mean_prob).sum()
    entropy = -(probs * torch.log(probs + 1e-9)).sum(-1).mean()

    out = y.reshape(b, s, d).to(x.dtype)
    if "shared" in p:
        out = out + apply_mlp(p["shared"], x)
    if "dense" in p:
        out = out + apply_mlp(p["dense"], x)
    return MoEOutput(y=out, aux_loss=aux, router_entropy=entropy)
