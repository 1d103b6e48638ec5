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

On DTensors (``launch.steps.build``) the routed experts run expert
parallel: each rank routes its own tokens and runs the experts it holds,
the ranks' outputs summing to the whole; the aux loss and entropy are
taken from the routing sums over all tokens. Under a ``FakeTensorMode``
(the dry run) the ragged group sizes are unknown and the rows are taken
as spread evenly over the experts.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from repro_torch.models.layers import (apply_mlp, init_mlp, mlp_axes,
                                       trunc_normal)
from repro_torch.sharding.local import (is_dtensor, like, local_offset,
                                       placed)

__all__ = ["MoEOutput", "init_moe", "moe_axes", "apply_moe", "capacity"]


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
    if out.is_meta:                 # abstract parameters: nothing to draw
        return out
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


def moe_axes(shared: bool = False, dense: bool = False) -> dict:
    a = {
        "router": ("embed", "experts"),
        "w_gate": ("experts", "embed", "expert_mlp"),
        "w_up": ("experts", "embed", "expert_mlp"),
        "w_down": ("experts", "expert_mlp", "embed"),
    }
    if shared:
        a["shared"] = mlp_axes()
    if dense:
        a["dense"] = mlp_axes()
    return a


def capacity(t: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots an expert has for ``t`` tokens: the reference's
    ``capacity_factor * T * k / E``, at least 1, up to a multiple of 8."""
    cap = max(int(capacity_factor * t * top_k / n_experts), 1)
    return -(-cap // 8) * 8


def _expert_ffn(xs, w_gate, w_up, w_down):
    return (F.silu(xs @ w_gate) * (xs @ w_up)) @ w_down


def _routed(p: dict, flat: torch.Tensor, top_k: int, impl: str,
            capacity_factor: float, e0: int = 0):
    """The routed experts on tokens ``flat`` [T, d]: ``(y [T, d], probs
    [T, E], expert_flat [T*k])``. ``p``'s expert leaves may hold a slice
    of the experts, global ids ``e0 ..``; the others' rows add nothing
    to ``y`` (expert parallelism: the ranks' ``y`` sum to the whole)."""
    t, d = flat.shape
    n_experts = p["router"].shape[1]
    n_local = p["w_gate"].shape[0]
    logits = flat.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)                     # [T, E]
    top_p, top_i = torch.topk(probs, top_k, dim=-1)           # [T, k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # ---- sort (token, slot) assignments by expert id
    expert_flat = top_i.reshape(-1)                           # [T*k]
    order = torch.argsort(expert_flat, stable=True)
    token_of = order // top_k                                 # source token
    expert_sorted = expert_flat[order]
    group_sizes = torch.zeros(n_experts, dtype=torch.long,
                              device=flat.device).index_add_(
        0, expert_flat, torch.ones_like(expert_flat))

    if impl == "ragged" and is_fake(flat):
        # the dry run: group sizes are unknown, so the rows are taken as
        # spread evenly over the experts (the same products in all)
        xs = flat[token_of]
        ys = torch.zeros_like(xs)
        per = max(1, xs.shape[0] // n_experts)
        rows = min(n_local * per, xs.shape[0])
        per = rows // n_local
        ys[:n_local * per] = _expert_ffn(
            xs[:n_local * per].reshape(n_local, per, d), p["w_gate"],
            p["w_up"], p["w_down"]).reshape(-1, d)
    elif impl == "ragged":
        xs = flat[token_of]
        ys = torch.empty_like(xs) if n_local == n_experts \
            else torch.zeros_like(xs)
        start = 0
        for e, n in enumerate(group_sizes.tolist()):
            if n and e0 <= e < e0 + n_local:
                ys[start:start + n] = _expert_ffn(
                    xs[start:start + n], p["w_gate"][e - e0],
                    p["w_up"][e - e0], p["w_down"][e - e0])
            start += n
    elif impl == "capacity":
        cap = capacity(t, top_k, n_experts, capacity_factor)
        offsets = torch.cumsum(group_sizes, 0) - group_sizes  # [E] starts
        pos_in_group = (torch.arange(t * top_k, device=flat.device)
                        - offsets[expert_sorted])
        keep = pos_in_group < cap
        dest = torch.where(keep, expert_sorted * cap + pos_in_group,
                           n_experts * cap)                   # drop slot
        xe = torch.zeros((n_experts * cap + 1, d), dtype=flat.dtype,
                         device=flat.device)
        xe[dest] = flat[token_of]
        xe = xe[:-1].reshape(n_experts, cap, d)               # [E, cap, d]
        ye = _expert_ffn(xe[e0:e0 + n_local], p["w_gate"], p["w_up"],
                         p["w_down"])
        if n_local != n_experts:
            ye = torch.zeros_like(xe).index_copy_(
                0, torch.arange(e0, e0 + n_local, device=flat.device), ye)
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
    return y, probs, expert_flat


def _counts(expert_flat: torch.Tensor, n_experts: int) -> torch.Tensor:
    return torch.zeros(n_experts, dtype=torch.float32,
                       device=expert_flat.device).index_add_(
        0, expert_flat, torch.ones(expert_flat.shape[0],
                                   device=expert_flat.device))


def _routed_sharded(p: dict, x: torch.Tensor, top_k: int, impl: str,
                    capacity_factor: float):
    """:func:`_routed` on DTensors, expert parallel: each rank routes
    its batch shard's tokens (the router gathered) and runs the experts
    it holds (sharded over "experts", gathered over any other mesh
    dim); ``y`` is the ranks' partial sum over the expert dims. The
    routing statistics come back as sums over the rank's tokens (partial
    over the batch dims), for the aux loss and entropy of all tokens."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    batch = [pl == Shard(0) for pl in x.placements]
    experts = [pl == Shard(0) and not b
               for pl, b in zip(p["w_gate"].placements, batch)]
    pa = tuple(Shard(0) if b else Replicate() for b in batch)
    pr = (Replicate(),) * mesh.ndim
    pe = tuple(Shard(0) if e else Replicate() for e in experts)
    # a rank's gradient of x and of the router covers its own experts
    # (and its own tokens): a partial sum over those mesh dims
    grad_x = tuple(Partial() if e else pl for e, pl in zip(experts, pa))
    grad_r = tuple(Partial() if b or e else Replicate()
                   for b, e in zip(batch, experts))
    grad_e = tuple(Partial() if b else pl for b, pl in zip(batch, pe))
    xl_ = placed(x, pa).to_local(grad_placements=grad_x)
    router = placed(p["router"], pr).to_local(grad_placements=grad_r)
    w = {k: placed(p[k], pe).to_local(grad_placements=grad_e)
         for k in ("w_gate", "w_up", "w_down")}
    e0 = local_offset(p["w_gate"], pe)[1][0]
    b, s, d = xl_.shape
    y, probs, expert_flat = _routed(dict(w, router=router),
                                    xl_.reshape(-1, d), top_k, impl,
                                    capacity_factor, e0)
    n_experts = probs.shape[1]
    py = tuple(Shard(0) if bb else (Partial() if e else Replicate())
               for bb, e in zip(batch, experts))
    # the routing sums are the same on every rank of an expert dim: the
    # first rank gives them, the others zeros, so that their gradient
    # into the router is a partial sum over those dims like y's
    ps = tuple(Partial() if bb or e else Replicate()
               for bb, e in zip(batch, experts))
    coord = mesh.get_coordinate()
    first = float(all(coord[i] == 0 for i, e in enumerate(experts) if e))

    def wrap(t, pl):
        return DTensor.from_local(t, mesh, pl, run_check=False)

    ent = -(probs * torch.log(probs + 1e-9)).sum()
    return (wrap(y.reshape(b, s, d), py),
            wrap(_counts(expert_flat, n_experts) * first, ps),
            wrap(probs.sum(0) * first, ps), wrap(ent * first, ps))


def apply_moe(p: dict, x: torch.Tensor, top_k: int, impl: str = "ragged",
              capacity_factor: float = 1.25) -> MoEOutput:
    """x [B, S, d] -> MoEOutput (see the module docstring for ``impl``).
    On DTensors the routed experts run expert parallel
    (:func:`_routed_sharded`)."""
    b, s, d = x.shape
    n_experts = p["router"].shape[1]
    t = b * s
    if is_dtensor(x):
        y, counts, prob_sum, ent_sum = _routed_sharded(
            p, x, top_k, impl, capacity_factor)
        frac_routed = counts / (t * top_k)
        mean_prob = prob_sum / t
        entropy = ent_sum / t
    else:
        y, probs, expert_flat = _routed(p, x.reshape(-1, d), top_k, impl,
                                        capacity_factor)
        # ---- switch-style load-balance aux loss + router entropy
        frac_routed = _counts(expert_flat, n_experts) / (t * top_k)
        mean_prob = probs.mean(0)
        entropy = -(probs * torch.log(probs + 1e-9)).sum(-1).mean()
    aux = n_experts * (frac_routed * mean_prob).sum()
    out = y.reshape(b, s, d).to(x.dtype)
    if "shared" in p:
        out = out + apply_mlp(p["shared"], x)
    if "dense" in p:
        out = out + apply_mlp(p["dense"], x)
    return MoEOutput(y=like(out, x), aux_loss=aux, router_entropy=entropy)
