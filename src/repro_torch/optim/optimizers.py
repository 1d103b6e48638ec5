"""Functional optimizers (adamw / adafactor / sgd) over parameter dicts.

The port's copy of ``repro.optim.optimizers``: ``Optimizer(init,
update)`` pairs with float32 state, ``update(grads, state, params, step)
-> (new_params, new_state)`` with each leaf's new value cast back to its
dtype, and the reference's arithmetic in its order.

Layout. The reference's parameters hold every layer leaf stacked over
the layers (``[L, ...]``); the port's hold a list of per-layer dicts
under ``"layers"`` (``models/transformer.py``). The optimizers work on
:func:`stacked_view` of the tree, where each layer leaf is the list of
its L per-layer tensors, and keep their state stacked (one float32
``[L, ...]`` tensor a leaf, the reference's state leaf for leaf, so a
checkpoint carries it as it is). AdamW and SGD are elementwise: they
update each layer's slice (a view of the stacked state) in chunks of
``CHUNK`` elements, which bounds their float32 temporaries. Adafactor is
not: it factors the second moment of a stacked leaf over its last two
axes (a ``[L, d]`` norm scale over (L, d)) and clips by the RMS of the
whole stacked leaf. Where a layer's tensor is itself a matrix (or a
stack of them, an expert leaf ``[E, d, f]``), the factors belong to each
matrix, so it updates the leaf in two passes over pieces of whole
matrices, at most ``CHUNK`` elements a piece where a matrix is smaller:
the first updates the factors and sums the squared update, the second
writes it clipped by the RMS of the whole leaf. A leaf of at most
``CHUNK`` elements keeps its update from the first pass; a larger one
computes it again a piece at a time, so its float32 temporaries are a
piece's, not the leaf's (a float32 copy of one arctic expert leaf is
17.9 GB). Only the order of the RMS's sum differs from one stacked
reduction. A ``[L, d]`` stack of vectors is one piece, stacked; a
vector leaf (unfactored) is stacked for the update.

In place. ``update`` writes the new values into the given parameter and
state tensors and returns those same trees (the reference returns new
ones; at gemma2-2b a second AdamW state would be 21 GB). The gradients
are read only.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

__all__ = ["Optimizer", "sgd", "adamw", "adafactor", "make_optimizer",
           "stacked_view", "CHUNK"]

CHUNK = 1 << 24     # elements of one elementwise update (64 MB in float32)


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], tuple[Any, Any]]
    # update(grads, state, params, step) -> (new_params, new_state)


def stacked_view(tree):
    """``tree`` with every list of per-layer dicts turned into one dict
    whose leaves are lists of the per-layer tensors (no copy)."""
    if isinstance(tree, dict):
        return {k: stacked_view(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if tree and isinstance(tree[0], dict):
            return {k: stacked_view([d[k] for d in tree]) for k in tree[0]}
        return list(tree)
    return tree


def _map_leaves(fn, tree, *others):
    """``fn(leaf, *other_nodes)`` at every leaf of ``tree`` (a tensor or a
    list of per-layer tensors); the other trees are walked in parallel
    by ``tree``'s keys."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    return fn(tree, *others)


def _shape(leaf) -> tuple:
    if isinstance(leaf, list):
        return (len(leaf), *leaf[0].shape)
    return tuple(leaf.shape)


def _device(leaf) -> torch.device:
    return (leaf[0] if isinstance(leaf, list) else leaf).device


def _zeros(leaf, shape=None) -> torch.Tensor:
    return torch.zeros(_shape(leaf) if shape is None else shape,
                       dtype=torch.float32, device=_device(leaf))


def _stack(leaf) -> torch.Tensor:
    return torch.stack(leaf) if isinstance(leaf, list) else leaf


def _write(leaf, value: torch.Tensor) -> None:
    """Store a stacked float32 value into the leaf, in each leaf's dtype."""
    if isinstance(leaf, list):
        for i, t in enumerate(leaf):
            t.copy_(value[i])
    else:
        leaf.copy_(value)


def _pieces(p, g, *state):
    """Aligned flat chunks of a parameter leaf, its gradient and its
    stacked state tensors: layer by layer, ``CHUNK`` elements at a time."""
    if isinstance(p, list):
        items = [(p[i], g[i], *(s[i] for s in state))
                 for i in range(len(p))]
    else:
        items = [(p, g, *state)]
    for param, grad, *rest in items:
        flat = [param.view(-1), grad.reshape(-1)] + [s.view(-1)
                                                     for s in rest]
        n = flat[0].numel()
        for a in range(0, n, CHUNK):
            yield tuple(f[a:a + CHUNK] for f in flat)


def _leaf_matrices(leaf) -> bool:
    """Whether each matrix of the stacked leaf is a layer's own (its
    last two axes are not the layer axis)."""
    return not isinstance(leaf, list) or leaf[0].dim() >= 2


def _matrix_pieces(p, g, vr, vc):
    """Aligned pieces ``(param, grad, vr, vc)`` of a factored leaf whose
    matrices are each a layer's own: ``[m, r, c]`` views of ``m`` whole
    matrices (``m`` the most that fit in ``CHUNK`` elements, at least
    one), with their ``[m, r]`` / ``[m, c]`` factors, layer by layer."""
    if isinstance(p, list):
        items = [(p[i], g[i], vr[i], vc[i]) for i in range(len(p))]
    else:
        items = [(p, g, vr, vc)]
    for param, grad, r_, c_ in items:
        rows, cols = param.shape[-2:]
        pm = param.view(-1, rows, cols)
        gm = grad.reshape(-1, rows, cols)
        rm, cm = r_.view(-1, rows), c_.view(-1, cols)
        m = max(1, CHUNK // (rows * cols))
        for a in range(0, pm.shape[0], m):
            yield pm[a:a + m], gm[a:a + m], rm[a:a + m], cm[a:a + m]


def _factored_pieces(p, g, vr, vc):
    """The pieces of a factored leaf: ``_matrix_pieces`` where each
    matrix is a layer's own; else (a ``[L, d]`` stack of vectors, the
    layer axis one of the matrix's) the stacked leaf as one piece, a copy
    that the update writes back."""
    if _leaf_matrices(p):
        yield from _matrix_pieces(p, g, vr, vc)
    else:
        yield _stack(p), _stack(g), vr, vc


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).detach().cpu().to(torch.float32)


def sgd(lr_fn, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"mu": _map_leaves(_zeros, stacked_view(params))}

    def update(grads, state, params, step):
        lr = float(lr_fn(step))

        def upd(p, g, mu):
            for pc, gc, mc in _pieces(p, g, mu):
                mc.mul_(momentum).add_(gc.float())
                pc.copy_(pc.float() - lr * mc)

        _map_leaves(upd, stacked_view(params), stacked_view(grads),
                    state["mu"])
        return params, state

    return Optimizer(init, update)


def adamw(lr_fn, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        view = stacked_view(params)
        return {"m": _map_leaves(_zeros, view),
                "v": _map_leaves(_zeros, view)}

    def update(grads, state, params, step):
        t = _f32(step) + 1.0
        lr = float(lr_fn(step))
        bc1 = float(1.0 - b1 ** t)
        bc2 = float(1.0 - b2 ** t)

        def upd(p, g, m, v):
            for pc, gc, mc, vc in _pieces(p, g, m, v):
                gc = gc.float()
                mc.mul_(b1).add_((1 - b1) * gc)
                vc.mul_(b2).add_((1 - b2) * gc * gc)
                step_ = (mc / bc1) / (torch.sqrt(vc / bc2) + eps)
                p32 = pc.float()
                pc.copy_(p32 - lr * (step_ + weight_decay * p32))

        _map_leaves(upd, stacked_view(params), stacked_view(grads),
                    state["m"], state["v"])
        return params, state

    return Optimizer(init, update)


def adafactor(lr_fn, eps: float = 1e-30, clip_threshold: float = 1.0,
              decay_pow: float = 0.8, weight_decay: float = 0.0
              ) -> Optimizer:
    """Factored second moment: O(r+c) state for matrices, O(n) for vectors.

    The rank test and the RMS clip see the stacked leaf, as the
    reference's do (module docstring)."""

    def _factored(shape) -> bool:
        return len(shape) >= 2

    def init(params):
        def one(leaf):
            shape = _shape(leaf)
            if _factored(shape):
                return {"vr": _zeros(leaf, shape[:-1]),
                        "vc": _zeros(leaf, shape[:-2] + shape[-1:])}
            return {"v": _zeros(leaf)}
        return _map_leaves(one, stacked_view(params))

    def update(grads, state, params, step):
        t = _f32(step) + 1.0
        beta2_t = 1.0 - t ** (-decay_pow)
        beta2, one_minus = float(beta2_t), float(1 - beta2_t)
        lr = float(lr_fn(step))

        def factored_u(g, vr, vc):
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp(vr.mean(-1)[..., None, None], min=eps))
            return g * torch.rsqrt(denom + eps)

        def clip_scale(sum_sq, n):
            rms = torch.sqrt((sum_sq / n).float() + eps)
            return torch.clamp(rms / clip_threshold, min=1.0)

        def upd_factored(p, g, s):
            pieces = list(_factored_pieces(p, g, s["vr"], s["vc"]))
            keep = math.prod(_shape(p)) <= CHUNK
            n, sum_sq, kept = 0, 0.0, []
            for _pc, gc, rc, cc in pieces:
                g32 = gc.float()
                g2 = g32 * g32 + eps
                rc.copy_(beta2 * rc + one_minus * g2.mean(-1))
                cc.copy_(beta2 * cc + one_minus * g2.mean(-2))
                u = factored_u(g32, rc, cc)
                sum_sq = sum_sq + (u * u).sum(dtype=torch.float64)
                n += u.numel()
                kept.append(u if keep else None)
            scale = clip_scale(sum_sq, n)
            for (pc, gc, rc, cc), u in zip(pieces, kept):
                if u is None:
                    u = factored_u(gc.float(), rc, cc)
                p32 = pc.float()
                pc.copy_(p32 - lr * (u / scale + weight_decay * p32))
            if not _leaf_matrices(p):
                _write(p, pieces[0][0])

        def upd(p, g, s):
            if _factored(_shape(p)):
                return upd_factored(p, g, s)
            g = _stack(g).float()
            v = beta2 * s["v"] + one_minus * (g * g + eps)
            u = g * torch.rsqrt(v + eps)
            s["v"].copy_(v)
            u = u / clip_scale(torch.sum(u * u), u.numel())
            p32 = _stack(p).float()
            _write(p, p32 - lr * (u + weight_decay * p32))

        _map_leaves(upd, stacked_view(params), stacked_view(grads), state)
        return params, state

    return Optimizer(init, update)


def make_optimizer(kind: str, lr_fn) -> Optimizer:
    if kind == "adamw":
        return adamw(lr_fn)
    if kind == "adafactor":
        return adafactor(lr_fn)
    if kind == "sgd":
        return sgd(lr_fn)
    raise ValueError(f"unknown optimizer {kind!r}")
