"""Step builders: train_step, prefill_step and decode_step of every LM family.

The port's copy of the step functions of ``repro.launch.steps``:
``TrainState``, ``loss_fn`` (``encdec_loss`` for the encoder-decoder,
``lm_loss`` for the rest), ``make_train_step`` (the cosine schedule and
the ``grad_norm`` metric), ``make_prefill_step`` and
``make_decode_step`` (a vlm's ``image_embeds``, an encoder-decoder's
``frames`` and caches). PyTorch runs eagerly, so a step is a plain
function; the gradient is ``torch.autograd.grad`` of the loss with
respect to every parameter leaf (:func:`value_and_grad`). A leaf the
loss does not use (the ssm family's idle block: the reference runs both
blocks of a layer and keeps one with ``jnp.where``, the port runs the
selected one) gets a zero gradient, as ``jax.value_and_grad`` gives it,
so the optimizer moves it as the reference's does. The
reference's sharding and lowering half (``rules_for``, the abstract
params and caches, their logical axes, ``input_specs``,
``state_shardings``, ``LoweredStep`` and ``build``) waits for the
sharding / dry-run slice of the port.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tf
from repro_torch.optim import make_lr_schedule, make_optimizer
from repro_torch.optim.optimizers import CHUNK

__all__ = ["TrainState", "loss_fn", "value_and_grad", "grad_norm",
           "make_train_step", "make_prefill_step", "make_decode_step"]


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: int


def loss_fn(cfg: ModelConfig, params, batch) -> torch.Tensor:
    if cfg.family == "encdec":
        return ed.encdec_loss(cfg, params, batch)
    return tf.lm_loss(cfg, params, batch)


def value_and_grad(fn, params) -> tuple[torch.Tensor, Any]:
    """``fn(params)`` and its gradient with respect to every leaf of
    ``params``, a tree of the same structure. The leaves are used through
    detached copies that share their storage, so ``params`` itself stays
    out of any graph and an optimizer may update it in place. A leaf that
    ``fn`` does not use gets zeros of its shape, dtype and device."""
    leaves, spec = pytree.tree_flatten(params)
    live = [x.detach().requires_grad_() for x in leaves]
    loss = fn(pytree.tree_unflatten(live, spec))
    grads = torch.autograd.grad(loss, live, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), pytree.tree_unflatten(list(grads), spec)


def grad_norm(grads) -> torch.Tensor:
    """The global L2 norm of a gradient tree, in float32, a leaf's squares
    summed ``CHUNK`` elements at a time (a float32 copy of one arctic
    expert leaf would be 17.9 GB)."""
    return torch.sqrt(sum(torch.sum(c.float() ** 2)
                          for g in pytree.tree_leaves(grads)
                          for c in g.reshape(-1).split(CHUNK)))


def make_train_step(cfg: ModelConfig, lr: float = 3e-4):
    """``(train_step, opt)``: ``train_step(state, batch) -> (state,
    {"loss", "grad_norm"})``, the optimizer updating ``state`` in place."""
    opt = make_optimizer(cfg.optimizer, make_lr_schedule("cosine", lr))

    def train_step(state: TrainState, batch: dict):
        loss, grads = value_and_grad(lambda p: loss_fn(cfg, p, batch),
                                     state.params)
        metrics = {"loss": loss, "grad_norm": grad_norm(grads)}
        new_params, new_opt = opt.update(grads, state.opt, state.params,
                                         state.step)
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step, opt


def make_prefill_step(cfg: ModelConfig):
    @torch.no_grad()
    def prefill_step(params, batch: dict):
        if cfg.family == "encdec":
            out = ed.forward_encdec(cfg, params, batch["tokens"],
                                    batch["frames"])
        else:
            out = tf.forward(cfg, params, batch["tokens"],
                             image_embeds=batch.get("image_embeds"))
        return out.logits[:, -1]

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    @torch.no_grad()
    def decode_fn(params, batch: dict):
        step = (ed.decode_step_encdec if cfg.family == "encdec"
                else tf.decode_step)
        out = step(cfg, params, batch["tokens"], batch["caches"],
                   int(batch["index"]))
        return out.logits[:, 0], out.caches

    return decode_fn
