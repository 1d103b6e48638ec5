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
so the optimizer moves it as the reference's does.

The sharding half. ``rules_for`` picks a rule set by parameter count;
``abstract_params`` / ``abstract_caches`` / ``input_specs`` are ``meta``
tensors of the real shapes and dtypes (nothing drawn); ``params_axes``,
``opt_state_axes`` and ``caches_axes`` are their logical axes, tree for
tree. ``build(cfg, shape, mesh)`` returns a :class:`LoweredStep`: the
step, its abstract inputs, and the DTensor placements of its inputs and
outputs on the ``DeviceMesh``. PyTorch has no ``jit(...).lower()``: the
step runs eagerly on DTensors (:meth:`LoweredStep.place` then a call,
on real tensors, as a launcher runs it; on
:meth:`LoweredStep.fake_inputs`, fake DTensors of the abstract inputs,
as the dry run runs it). An op with no DTensor sharding rule
raises there. A plain tensor met inside the step is taken as replicated
(``implicit_replication``), and the hand-written attention kernel runs
on each rank's shard (``models.attention``). On a one-rank mesh every
placement is ``Replicate`` and the step computes what the plain step
computes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import encdec as ed
from repro_torch.models import frontends as fe
from repro_torch.models import mamba2 as m2
from repro_torch.models import transformer as tf
from repro_torch.models import xlstm as xl
from repro_torch.optim import make_lr_schedule, make_optimizer
from repro_torch.optim.optimizers import CHUNK, stacked_view
from repro_torch.sharding import (DP_ONLY_RULES, FSDP_RULES, LOGICAL_RULES,
                                  placements, spec_for_shape,
                                  tree_shardings_for)
from repro_torch.sharding.axes import is_axes_leaf
from repro_torch.sharding.local import is_dtensor, local_offset

__all__ = ["TrainState", "loss_fn", "value_and_grad", "grad_norm",
           "make_train_step", "make_prefill_step", "make_decode_step",
           "FSDP_PARAM_THRESHOLD", "DP_ONLY_THRESHOLD", "rules_for",
           "abstract_params", "params_axes", "opt_state_axes",
           "abstract_opt_state", "caches_axes", "input_specs",
           "abstract_caches", "state_shardings",
           "LoweredStep", "build"]

FSDP_PARAM_THRESHOLD = 8e9
DP_ONLY_THRESHOLD = 1e9     # sub-1B archs run pure data parallelism


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
    ``fn`` does not use gets zeros of its shape, dtype and device. A
    DTensor leaf's gradient is placed like the leaf (a partial sum over
    the batch shards is reduced)."""
    leaves, spec = pytree.tree_flatten(params)
    live = [x.detach().requires_grad_() for x in leaves]
    loss = fn(pytree.tree_unflatten(live, spec))
    grads = torch.autograd.grad(loss, live, allow_unused=True,
                                materialize_grads=True)
    grads = [_place_grad(g, x) if is_dtensor(g) else g
             for g, x in zip(grads, leaves)]
    return loss.detach(), pytree.tree_unflatten(grads, spec)


def _place_grad(g, x):
    """The DTensor gradient ``g`` placed like its leaf ``x``. A partial
    sum over every mesh dim of a replicated leaf (pure data parallelism)
    is reduced by one all-reduce over the flattened mesh, not one a
    mesh dim."""
    mesh = x.device_mesh
    if (mesh.ndim > 1 and all(p.is_partial() for p in g.placements)
            and all(p.is_replicate() for p in x.placements)):
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        from torch.distributed.tensor import DTensor, Replicate
        with unset_fake_temporarily():      # the mesh's own rank tensors
            flat = mesh._flatten()
        local = DTensor.from_local(g.to_local(), flat, [g.placements[0]],
                                   run_check=False).redistribute(
            flat, [Replicate()]).to_local()
        return DTensor.from_local(local, mesh, x.placements, run_check=False)
    return g.redistribute(mesh, x.placements)


def grad_norm(grads) -> torch.Tensor:
    """The global L2 norm of a gradient tree, in float32, a leaf's squares
    summed ``CHUNK`` elements at a time (a float32 copy of one arctic
    expert leaf would be 17.9 GB).

    DTensor leaves: each rank sums its own shard's chunks, in the same
    order, into one sum per set of mesh dims the leaves are split over;
    each sum is then added up over those dims. On one rank that is the
    plain sum, bit for bit."""
    sums: dict = {}
    for g in pytree.tree_leaves(grads):
        key = _split_dims(g) if is_dtensor(g) else None
        local = g._local_tensor if is_dtensor(g) else g
        for c in local.reshape(-1).split(CHUNK):
            sums[key] = sums.get(key, 0) + torch.sum(c.float() ** 2)
    total = 0
    for key, value in sums.items():
        if key is not None:
            value = _sum_over(value, *key)
        total = total + value
    return torch.sqrt(total)


def _split_dims(x) -> tuple:
    """``(mesh, mesh dims over which the DTensor x is split)``."""
    return x.device_mesh, tuple(i for i, p in enumerate(x.placements)
                                if p.is_shard() or p.is_partial())


def _sum_over(value: torch.Tensor, mesh, dims) -> torch.Tensor:
    """A per-rank partial ``value`` summed over the mesh dims ``dims``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    pl = [Partial() if i in dims else Replicate() for i in range(mesh.ndim)]
    return DTensor.from_local(value, mesh, pl, run_check=False).full_tensor()


def make_train_step(cfg: ModelConfig, lr: float = 3e-4, use=None):
    """``(train_step, opt)``: ``train_step(state, batch) -> (state,
    {"loss", "grad_norm"})``, the optimizer updating ``state`` in place.
    ``use`` maps the parameters to the ones the loss computes with (the
    sharded step's FSDP gather), inside the gradient."""
    opt = make_optimizer(cfg.optimizer, make_lr_schedule("cosine", lr))
    use = use or (lambda p: p)

    def train_step(state: TrainState, batch: dict):
        loss, grads = value_and_grad(lambda p: loss_fn(cfg, use(p), batch),
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


# ----------------------------------------------------------------------------
# Rule sets, abstract params / state / caches, and their logical axes
# ----------------------------------------------------------------------------

def rules_for(cfg: ModelConfig):
    n = cfg.n_params()
    if n < DP_ONLY_THRESHOLD:
        return DP_ONLY_RULES     # TP collectives dwarf sub-1B matmuls
    return FSDP_RULES if n > FSDP_PARAM_THRESHOLD else LOGICAL_RULES


class _MetaGenerator(torch.Generator):
    """A CPU generator whose device reads ``meta``: the init functions
    make their tensors there, and draw nothing."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


@functools.lru_cache(maxsize=4)
def abstract_params(cfg: ModelConfig):
    """The parameter tree of ``cfg`` as ``meta`` tensors (cached per
    config; do not write into it)."""
    init = ed.init_encdec if cfg.family == "encdec" else tf.init_decoder_lm
    return init(cfg, _MetaGenerator())


def params_axes(cfg: ModelConfig):
    return (ed.encdec_axes(cfg) if cfg.family == "encdec"
            else tf.decoder_lm_axes(cfg))


def _stacked_axes_view(p_axes):
    """The axes of ``stacked_view(params)``: a list of per-layer dicts
    becomes one dict whose leaves lead with "layers"."""
    if isinstance(p_axes, dict):
        return {k: _stacked_axes_view(v) for k, v in p_axes.items()}
    if isinstance(p_axes, list):
        return _map_axes(lambda a: ("layers",) + a,
                         _stacked_axes_view(p_axes[0]))
    return p_axes


def _map_axes(fn, tree):
    if is_axes_leaf(tree):
        return fn(tree)
    return {k: _map_axes(fn, v) for k, v in tree.items()}


def abstract_opt_state(cfg: ModelConfig, abs_params=None):
    """The optimizer state of ``cfg`` as ``meta`` tensors."""
    _, opt = make_train_step(cfg)
    return opt.init(abstract_params(cfg) if abs_params is None
                    else abs_params)


def opt_state_axes(cfg: ModelConfig, abs_params, p_axes):
    """Optimizer-state axes mirror the param axes of the stacked view
    (the state keeps each layer leaf stacked, as the reference's does);
    Adafactor's factored ``vr`` / ``vc`` drop a dim."""
    view = _stacked_axes_view(p_axes)
    if cfg.optimizer == "adamw":
        return {"m": view, "v": view}
    if cfg.optimizer == "sgd":
        return {"mu": view}
    if cfg.optimizer == "adafactor":
        def one(leaf, axes):
            if isinstance(leaf, dict):
                return {k: one(leaf[k], axes[k]) for k in leaf}
            if len(axes) >= 2:
                return {"vr": tuple(axes[:-1]),
                        "vc": tuple(axes[:-2]) + tuple(axes[-1:])}
            return {"v": tuple(axes)}
        return one(stacked_view(abs_params), view)
    raise ValueError(cfg.optimizer)


def caches_axes(cfg: ModelConfig):
    """Logical axes of the decode caches, tree for tree (per-layer lists
    where the reference stacks on "layers")."""
    kv = attn_mod.kv_cache_axes()
    if cfg.family in ("dense", "vlm", "moe"):
        return [kv] * cfg.n_layers
    if cfg.family == "hybrid":
        return {"mamba": [m2.mamba_cache_axes()] * cfg.n_layers,
                "attn": [kv] * (cfg.n_layers // cfg.attn_every)}
    if cfg.family == "ssm":
        ml = xl.MLSTMCache(c=("batch", "heads", "head_dim", "state"),
                           n=("batch", "heads", "head_dim"),
                           m=("batch", "heads"),
                           conv=("batch", "seq", "mlp"))
        sl = xl.SLSTMCache(c=("batch", "embed"), n=("batch", "embed"),
                           h=("batch", "embed"), m=("batch", "embed"))
        return {"mlstm": [ml] * cfg.n_layers, "slstm": [sl] * cfg.n_layers}
    if cfg.family == "encdec":
        cross = attn_mod.CrossCache(
            k=("batch", "frames", "kv_heads", "head_dim"),
            v=("batch", "frames", "kv_heads", "head_dim"))
        return ed.EncDecCaches(self_kv=[kv] * cfg.n_layers,
                               cross=[cross] * cfg.n_layers)
    raise ValueError(cfg.family)


# ----------------------------------------------------------------------------
# Input specs (abstract batches)
# ----------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """``meta`` stand-ins for every model input of this step."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    s_text = s - (cfg.n_image_tokens if cfg.family == "vlm" else 0)
    if shape.kind == "train":
        specs = {"tokens": _meta((b, s_text), i32),
                 "targets": _meta((b, s_text), i32),
                 "mask": _meta((b, s_text), torch.bool)}
    elif shape.kind == "prefill":
        specs = {"tokens": _meta((b, s_text), i32)}
    else:
        # decode: ONE new token against a cache of seq_len
        return {"tokens": _meta((b, 1), i32), "index": _meta((), i32),
                "caches": abstract_caches(cfg, b, s)}
    if cfg.family == "vlm":
        specs["image_embeds"] = fe.image_patches_spec(cfg, b)
    if cfg.family == "encdec":
        specs["frames"] = fe.audio_frames_spec(cfg, b)
    return specs


def abstract_caches(cfg: ModelConfig, batch: int, max_len: int):
    if cfg.family == "encdec":
        kv = [attn_mod.init_kv_cache(batch, max_len, cfg.n_kv, cfg.hd,
                                     cfg.torch_dtype, "meta")
              for _ in range(cfg.n_layers)]
        mem = (batch, cfg.max_source_len, cfg.n_kv, cfg.hd)
        cross = [attn_mod.CrossCache(k=_meta(mem, cfg.torch_dtype),
                                     v=_meta(mem, cfg.torch_dtype))
                 for _ in range(cfg.n_layers)]
        return ed.EncDecCaches(self_kv=kv, cross=cross)
    return tf.init_caches(cfg, batch, max_len, "meta")


# ----------------------------------------------------------------------------
# Placements
# ----------------------------------------------------------------------------

def _batch_shardings(cfg: ModelConfig, specs: dict, mesh, rules,
                     as_specs: bool = False) -> dict:
    """The placements (or specs) of every batch leaf: batch over the
    data axes, a frontend's embeddings ``("batch", "seq",
    "act_embed")``, the caches by :func:`caches_axes`, a scalar
    replicated."""
    def one(key, x):
        if key == "caches":
            return tree_shardings_for(x, caches_axes(cfg), mesh, rules,
                                      as_specs=True)
        ndim = x.dim()
        if ndim == 0:
            return ()
        axes = ("batch",) + ("seq",) * (ndim - 1)
        if key in ("image_embeds", "frames"):
            axes = ("batch", "seq", "act_embed")[:ndim]
        return spec_for_shape(tuple(x.shape), axes, mesh, rules)
    out = {k: one(k, v) for k, v in specs.items()}
    return out if as_specs else _to_placements(out, mesh)


def _is_spec_leaf(x) -> bool:
    """A leaf of a spec tree: a spec (a plain tuple of axis names,
    name tuples and ``None``), or ``None``."""
    return x is None or (type(x) is tuple and all(
        isinstance(a, (str, tuple, type(None))) for a in x))


def _to_placements(spec_tree, mesh):
    return pytree.tree_map(
        lambda x: None if x is None else placements(x, mesh), spec_tree,
        is_leaf=_is_spec_leaf)


def state_shardings(cfg: ModelConfig, mesh, rules=None,
                    as_specs: bool = False) -> TrainState:
    """Placements (or specs) of a ``TrainState``: parameters and
    optimizer state by their axes, the step replicated."""
    rules = rules or rules_for(cfg)
    abs_p = abstract_params(cfg)
    p_axes = params_axes(cfg)
    p_sh = tree_shardings_for(abs_p, p_axes, mesh, rules, as_specs)
    o_sh = tree_shardings_for(abstract_opt_state(cfg, abs_p),
                              opt_state_axes(cfg, abs_p, p_axes), mesh,
                              rules, as_specs)
    return TrainState(params=p_sh, opt=o_sh, step=None)


def _place_leaf(x, pl, mesh, fake: bool):
    """One leaf on ``mesh``: a real tensor distributed (every rank holds
    the same global value; on a one-rank mesh the DTensor is the tensor
    itself), a ``meta`` one as a DTensor of fake local shards (under the
    caller's ``FakeTensorMode``); anything else as it is."""
    if not isinstance(x, torch.Tensor) or pl is None:
        return x
    from torch.distributed.tensor import DTensor, distribute_tensor
    if not fake and mesh.size() == 1:
        # one rank: the DTensor shares the tensor's storage (no copy)
        return DTensor.from_local(x, mesh, pl, run_check=False)
    if not fake:
        return distribute_tensor(x, mesh, pl)
    local_shape, _ = local_offset(None, pl, x.shape, mesh)
    local = torch.empty(local_shape, dtype=x.dtype)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=x.shape, stride=x.stride())


def _is_pl_leaf(x) -> bool:
    """A leaf of a placements tree: a tuple of placements, or ``None``."""
    return x is None or (type(x) is tuple
                         and all(hasattr(a, "is_shard") for a in x))


def _zip_placements(fn, tree, pl_tree):
    """``fn(leaf, placements)`` over ``tree``, matched to ``pl_tree`` by
    dict key (``tree`` may hold a subset of the keys), named-tuple field
    and list position."""
    if _is_pl_leaf(pl_tree):
        return fn(tree, pl_tree)
    if isinstance(tree, dict):
        return {k: _zip_placements(fn, v, pl_tree[k])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_zip_placements(fn, t, p) for t, p in zip(tree, pl_tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return tree


def _place(tree, pl_tree, mesh, fake: bool = False):
    return _zip_placements(lambda x, p: _place_leaf(x, p, mesh, fake),
                           tree, pl_tree)


def _gathered(params, mesh, rules):
    """The parameters as the step computes with them: a leaf sharded over
    the batch's mesh dims (FSDP: "embed" over "data") gathered over them
    (ZeRO-3: the gradient comes back reduce-scattered), every other
    placement kept."""
    from torch.distributed.tensor import Replicate
    batch_axes = dict(rules).get("batch") or ()
    batch_axes = (batch_axes,) if isinstance(batch_axes, str) else batch_axes
    names = list(mesh.mesh_dim_names)
    data_dims = {names.index(a) for a in batch_axes if a in names}

    def one(x):
        if not is_dtensor(x) or not any(
                x.placements[i].is_shard() for i in data_dims):
            return x
        return x.redistribute(mesh, [Replicate() if i in data_dims else p
                                     for i, p in enumerate(x.placements)])
    return pytree.tree_map(one, params)


@contextlib.contextmanager
def _sharded(mesh, rules, constrain_acts: bool):
    """Plain tensors taken as replicated, and (``constrain_acts``) the
    activation-sharding context, around a step on DTensors."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.sharding.ctx import activation_sharding
    with contextlib.ExitStack() as stack:
        stack.enter_context(implicit_replication())
        if constrain_acts:
            stack.enter_context(activation_sharding(mesh, rules))
        yield


def _full(x):
    return x.full_tensor() if is_dtensor(x) else x


def _redistribute(tree, pl_tree, mesh):
    """Every DTensor of ``tree`` moved to its placement in ``pl_tree``."""
    return _zip_placements(
        lambda x, p: x.redistribute(mesh, p) if is_dtensor(x) and p else x,
        tree, pl_tree)


@dataclasses.dataclass
class LoweredStep:
    """A step bound to a mesh: the counterpart of the reference's jitted
    step with its in / out shardings. ``fn`` runs on DTensors placed by
    ``in_placements`` and returns outputs placed by ``out_placements``
    (metrics and scalars as plain tensors, the same on every rank)."""

    kind: str
    fn: Callable
    abstract_inputs: tuple
    in_placements: tuple
    out_placements: Any
    mesh: Any
    shape: InputShape

    def place(self, *inputs):
        """Real inputs (every rank the same global values) as DTensors."""
        return tuple(_place(x, p, self.mesh)
                     for x, p in zip(inputs, self.in_placements))

    def __call__(self, *placed):
        return self.fn(*placed)

    def fake_inputs(self):
        """The abstract inputs as DTensors of fake local shards (call
        under a ``FakeTensorMode``). A decode step's index is the cache's
        last slot, where every key is visible, as the reference's masked
        einsum counts them."""
        out = tuple(_place(x, p, self.mesh, fake=True)
                    for x, p in zip(self.abstract_inputs,
                                    self.in_placements))
        if self.kind == "decode":
            out[1]["index"] = self.shape.seq_len - 1
        return out


def build(cfg: ModelConfig, shape: InputShape, mesh, rules=None,
          constrain_acts: bool = True) -> LoweredStep:
    """Assemble the step for (arch x input-shape) on the ``DeviceMesh``.

    ``constrain_acts`` installs the activation-sharding context
    (``repro_torch.sharding.ctx``) around the step: today only
    attention's query-sequence constraint (``attn_chunk_q``) reads it."""
    rules = rules or rules_for(cfg)
    specs = input_specs(cfg, shape)
    batch_pl = _batch_shardings(cfg, specs, mesh, rules)
    abs_p = abstract_params(cfg)
    p_pl = tree_shardings_for(abs_p, params_axes(cfg), mesh, rules)
    logits_pl = placements(spec_for_shape(
        (shape.global_batch, cfg.vocab_size), ("batch", "vocab"), mesh,
        rules), mesh)

    if shape.kind == "train":
        train_step, opt = make_train_step(
            cfg, use=lambda p: _gathered(p, mesh, rules))
        st_pl = state_shardings(cfg, mesh, rules)
        abs_state = TrainState(params=abs_p,
                               opt=abstract_opt_state(cfg, abs_p), step=0)

        def step(state: TrainState, batch: dict):
            with _sharded(mesh, rules, constrain_acts):
                new, metrics = train_step(state, batch)
            return new, {k: _full(v) for k, v in metrics.items()}

        return LoweredStep("train", step, (abs_state, specs),
                           (st_pl, batch_pl),
                           (st_pl, {"loss": None, "grad_norm": None}),
                           mesh, shape)

    if shape.kind == "prefill":
        prefill = make_prefill_step(cfg)

        def step(params, batch: dict):
            with _sharded(mesh, rules, constrain_acts):
                out = prefill(_gathered(params, mesh, rules), batch)
                return out.redistribute(mesh, logits_pl)

        return LoweredStep("prefill", step, (abs_p, specs),
                           (p_pl, batch_pl), logits_pl, mesh, shape)

    decode = make_decode_step(cfg)
    cache_pl = batch_pl["caches"]

    def step(params, batch: dict):
        with _sharded(mesh, rules, constrain_acts):
            logits, caches = decode(_gathered(params, mesh, rules), batch)
            return (logits.redistribute(mesh, logits_pl),
                    _redistribute(caches, cache_pl, mesh))

    return LoweredStep("decode", step, (abs_p, specs), (p_pl, batch_pl),
                       (logits_pl, cache_pl), mesh, shape)
