"""Move state between the JAX package and the port, as numpy.

The reference's ``LDAState`` leaves, as numpy arrays (``stats`` ``[K, V]``
or ``[K, S, V/S]`` float32, ``step`` and ``stats_version`` int32
scalars), become the port's ``LDAState`` on a device, and back. A DELEDA
``TrainState`` travels in the reference's npz layout (``stats`` float32
``[n, K, V]`` or ``[n, K, S, V/S]``, ``steps`` int32 ``[n]``, ``key``
uint32 ``[2]``, int32 scalars ``t``, ``stats_version`` and ``cursor``,
``member`` bool ``[n]``). The reference's decoder-LM parameters
of every decoder family (``init_decoder_lm``'s pytree: ``layers`` and
kimi's ``dense_layers`` stacked on axis 0, zamba2's ``shared_attn``
unstacked, ``router`` float32) and of the encoder-decoder
(``init_encdec``'s: ``encoder`` and ``decoder`` stacked) become the
port's (a list of per-layer dicts for each stack), and back. The LM
trainer's state (params, the optimizer's stacked state, step) travels
as the reference's npz arrays: each key the ``/``-joined path of the
reference's tree (``embed/table``, ``layers/attn/wq``; ``params/...``,
``opt/m/...`` and ``step`` for a ``TrainState``), the layers stacked on
axis 0, and a bfloat16 leaf stored as uint16 under its key plus
``.__bf16__``, as the reference's checkpoint writes it. No JAX import:
the caller hands over ``np.asarray`` of each leaf (a bfloat16 one as
``ml_dtypes.bfloat16``, which is imported only where such a leaf is
asked for).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import deleda
from repro_torch.core.lda import LDAState

__all__ = ["lda_state_from_numpy", "lda_state_to_numpy",
           "train_state_to_numpy", "train_state_from_numpy",
           "decoder_lm_from_numpy", "decoder_lm_to_numpy",
           "encdec_from_numpy", "encdec_to_numpy",
           "lm_params_to_flat", "lm_params_from_flat",
           "lm_train_state_to_numpy", "lm_train_state_from_numpy"]

BF16_MARK = ".__bf16__"
# the reference's layer stacks (one array a leaf, layers on axis 0)
STACKS = ("layers", "dense_layers", "encoder", "decoder")


def lda_state_from_numpy(arrays: dict, device: str | torch.device = "cpu"
                         ) -> LDAState:
    """``{"stats", "step", "stats_version"}`` numpy arrays -> LDAState."""
    def tensor(name, dtype):
        return torch.from_numpy(np.array(arrays[name], dtype=dtype)).to(
            device)

    version = (arrays["stats_version"] if "stats_version" in arrays
               else np.zeros((), np.int32))
    return LDAState(stats=tensor("stats", np.float32),
                    step=tensor("step", np.int32),
                    stats_version=torch.from_numpy(
                        np.array(version, dtype=np.int32)).to(device))


def lda_state_to_numpy(state: LDAState) -> dict[str, np.ndarray]:
    """The port's LDAState as the reference's numpy leaves."""
    return {"stats": state.stats.detach().cpu().numpy(),
            "step": state.step.detach().cpu().numpy().astype(np.int32),
            "stats_version": state.stats_version.detach().cpu().numpy()
            .astype(np.int32)}


def train_state_to_numpy(state: "deleda.TrainState"
                         ) -> dict[str, np.ndarray]:
    """A port ``TrainState`` as the reference's npz arrays, in its order.

    The port's key words (int64) are written as uint32, the bits both of
    the reference's key flavours store.
    """
    def host(x, dtype):
        return x.detach().cpu().numpy().astype(dtype, copy=False)

    return {"stats": host(state.stats, np.float32),
            "steps": host(state.steps, np.int32),
            "key": host(state.key, np.uint32),
            "t": np.asarray(state.t, np.int32),
            "stats_version": np.asarray(state.stats_version, np.int32),
            "member": host(state.member, np.bool_),
            "cursor": np.asarray(state.cursor, np.int32)}


def train_state_from_numpy(arrays: dict,
                           device: str | torch.device = "cpu"
                           ) -> "deleda.TrainState":
    """The reference's npz arrays (either key flavour) as a port
    ``TrainState`` on ``device``; host ints for the scalars."""
    def tensor(name, dtype):
        return torch.from_numpy(
            np.asarray(arrays[name], dtype=dtype)).to(device)

    return deleda.TrainState(
        stats=tensor("stats", np.float32), steps=tensor("steps", np.int32),
        key=tensor("key", np.int64), t=int(arrays["t"]),
        stats_version=int(arrays["stats_version"]),
        member=tensor("member", np.bool_), cursor=int(arrays["cursor"]))


def decoder_lm_from_numpy(tree: dict, device: str | torch.device = "cpu"
                          ) -> dict:
    """The reference's decoder-LM params (any family) as the port's.

    ``tree`` is the reference's ``init_decoder_lm`` pytree with numpy
    leaves; each of its stacks (``layers``, ``dense_layers``) holds each
    leaf of all its layers on axis 0 and becomes one dict per layer.
    Leaves keep their dtype.
    """
    def nest(node):
        if isinstance(node, dict):
            return {k: nest(v) for k, v in node.items()}
        return _tensor(np.array(node), device)

    return _unstack_layers(nest(tree))


def _tensor(x: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``; ml_dtypes' bfloat16 (the
    reference's numpy bf16) through its uint16 bits."""
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(x).to(device)


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (bf16 as its uint16 bits)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


def _stack_layers(tree: dict) -> dict:
    """Host copies of ``tree``'s leaves, its list of per-layer dicts
    stacked into one dict of ``[L, ...]`` arrays; bf16 as uint16 bits,
    with the set of their paths."""
    from repro_torch.optim.optimizers import stacked_view

    marks = set()

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        leaf = node if isinstance(node, list) else [node]
        if leaf[0].dtype == torch.bfloat16:
            marks.add(path)
        arrs = [_host(t) for t in leaf]
        return np.stack(arrs) if isinstance(node, list) else arrs[0]

    return walk(stacked_view(tree), ()), marks


def decoder_lm_to_numpy(params: dict) -> dict:
    """The port's decoder-LM params (any family) as the reference's
    pytree of numpy arrays: every stack's leaves stacked on axis 0, in
    their dtype (a bfloat16 leaf as ``ml_dtypes.bfloat16``)."""
    tree, marks = _stack_layers(params)
    if marks:
        import ml_dtypes

        def as_bf16(node, path):
            if isinstance(node, dict):
                return {k: as_bf16(v, path + (k,)) for k, v in node.items()}
            return node.view(ml_dtypes.bfloat16) if path in marks else node
        tree = as_bf16(tree, ())
    return tree


def _flat(tree: dict, marks: set, prefix: tuple = ()) -> dict:
    out = {}
    for k, v in tree.items():
        path = prefix + (k,)
        if isinstance(v, dict):
            out.update(_flat(v, marks, path))
        else:
            key = "/".join(map(str, path))
            out[key + BF16_MARK if path in marks else key] = v
    return out


def _nested(flat: dict, device) -> dict:
    """Flat npz arrays back to a nested dict of tensors on ``device``."""
    out: dict = {}
    for key, arr in flat.items():
        bf16 = key.endswith(BF16_MARK)
        parts = key.removesuffix(BF16_MARK).split("/")
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        arr = np.asarray(arr)
        t = torch.from_numpy(arr.view(np.int16) if bf16 else arr.copy())
        node[parts[-1]] = (t.view(torch.bfloat16) if bf16 else t).to(device)
    return out


def _unstack_layers(tree: dict) -> dict:
    """Each stacked subtree of ``STACKS`` as the port's list of per-layer
    dicts (views of the stacked tensors)."""
    def count(node):
        return (count(next(iter(node.values()))) if isinstance(node, dict)
                else node.shape[0])

    def pick(node, i):
        return ({k: pick(v, i) for k, v in node.items()}
                if isinstance(node, dict) else node[i])

    out = dict(tree)
    for key in STACKS:
        if key in tree:
            out[key] = [pick(tree[key], i) for i in range(count(tree[key]))]
    return out


def encdec_from_numpy(tree: dict, device: str | torch.device = "cpu"
                      ) -> dict:
    """The reference's ``init_encdec`` params as the port's: ``encoder``
    and ``decoder`` (``self_attn``, ``cross_attn``) each a list of
    per-layer dicts; ``embed``, ``pos_embed``, ``enc_norm`` and
    ``final_norm`` as they are."""
    return decoder_lm_from_numpy(tree, device)


def encdec_to_numpy(params: dict) -> dict:
    """The port's encoder-decoder params as the reference's pytree of
    numpy arrays (each stack's leaves on axis 0)."""
    return decoder_lm_to_numpy(params)


def lm_params_to_flat(params: dict) -> dict[str, np.ndarray]:
    """The port's LM params as the npz arrays of the reference's
    ``save_checkpoint(dir, params, step)``."""
    tree, marks = _stack_layers(params)
    return _flat(tree, marks)


def lm_params_from_flat(flat: dict, device: str | torch.device = "cpu"
                        ) -> dict:
    """The reference's (or the port's) LM params checkpoint arrays as the
    port's params on ``device``."""
    return _unstack_layers(_nested(flat, device))


def lm_train_state_to_numpy(state) -> dict[str, np.ndarray]:
    """A port LM ``TrainState(params, opt, step)`` as the npz arrays of the
    reference's ``TrainState``: ``params/...`` (layers stacked),
    ``opt/...`` (already stacked) and ``step`` (int32)."""
    params, pmarks = _stack_layers(state.params)
    opt, omarks = _stack_layers(state.opt)
    marks = ({("params",) + p for p in pmarks}
             | {("opt",) + p for p in omarks})
    flat = _flat({"params": params, "opt": opt}, marks)
    flat["step"] = np.asarray(state.step, np.int32)
    return flat


def lm_train_state_from_numpy(arrays: dict,
                              device: str | torch.device = "cpu"):
    """The reference's LM ``TrainState`` npz arrays as the port's, on
    ``device``: params with their per-layer list, the optimizer state
    stacked, the step a host int."""
    from repro_torch.launch.steps import TrainState

    tree = _nested({k: v for k, v in arrays.items() if k != "step"}, device)
    return TrainState(params=_unstack_layers(tree["params"]),
                      opt=tree["opt"], step=int(arrays["step"]))
