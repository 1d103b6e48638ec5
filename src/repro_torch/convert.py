"""Move state between the JAX package and the port, as numpy.

The reference's ``LDAState`` leaves, as numpy arrays (``stats`` ``[K, V]``
or ``[K, S, V/S]`` float32, ``step`` and ``stats_version`` int32
scalars), become the port's ``LDAState`` on a device, and back. A DELEDA
``TrainState`` travels in the reference's npz layout (``stats`` float32
``[n, K, V]`` or ``[n, K, S, V/S]``, ``steps`` int32 ``[n]``, ``key``
uint32 ``[2]``, int32 scalars ``t``, ``stats_version`` and ``cursor``,
``member`` bool ``[n]``). The reference's decoder-LM parameters
(``init_decoder_lm``'s pytree, layers stacked on axis 0) become the
port's (a list of per-layer dicts). No JAX import: the caller hands over
``np.asarray`` of each leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import deleda
from repro_torch.core.lda import LDAState

__all__ = ["lda_state_from_numpy", "lda_state_to_numpy",
           "train_state_to_numpy", "train_state_from_numpy",
           "decoder_lm_from_numpy"]


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
    """The reference's dense decoder-LM params as the port's.

    ``tree`` is the reference's ``init_decoder_lm`` pytree with numpy
    leaves; ``tree["layers"]`` holds each leaf of all layers stacked on
    axis 0 and becomes one dict per layer. Leaves keep their dtype.
    """
    def leaf(x):
        return torch.from_numpy(np.array(x)).to(device)

    def nest(node, fn):
        if isinstance(node, dict):
            return {k: nest(v, fn) for k, v in node.items()}
        return fn(node)

    out = {k: nest(v, leaf) for k, v in tree.items() if k != "layers"}
    n_layers = len(tree["layers"]["ln1"]["scale"])
    out["layers"] = [nest(tree["layers"], lambda x, i=i: leaf(x[i]))
                     for i in range(n_layers)]
    return out
