"""Move an ``LDAState`` between the JAX package and the port, as numpy.

The reference's ``LDAState`` leaves, as numpy arrays (``stats`` ``[K, V]``
or ``[K, S, V/S]`` float32, ``step`` and ``stats_version`` int32
scalars), become the port's ``LDAState`` on a device, and back. No JAX
import: the caller hands over ``np.asarray`` of each leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lda import LDAState

__all__ = ["lda_state_from_numpy", "lda_state_to_numpy"]


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
