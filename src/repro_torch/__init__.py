"""PyTorch/CUDA port of the decentralized LDA system (``repro``).

Same layout and public names as the JAX package: ``core/`` (threefry,
lda, estep, oem, evaluation, serving), ``kernels/<name>/`` (a CUDA
kernel for Hopper under ``csrc/``, its ``ops.py`` wrapper and a plain
torch ``ref.py``), ``data/``, ``checkpoint/`` and ``launch/``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise. Below the entry points the tensor's device
decides: a CUDA tensor launches the hand-written kernel (or raises), a
CPU tensor takes the kernel's plain torch version.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = "cuda"
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless CPU is asked for.

    Raises if CUDA is asked for (the default) and no GPU is present:
    nothing falls back to the CPU without the caller saying so.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA GPU and none is available; pass "
            "device='cpu' to run the plain torch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev
