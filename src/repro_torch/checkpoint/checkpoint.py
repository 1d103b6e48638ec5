"""npz checkpoints of an ``LDAState``, in the JAX package's format.

``<dir>/step_%08d/meta.json`` is written first, then ``state.npz``
holding the arrays ``stats``, ``step`` and ``stats_version`` (the keys
the reference's ``_flatten`` gives an ``LDAState``), each file written
to a temporary name and renamed. A step directory counts once its
``state.npz`` exists, so a crash mid-save leaves the previous checkpoint
as the latest. The port restores what the JAX package saved, and the
other way round, bit for bit.
"""

from __future__ import annotations

import json
import os
import re
import tempfile

import numpy as np
import torch

from repro_torch.core.lda import LDAState

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_FIELDS = ("stats", "step", "stats_version")


def _write_atomic(step_dir: str, name: str, write_fn) -> str:
    fd, tmp = tempfile.mkstemp(dir=step_dir, suffix=f".{name}.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            write_fn(f)
        final = os.path.join(step_dir, name)
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return final




def save_checkpoint(directory: str, state: LDAState, step: int,
                    meta: dict | None = None) -> str:
    """Write ``<directory>/step_<step>/state.npz``; returns its path."""
    step_dir = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(step_dir, exist_ok=True)
    stamp = {"torch_version": torch.__version__,
             "device": str(state.stats.device)}
    blob = json.dumps(dict(stamp, **(meta or {})), indent=2,
                      sort_keys=True).encode()
    _write_atomic(step_dir, "meta.json", lambda f: f.write(blob))
    flat = {name: getattr(state, name).detach().cpu().numpy()
            for name in _FIELDS}
    return _write_atomic(step_dir, "state.npz",
                         lambda f: np.savez(f, **flat))


def latest_step(directory: str) -> int | None:
    """Largest committed step (its ``state.npz`` landed), or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))
             and os.path.exists(os.path.join(directory, d, "state.npz"))]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, like: LDAState,
                       step: int | None = None) -> LDAState:
    """Restore an ``LDAState`` shaped and placed like ``like``.

    Every array's shape is checked against ``like``'s; a mismatch names
    the key and both shapes.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}", "state.npz")
    with np.load(path) as data:
        missing = [k for k in _FIELDS if k not in data]
        if missing:
            raise ValueError(f"checkpoint {path} does not hold an LDAState:"
                             f" missing keys {missing}")
        leaves = {}
        for name in _FIELDS:
            ref = getattr(like, name)
            arr = data[name]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(
                    f"checkpoint {path}: stored array {name!r} has shape "
                    f"{tuple(arr.shape)} but the restore structure expects "
                    f"{tuple(ref.shape)} — was this checkpoint written "
                    f"under a different config (e.g. vocab_shards)?")
            leaves[name] = torch.from_numpy(np.array(arr)).to(
                device=ref.device, dtype=ref.dtype)
    return LDAState(**leaves)
