"""npz checkpoints of named arrays, in the JAX package's format.

``<dir>/step_%08d/meta.json`` is written first, then ``state.npz``
holding one array per name, each file written to a temporary name and
renamed. A step directory counts once its ``state.npz`` exists, so a
crash mid-save leaves the previous checkpoint as the latest. The names
are the reference's ``_flatten`` keys: ``stats``, ``step`` and
``stats_version`` for an ``LDAState``; ``stats``, ``steps``, ``key``,
``t``, ``stats_version``, ``member`` and ``cursor`` for a DELEDA
``TrainState`` (``convert.train_state_to_numpy``). The port restores
what the JAX package saved, and the other way round, bit for bit.

The sidecar holds :func:`repro_torch.provenance.provenance` and the
caller's ``meta`` (a config digest, say); a restore given
``expect_config_digest`` warns when the stored digest differs.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import warnings
import zipfile

import numpy as np
import torch

from repro_torch.core.lda import LDAState
from repro_torch.provenance import provenance

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "load_meta", "stored_shapes"]

_LDA_FIELDS = ("stats", "step", "stats_version")


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


def _named(tree) -> dict:
    """An ``LDAState``'s fields, or a mapping's items, in order."""
    if isinstance(tree, LDAState):
        return {name: getattr(tree, name) for name in _LDA_FIELDS}
    return dict(tree)


def save_checkpoint(directory: str, tree, step: int,
                    meta: dict | None = None) -> str:
    """Write ``<directory>/step_<step>/state.npz``; returns its path.

    ``tree`` is an ``LDAState`` or an ordered mapping of names to arrays
    (torch tensors on any device, or numpy arrays), saved in that order.
    """
    named = _named(tree)
    device = next((x.device for x in named.values()
                   if isinstance(x, torch.Tensor)), None)
    step_dir = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(step_dir, exist_ok=True)
    blob = json.dumps(dict(provenance(device), **(meta or {})), indent=2,
                      sort_keys=True).encode()
    _write_atomic(step_dir, "meta.json", lambda f: f.write(blob))
    flat = {name: (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                   else np.asarray(x))
            for name, x in named.items()}
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


def _resolve_step(directory: str, step: int | None) -> int:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    return step


def load_meta(directory: str, step: int | None = None) -> dict | None:
    """The ``meta.json`` sidecar of a checkpoint, or None if absent."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None
    path = os.path.join(directory, f"step_{step:08d}", "meta.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def stored_shapes(directory: str, step: int | None = None
                  ) -> dict[str, tuple]:
    """The shape of each stored array, read from the npz headers alone."""
    step = _resolve_step(directory, step)
    path = os.path.join(directory, f"step_{step:08d}", "state.npz")
    readers = {(1, 0): np.lib.format.read_array_header_1_0,
               (2, 0): np.lib.format.read_array_header_2_0}
    out = {}
    with zipfile.ZipFile(path) as zf:
        for member in zf.namelist():
            with zf.open(member) as f:
                version = np.lib.format.read_magic(f)
                out[member.removesuffix(".npy")] = tuple(
                    readers[version](f)[0])
    return out


def restore_checkpoint(directory: str, like, step: int | None = None,
                       expect_config_digest: str | None = None):
    """Restore the latest (or ``step``'s) checkpoint shaped like ``like``.

    ``like`` is an ``LDAState``, whose tensors place the restored ones
    (device and dtype), or a mapping of names to expected shapes, which
    gives a dict of the stored numpy arrays. Every array's shape is
    checked; a mismatch names the key and both shapes. With
    ``expect_config_digest``, a differing stored ``config_digest`` warns
    (the restore still proceeds: harmless knobs change it too).
    """
    step = _resolve_step(directory, step)
    path = os.path.join(directory, f"step_{step:08d}", "state.npz")
    if expect_config_digest is not None:
        stored = (load_meta(directory, step) or {}).get("config_digest")
        if stored is not None and stored != expect_config_digest:
            warnings.warn(
                f"checkpoint {path} was written under config digest "
                f"{stored} but is being restored under "
                f"{expect_config_digest}; the run configurations differ",
                UserWarning, stacklevel=2)
    lda = isinstance(like, LDAState)
    shapes = ({name: tuple(getattr(like, name).shape)
               for name in _LDA_FIELDS} if lda
              else {name: tuple(s) for name, s in like.items()})
    with np.load(path) as data:
        missing = [k for k in shapes if k not in data]
        if missing:
            raise ValueError(f"checkpoint {path} does not match the restore "
                             f"structure: missing keys {missing}")
        out = {}
        for name, want in shapes.items():
            arr = data[name]
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"checkpoint {path}: stored array {name!r} has shape "
                    f"{tuple(arr.shape)} but the restore structure expects "
                    f"{want} — was this checkpoint written under a "
                    f"different config (e.g. vocab_shards)?")
            out[name] = arr
    if not lda:
        return out
    return LDAState(**{
        name: torch.from_numpy(np.array(arr)).to(
            device=getattr(like, name).device,
            dtype=getattr(like, name).dtype)
        for name, arr in out.items()})
