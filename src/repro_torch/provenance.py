"""Provenance stamps for checkpoint sidecars, and the config digest.

The torch counterpart of ``repro.provenance``. Every checkpoint's
``meta.json`` carries :func:`provenance` (torch version, CUDA version or
None, device, git commit), so a file on disk can be traced to the tree
and build that wrote it. :func:`config_digest` is the reference's: the
first 16 hex digits of the sha256 of ``repr(config)``. The two packages'
``DeledaConfig`` reprs differ (the reference's names a jax dtype), so a
digest never matches across packages; a cross-package restore passes no
config.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

import torch

__all__ = ["provenance", "config_digest"]


def _git_commit() -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10, cwd=os.path.dirname(os.path.abspath(__file__)))
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip() or "unknown"


def provenance(device: torch.device | str | None = None) -> dict:
    """``{git_commit, torch_version, cuda_version, device}``."""
    return dict(git_commit=_git_commit(), torch_version=torch.__version__,
                cuda_version=torch.version.cuda,
                device=None if device is None else str(device))


def config_digest(config) -> str:
    """Stable short digest of a frozen config dataclass: it changes iff
    some knob does (the restore-time "same config?" warning)."""
    return hashlib.sha256(repr(config).encode()).hexdigest()[:16]
