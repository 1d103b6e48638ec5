"""Activation-sharding context: lets model code place intermediates
without threading a mesh through every call.

The port's copy of ``repro.sharding.ctx``. ``launch.steps.build``
installs the ``(mesh, rules)`` context around a step; ``constrain(x,
axes)`` then redistributes the DTensor ``x`` to the shape-aware spec of
its logical axes, and is a no-op when no context is active (CPU tests,
the simulation substrate) or ``x`` is a plain tensor. Today the one
caller is attention's query-sequence constraint (``attn_chunk_q``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from repro_torch.sharding.axes import (LOGICAL_RULES, Rules, placements,
                                       spec_for_shape)

__all__ = ["current", "activation_sharding", "constrain"]

_STATE = threading.local()


def current() -> Optional[tuple[object, Rules]]:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def activation_sharding(mesh, rules: Rules = LOGICAL_RULES):
    prev = current()
    _STATE.ctx = (mesh, rules)
    try:
        yield
    finally:
        _STATE.ctx = prev


def constrain(x: torch.Tensor, axes: tuple[str, ...]) -> torch.Tensor:
    """Place activation ``x`` by its logical axes; no-op without a
    context or for a plain tensor."""
    from torch.distributed.tensor import DTensor
    ctx = current()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    spec = spec_for_shape(tuple(x.shape), axes, mesh, rules)
    return x.redistribute(mesh, placements(spec, mesh))
