"""Wrapper of the lda_sparse CUDA kernel, dispatched by the tensor's device.

A CUDA tensor launches ``csrc/lda_sparse.cu`` (or raises); a CPU tensor
runs the plain version in ``ref.py``. ``launches`` counts kernel
launches and nothing else; ``launches_by_shape`` counts them by
``(B, U, K, S)``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common
from repro_torch.kernels.lda_sparse.ref import sparse_sweeps_ref

__all__ = ["sparse_sweeps", "launches", "launches_by_shape", "MAX_TOPICS"]

MAX_TOPICS = 128       # a slot's topic is kept as uint8 in shared memory
launches = 0
launches_by_shape: dict[tuple, int] = {}


def _launch(beta_w, countf, uniforms, z0, alpha, n_sweeps, burnin):
    global launches
    b, u, k = beta_w.shape
    if k > MAX_TOPICS:
        raise ValueError(f"lda_sparse: K={k} > {MAX_TOPICS} topics")
    if uniforms.shape != (n_sweeps, b, u):
        raise ValueError(f"lda_sparse: uniforms must be [{n_sweeps}, {b}, "
                         f"{u}], got {tuple(uniforms.shape)}")
    if (countf.shape != (b, u) or z0.shape != (b, u)
            or beta_w.dtype != torch.float32):
        raise ValueError("lda_sparse: want float32 beta_w [B, U, K] and "
                         "countf, z0 [B, U]")
    countf = countf.to(torch.float32).contiguous()
    uniforms = uniforms.to(torch.float32).contiguous()
    z0 = z0.to(torch.int32).contiguous()
    beta_w = beta_w.contiguous()
    common.require_cuda("lda_sparse", beta_w, countf, uniforms, z0)
    per_unique = torch.empty_like(beta_w)
    m = torch.empty_like(beta_w)
    ndk_mean = torch.empty((b, k), dtype=torch.float32, device=beta_w.device)
    if b == 0:
        return per_unique, m, ndk_mean
    sms = torch.cuda.get_device_properties(beta_w.device).multi_processor_count
    docs_per_block = min(32, -(-b // sms))
    if 3 * k * docs_per_block * 4 + u * docs_per_block > 227 * 1024:
        raise ValueError(f"lda_sparse: too much shared memory at U={u}, "
                         f"K={k}")
    lib = common.load("lda_sparse")
    ptr = ctypes.c_void_p
    with torch.cuda.device(beta_w.device):
        err = lib.lda_sparse_sweeps(
            ptr(beta_w.data_ptr()), ptr(countf.data_ptr()),
            ptr(uniforms.data_ptr()), ptr(z0.data_ptr()),
            ptr(per_unique.data_ptr()), ptr(m.data_ptr()),
            ptr(ndk_mean.data_ptr()), ctypes.c_int(b), ctypes.c_int(u),
            ctypes.c_int(k), ctypes.c_int(n_sweeps), ctypes.c_int(burnin),
            ctypes.c_float(alpha), ctypes.c_int(docs_per_block),
            ptr(common.stream_ptr()))
    common.check(err, "lda_sparse")
    launches += 1
    shape = (b, u, k, n_sweeps)
    launches_by_shape[shape] = launches_by_shape.get(shape, 0) + 1
    return per_unique, m, ndk_mean


def sparse_sweeps(beta_w: torch.Tensor, countf: torch.Tensor,
                  uniforms: torch.Tensor, z0: torch.Tensor, *, alpha: float,
                  n_sweeps: int, burnin: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """S count-weighted sweeps: (per_unique [B,U,K], m [B,U,K], ndk_mean).

    beta_w ``[B, U, K]`` float32 (K <= 128 on the card), countf
    ``[B, U]`` (0 on padding slots), uniforms ``[S, B, U]``, z0
    ``[B, U]``; any B.
    """
    if not 0 <= burnin < n_sweeps:
        raise ValueError(f"need 0 <= burnin < n_sweeps, got {burnin} / "
                         f"{n_sweeps}")
    if beta_w.device.type == "cpu":
        return sparse_sweeps_ref(beta_w, countf, uniforms, z0, alpha=alpha,
                                 n_sweeps=n_sweeps, burnin=burnin)
    return _launch(beta_w, countf, uniforms, z0, float(alpha), n_sweeps,
                   burnin)
