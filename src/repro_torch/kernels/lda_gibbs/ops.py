"""Wrapper of the lda_gibbs CUDA kernel, dispatched by the tensor's device.

A CUDA tensor launches ``csrc/lda_gibbs.cu`` (or raises); a CPU tensor
runs the plain version in ``ref.py``. ``launches`` counts kernel
launches and nothing else; ``launches_by_shape`` counts them by
``(B, L, K, S)``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common
from repro_torch.kernels.lda_gibbs.ref import gibbs_sweeps_ref

__all__ = ["gibbs_sweeps", "launches", "launches_by_shape", "MAX_TOPICS"]

# a warp per document (kernels/csrc/gibbs_warp.cuh): 32 lanes own 4
# topics each, and topics are kept as uint8; shared memory limits the
# document's length (about 33,000 positions), not K
MAX_TOPICS = 128
# the C entry point's return when one warp's rows do not fit a block's
# shared memory (gibbs_warp::kTooLong)
_TOO_LONG = -1
launches = 0
launches_by_shape: dict[tuple, int] = {}


def _launch(beta_w, maskf, uniforms, z0, alpha, n_sweeps, burnin):
    global launches
    b, l, k = beta_w.shape
    if not 1 <= k <= MAX_TOPICS:
        raise ValueError(f"lda_gibbs: K={k} outside 1..{MAX_TOPICS} topics")
    if uniforms.shape != (n_sweeps, b, l):
        raise ValueError(f"lda_gibbs: uniforms must be [{n_sweeps}, {b}, "
                         f"{l}], got {tuple(uniforms.shape)}")
    if (maskf.shape != (b, l) or z0.shape != (b, l)
            or beta_w.dtype != torch.float32):
        raise ValueError("lda_gibbs: want float32 beta_w [B, L, K] and "
                         "maskf, z0 [B, L]")
    maskf = maskf.to(torch.float32).contiguous()
    uniforms = uniforms.to(torch.float32).contiguous()
    z0 = z0.to(torch.int32).contiguous()
    beta_w = beta_w.contiguous()
    common.require_cuda("lda_gibbs", beta_w, maskf, uniforms, z0)
    per_pos = torch.empty_like(beta_w)
    z = torch.empty_like(z0)
    ndk_mean = torch.empty((b, k), dtype=torch.float32, device=beta_w.device)
    if b == 0:
        return per_pos, z.to(torch.int64), ndk_mean
    lib = common.load("lda_gibbs")
    ptr = ctypes.c_void_p
    with torch.cuda.device(beta_w.device):
        err = lib.lda_gibbs_sweeps(
            ptr(beta_w.data_ptr()), ptr(maskf.data_ptr()),
            ptr(uniforms.data_ptr()), ptr(z0.data_ptr()),
            ptr(per_pos.data_ptr()), ptr(z.data_ptr()),
            ptr(ndk_mean.data_ptr()), ctypes.c_int(b), ctypes.c_int(l),
            ctypes.c_int(k), ctypes.c_int(n_sweeps), ctypes.c_int(burnin),
            ctypes.c_float(alpha), ptr(common.stream_ptr()))
    if err == _TOO_LONG:
        raise ValueError(f"lda_gibbs: documents of {l} positions do not fit "
                         f"one warp's shared memory")
    common.check(err, "lda_gibbs")
    launches += 1
    shape = (b, l, k, n_sweeps)
    launches_by_shape[shape] = launches_by_shape.get(shape, 0) + 1
    return per_pos, z.to(torch.int64), ndk_mean


def gibbs_sweeps(beta_w: torch.Tensor, maskf: torch.Tensor,
                 uniforms: torch.Tensor, z0: torch.Tensor, *, alpha: float,
                 n_sweeps: int, burnin: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """S collapsed-Gibbs sweeps: (per_pos [B,L,K], z [B,L], ndk_mean [B,K]).

    beta_w ``[B, L, K]`` float32 (K <= 128 on the card), maskf ``[B, L]``,
    uniforms ``[S, B, L]``, z0 ``[B, L]``; any B (no padding pass).
    """
    if not 0 <= burnin < n_sweeps:
        raise ValueError(f"need 0 <= burnin < n_sweeps, got {burnin} / "
                         f"{n_sweeps}")
    if beta_w.device.type == "cpu":
        return gibbs_sweeps_ref(beta_w, maskf, uniforms, z0, alpha=alpha,
                                n_sweeps=n_sweeps, burnin=burnin)
    return _launch(beta_w, maskf, uniforms, z0, float(alpha), n_sweeps,
                   burnin)
