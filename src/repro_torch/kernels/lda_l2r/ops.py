"""Wrapper of the lda_l2r CUDA kernel, dispatched by the tensor's device.

A CUDA tensor launches ``csrc/lda_l2r.cu`` (or raises); a CPU tensor
runs the plain version in ``ref.py``. The kernel takes the documents as
they come, or longest first when the batch has more documents than the
card has SMs (``order``, one ``argsort``). The per-document keys are
derived by the caller (``fold_in(key, doc_id)``, outside the kernel, as in
the reference's ``kernels/lda_l2r/ops.py``) and the ``[L, B]`` scores are
summed over L by the caller. ``launches`` counts kernel launches only;
``launches_by_shape`` counts them by ``(B, L, K, P, count_weighted)``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common

__all__ = ["l2r_scores", "launches", "launches_by_shape", "MAX_TOPICS"]

# a warp per particle chain (csrc/lda_l2r.cu): 32 lanes own 4 topics
# each, and topics are kept as uint8; shared memory limits the document's
# length (about 33,000 positions), not K or P
MAX_TOPICS = 128
MAX_PARTICLES = 1024
# the C entry point's return when a block of one warp does not fit shared
# memory (gibbs_warp::kTooLong)
_TOO_LONG = -1
launches = 0
launches_by_shape: dict[tuple, int] = {}


def _launch(kd, beta_w, weights, alpha, n_particles, count_weighted):
    global launches
    b, l, k = beta_w.shape
    if not 1 <= k <= MAX_TOPICS:
        raise ValueError(f"lda_l2r: K={k} outside 1..{MAX_TOPICS} topics")
    if not 1 <= n_particles <= MAX_PARTICLES:
        raise ValueError(f"lda_l2r: n_particles={n_particles} not in "
                         f"[1, {MAX_PARTICLES}]")
    if (kd.shape != (b, 2) or weights.shape != (b, l)
            or beta_w.dtype != torch.float32):
        raise ValueError("lda_l2r: want kd [B, 2], float32 beta_w "
                         "[B, L, K], weights [B, L]")
    kd = kd.to(torch.int64).contiguous()
    beta_w = beta_w.contiguous()
    weights = weights.to(torch.float32).contiguous()
    common.require_cuda("lda_l2r", kd, beta_w, weights)
    ll = torch.empty((l, b), dtype=torch.float32, device=beta_w.device)
    if b == 0:
        return ll
    # a batch larger than one block per SM runs in more than one wave:
    # blocks then take the documents longest first, so that no long
    # document starts late (a smaller batch skips the sort's launches)
    order = None
    if b > torch.cuda.get_device_properties(
            beta_w.device).multi_processor_count:
        order = torch.argsort(torch.count_nonzero(weights, -1),
                              descending=True)
    # each particle's p_w of every position, read back after the scan
    pw = torch.empty((b, n_particles, l), dtype=torch.float32,
                     device=beta_w.device)
    lib = common.load("lda_l2r")
    ptr = ctypes.c_void_p
    with torch.cuda.device(beta_w.device):
        err = lib.lda_l2r_scores(
            ptr(kd.data_ptr()), ptr(beta_w.data_ptr()),
            ptr(weights.data_ptr()),
            ptr(None if order is None else order.data_ptr()),
            ptr(pw.data_ptr()), ptr(ll.data_ptr()),
            ctypes.c_int(b), ctypes.c_int(l), ctypes.c_int(k),
            ctypes.c_int(n_particles), ctypes.c_float(alpha),
            ctypes.c_float(alpha * k), ctypes.c_int(int(count_weighted)),
            ptr(common.stream_ptr()))
    if err == _TOO_LONG:
        raise ValueError(f"lda_l2r: documents of {l} positions do not fit "
                         f"a block's shared memory")
    common.check(err, "lda_l2r")
    launches += 1
    shape = (b, l, k, n_particles, count_weighted)
    launches_by_shape[shape] = launches_by_shape.get(shape, 0) + 1
    return ll


def l2r_scores(kd: torch.Tensor, beta_w: torch.Tensor,
               weights: torch.Tensor, alpha: float, *,
               n_particles: int = 10,
               count_weighted: bool = False) -> torch.Tensor:
    """Per-position left-to-right scores ``[L, B]``.

    kd ``[B, 2]`` per-document key words (doc-folded), beta_w
    ``[B, L, K]`` float32 (K <= 128 and P <= 1024 on the card), weights
    ``[B, L]``: the 0/1 document mask, or the unique layout's integer
    token counts with ``count_weighted`` (slot n then scores
    ``c_n * log p``); any B.
    """
    if beta_w.device.type == "cpu":
        from repro_torch.kernels.lda_l2r.ref import l2r_scores_ref
        return l2r_scores_ref(kd, beta_w, weights, alpha, n_particles,
                              count_weighted)
    return _launch(kd, beta_w, weights, float(alpha), int(n_particles),
                   bool(count_weighted))
