"""Three-term roofline model for the NVIDIA H100 SXM.

The port's copy of ``repro.roofline.model``, with the H100's figures in
place of the TPU v5e's:

    compute term    = FLOPs per device            / peak FLOP/s
    memory term     = bytes per device            / HBM bandwidth
    collective term = collective bytes per device / link bandwidth

Every count is per device (the dry run counts one rank's local shards),
so the reference's per-device form holds as it is.

MODEL_FLOPS = 6 N D (dense) or 6 N_active D (MoE) per training step, the
usual 2x forward + 4x backward estimate; serving steps use 2 N D per
generated or scored token. The MODEL_FLOPS / (FLOPs x chips) ratio flags
recompute and redundant work (below 1: the step computes more than the
model needs; full remat gives about 0.75 for training).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import InputShape, ModelConfig

__all__ = ["HW", "H100", "RooflineReport", "model_flops", "analyze"]


@dataclasses.dataclass(frozen=True)
class HW:
    """NVIDIA H100 SXM5 80 GB, from NVIDIA's H100 datasheet:

    - ``peak_flops`` 989e12: bf16 tensor-core FLOP/s, dense (the
      datasheet's 1,979 TFLOP/s is with 2:4 sparsity);
    - ``hbm_bw`` 3.35e12 B/s: HBM3;
    - ``link_bw`` 450e9 B/s: NVLink 4 gives 900 GB/s a GPU, both
      directions together, so 450 GB/s one way.
    - ``hbm_bytes`` 80e9: the card's HBM3, which a device's arguments
      and temporaries must fit in.

    These are the figures the kernel bounds of PERF.md use. A 16 x 16
    mesh spans 32 nodes of 8 cards: NVLink joins the 8 cards of a node
    only, and between nodes a collective runs near 50 GB/s a card (one
    400 Gb/s InfiniBand port a card), so at that size the collective
    term is a lower bound by up to 9x.
    """

    peak_flops: float = 989e12        # bf16 FLOP/s, dense
    hbm_bw: float = 3.35e12           # bytes/s
    link_bw: float = 450e9            # bytes/s, NVLink 4 one way
    hbm_bytes: float = 80e9           # bytes of HBM3


H100 = HW()


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_device: float
    hlo_bytes_per_device: float
    collective_bytes_per_device: float
    compute_sec: float
    memory_sec: float
    collective_sec: float
    dominant: str
    model_flops_total: float
    useful_flops_ratio: float         # MODEL_FLOPS / (FLOPs * chips)
    collectives: dict
    memory_analysis: Optional[dict] = None

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """Analytic useful FLOPs for one step of this (arch, shape)."""
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def analyze(cfg: ModelConfig, shape: InputShape, mesh_name: str, chips: int,
            flops_per_device: float, bytes_per_device: float,
            coll_bytes_per_device: float, collectives: dict,
            memory_analysis: Optional[dict] = None,
            hw: HW = H100) -> RooflineReport:
    """The report's field names keep the reference's (``hlo_*``): here
    they hold the dispatch counters' counts (``roofline.counters``)."""
    compute_sec = flops_per_device / hw.peak_flops
    memory_sec = bytes_per_device / hw.hbm_bw
    collective_sec = coll_bytes_per_device / hw.link_bw
    terms = {"compute": compute_sec, "memory": memory_sec,
             "collective": collective_sec}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    total = flops_per_device * chips
    ratio = mf / total if total else 0.0
    return RooflineReport(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_flops_per_device=flops_per_device,
        hlo_bytes_per_device=bytes_per_device,
        collective_bytes_per_device=coll_bytes_per_device,
        compute_sec=compute_sec, memory_sec=memory_sec,
        collective_sec=collective_sec, dominant=dominant,
        model_flops_total=mf, useful_flops_ratio=ratio,
        collectives=collectives, memory_analysis=memory_analysis)
