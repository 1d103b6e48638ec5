"""CUDA kernel for one gossip matching round (DELEDA's statistic mix)."""

from repro_torch.kernels.gossip_mix.ops import mix_pairs_

__all__ = ["mix_pairs_"]
