"""LM token pipeline for the transformer substrate.

The port's copy of ``repro.data.lm_pipeline``: a deterministic synthetic
token stream drawn with numpy on the host, the reference's generator and
draws in its order, so a seed gives the reference's batches bit for bit.
Each batch is built on the CPU and moved to the caller's device. The
reference's ``sharded_batch`` and ``make_lm_batch_specs`` (jax shardings
and ``ShapeDtypeStruct`` specs for the dry run) wait for the sharding
slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, NamedTuple

import numpy as np
import torch

__all__ = ["LMBatch", "TokenPipeline"]


class LMBatch(NamedTuple):
    tokens: torch.Tensor    # [B, S] int32 inputs
    targets: torch.Tensor   # [B, S] int32 next-token labels
    mask: torch.Tensor      # [B, S] bool loss mask


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    """Synthetic but statistically non-trivial token stream.

    Tokens follow a Zipfian marginal with a local bigram structure
    (next ~ 0.7 * bigram(cur) + 0.3 * zipf), so that a model trained on it
    has real signal to fit — loss decreasing is a meaningful smoke check.
    """

    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0

    def _zipf_probs(self) -> np.ndarray:
        ranks = np.arange(1, self.vocab_size + 1)
        p = 1.0 / ranks
        return p / p.sum()

    def batches(self, device: str | torch.device = "cpu"
                ) -> Iterator[LMBatch]:
        rng = np.random.default_rng(self.seed)
        zipf = self._zipf_probs()
        # deterministic "bigram" successor: next = (17*cur + 3) % V with noise
        while True:
            toks = np.empty((self.batch_size, self.seq_len + 1), np.int32)
            toks[:, 0] = rng.choice(self.vocab_size, self.batch_size, p=zipf)
            noise = rng.random((self.batch_size, self.seq_len))
            fresh = rng.choice(self.vocab_size,
                               (self.batch_size, self.seq_len), p=zipf)
            for t in range(self.seq_len):
                succ = (17 * toks[:, t] + 3) % self.vocab_size
                toks[:, t + 1] = np.where(noise[:, t] < 0.7, succ,
                                          fresh[:, t])
            yield LMBatch(
                tokens=torch.from_numpy(toks[:, :-1].copy()).to(device),
                targets=torch.from_numpy(toks[:, 1:].copy()).to(device),
                mask=torch.ones((self.batch_size, self.seq_len),
                                dtype=torch.bool, device=device),
            )
