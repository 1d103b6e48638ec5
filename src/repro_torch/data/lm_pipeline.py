"""LM token pipeline for the transformer substrate.

The port's copy of ``repro.data.lm_pipeline``: a deterministic synthetic
token stream drawn with numpy on the host, the reference's generator and
draws in its order, so a seed gives the reference's batches bit for bit.
Each batch is built on the CPU and moved to the caller's device.
``sharded_batch`` builds one batch as a DTensor, each rank drawing only
its own shard; ``make_lm_batch_specs`` gives a train batch's ``meta``
stand-ins for the dry run.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, NamedTuple

import numpy as np
import torch

__all__ = ["LMBatch", "TokenPipeline", "make_lm_batch_specs"]


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

    def sharded_batch(self, mesh, placements) -> LMBatch:
        """One batch as DTensors on ``mesh`` under ``placements``: each
        rank draws only its own shard of the [B, S] tokens (Zipf, as the
        reference's per-shard generator draws them), so no rank holds the
        global batch, and places it on the mesh's device. ``targets`` is
        ``tokens`` rolled by one along the sequence, ``mask`` all true.

        Each shard's generator is seeded with ``(seed, row offset, column
        offset)`` through ``numpy.random.SeedSequence``, a stable
        function, so the batch is the same in every process. (The
        reference seeds it with ``seed + hash(str(index))``, and Python
        salts ``str`` hashes per process, so its sharded batches change
        from run to run.)"""
        from torch.distributed.tensor import DTensor

        from repro_torch.sharding.local import local_offset
        shape, offset = local_offset(None, placements,
                                     (self.batch_size, self.seq_len), mesh)
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed, *offset]))
        local = torch.from_numpy(rng.choice(
            self.vocab_size, shape, p=self._zipf_probs()).astype(np.int32))
        tokens = DTensor.from_local(local.to(mesh.device_type), mesh,
                                    placements, run_check=False)
        targets = torch.roll(tokens, -1, dims=1)
        return LMBatch(tokens=tokens, targets=targets,
                       mask=torch.ones_like(tokens, dtype=torch.bool))


def make_lm_batch_specs(batch_size: int, seq_len: int) -> dict:
    """A train step's batch as ``meta`` tensors (dry-run path)."""
    def meta(dtype):
        return torch.empty((batch_size, seq_len), dtype=dtype, device="meta")
    return {"tokens": meta(torch.int32), "targets": meta(torch.int32),
            "mask": meta(torch.bool)}
