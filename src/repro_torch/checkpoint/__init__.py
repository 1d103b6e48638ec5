"""npz checkpoints of named arrays in the JAX package's on-disk format."""

from repro_torch.checkpoint.checkpoint import (latest_step, load_meta,
                                               restore_checkpoint,
                                               save_checkpoint,
                                               stored_shapes)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "load_meta", "stored_shapes"]
