"""Logical-axis sharding: rules mapping logical names to mesh axes, and
their DTensor placements on a ``DeviceMesh``."""

from repro_torch.sharding.axes import (DP_ONLY_RULES, FSDP_RULES,
                                       LOGICAL_RULES, AbstractMesh,
                                       logical_sharding, logical_to_spec,
                                       mesh_shape, placements,
                                       shard_constraint, spec_for_shape,
                                       tree_shardings, tree_shardings_for)

__all__ = ["LOGICAL_RULES", "FSDP_RULES", "DP_ONLY_RULES", "AbstractMesh",
           "mesh_shape", "logical_sharding", "logical_to_spec",
           "placements", "shard_constraint", "spec_for_shape",
           "tree_shardings", "tree_shardings_for"]
