"""Sharding: logical-axis rules -> PartitionSpecs and DTensor placements
for the production mesh (port of ``repro.sharding``)."""
from .rules import (
    DEFAULT_RULES,
    NamedSharding,
    PartitionSpec,
    batch_spec,
    cache_shardings,
    data_sharding,
    placements,
    spec_for_shape,
    tree_shardings,
)

__all__ = [k for k in dir() if not k.startswith("_")]
