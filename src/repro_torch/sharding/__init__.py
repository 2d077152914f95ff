"""Partition specs for params, batches, caches and the federation state."""
from repro_torch.sharding.specs import (  # noqa: F401
    PartitionSpec, auto_batch_specs, auto_param_specs, auto_tree_specs,
    dp_axes, federation_state_specs, local_shape, placements)
