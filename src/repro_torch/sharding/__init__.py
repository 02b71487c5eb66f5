from repro_torch.sharding.rules import (  # noqa: F401
    batch_logical_axes,
    cache_logical_axes,
    placements,
    spec_for,
    tree_shardings,
)
