"""Distribution layer: the mesh description, sharding rules, placement."""

from repro_torch.distributed.sharding import (  # noqa: F401
    batch_axes,
    batch_spec,
    current_mesh,
    data_parallel_size,
    model_axis,
    set_mesh,
    with_sharding,
)
