"""Sharding over `torch.distributed`, the port of `gsrast_tpu/parallel/`:
the (data, tiles) mesh and the process bootstrap (`mesh`), differentiable
collectives (`comm`), and the tile- and primitive-sharded renderers and the
data x tile train step (`sharded`)."""

from .mesh import (DATA_AXIS, TILE_AXIS, initialize_distributed, make_mesh)
from .sharded import (make_sharded_train_step, pad_gaussians,
                      render_primitive_sharded, render_tile_sharded)

__all__ = ["DATA_AXIS", "TILE_AXIS", "initialize_distributed", "make_mesh",
           "make_sharded_train_step", "pad_gaussians",
           "render_primitive_sharded", "render_tile_sharded"]
