"""Sharded regrid, halo exchange and solvers over ``torch.distributed``."""
from xugrid_tpu_torch.parallel.sharding import (
    NeighborExchangePlan,
    ShardedRegrid,
    halo_exchange,
    hilbert_layout,
    partition_order,
    sharded_cg_solve,
    sharded_laplace_smooth,
)

__all__ = [
    "NeighborExchangePlan",
    "ShardedRegrid",
    "halo_exchange",
    "hilbert_layout",
    "partition_order",
    "sharded_cg_solve",
    "sharded_laplace_smooth",
]
