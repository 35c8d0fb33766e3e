"""Data parallelism, spatial sharding and HPO in lockstep over ``torch.distributed``
(counterpart of ``saragan_tpu/parallel/``): one process per device in an explicit
process group."""

from saragan_tpu_torch.parallel.halo import (  # noqa: F401
    SlabNoise,
    enter_slab,
    gather_slabs,
    halo_conv3d,
    halo_exchange,
    halo_upscale_conv,
    space_allreduce,
    space_sum,
    take_slab,
)
from saragan_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    allreduce_mean_,
    allreduce_min,
    broadcast_params_,
    gather_rows,
    init_mesh,
    rank,
    shard_rows,
    world_size,
)
from saragan_tpu_torch.parallel.multihost import (  # noqa: F401
    SynchronizedTrial,
    any_rank,
    broadcast_json,
    broadcast_scalar,
    synchronized_trial,
)
