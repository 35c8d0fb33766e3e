"""Data parallelism and HPO in lockstep over ``torch.distributed`` (counterpart of
``saragan_tpu/parallel/``): one process per device in an explicit process group."""

from saragan_tpu_torch.parallel.halo import halo_conv3d  # noqa: F401
from saragan_tpu_torch.parallel.mesh import (  # noqa: F401
    SPACE_NOT_PORTED,
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
