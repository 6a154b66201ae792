from bluerov2_dynamics_tpu_torch.parallel.mesh import (  # noqa: F401
    init_group,
    make_mesh,
    replicate,
    shard_along,
)
from bluerov2_dynamics_tpu_torch.parallel.sharded import (  # noqa: F401
    sharded_endpoint_rmse,
    sharded_rollout_final,
    shardmap_endpoint_rmse,
)
