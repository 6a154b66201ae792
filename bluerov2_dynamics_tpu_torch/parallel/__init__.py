from bluerov2_dynamics_tpu_torch.parallel.mesh import (  # noqa: F401
    init_group,
    make_mesh,
    replicate,
    shard_along,
)
from bluerov2_dynamics_tpu_torch.parallel.sharded import (  # noqa: F401
    sharded_ekf_bank,
    sharded_endpoint_rmse,
    sharded_koopman_fit,
    sharded_koopman_multistep_rmse,
    sharded_pf_bank,
    sharded_rollout_final,
    sharded_streaming_stats,
    shardmap_endpoint_rmse,
)
