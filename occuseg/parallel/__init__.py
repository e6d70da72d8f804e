from occuseg.parallel.data_parallel import (
    make_dp_train_step,
    make_mesh,
    replicate_state,
    shard_batch,
)
from occuseg.parallel.spatial import (
    SPACE_AXIS,
    ShardedPlan,
    extend_features,
    halo_exchange,
    shard_level,
    shard_plan,
)
from occuseg.parallel.spatial_model import (
    make_spatial_train_step,
    prepare_shard_args,
    sharded_occuseg_infer,
    sharded_train_forward,
)
