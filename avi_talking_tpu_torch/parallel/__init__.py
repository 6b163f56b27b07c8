"""The data- and tensor-parallel layer on ``torch.distributed`` (port of
``avi_talking_tpu/parallel``)."""

from .mesh import (
    BatchSharding,
    batch_sharding,
    dp_gather,
    dp_mean,
    dp_size,
    dp_sum,
    emote_param_sharding_rules,
    fsdp_extend_spec,
    fsdp_param_shardings,
    fsdp_shard_params,
    full_state_dict,
    init_distributed,
    is_main_process,
    make_mesh,
    param_shardings,
    reduce_gradients,
    replicate,
    shard_params,
    state_shardings_like,
)
