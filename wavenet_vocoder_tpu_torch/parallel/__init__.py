from wavenet_vocoder_tpu_torch.parallel.sharding import (  # noqa: F401
    Mesh,
    data_parallel_batch_size,
    make_mesh,
    replicate,
    shard_batch,
    shard_state,
)
from wavenet_vocoder_tpu_torch.parallel.distributed import (  # noqa: F401
    batch_row_offset,
    initialize_distributed,
    is_primary,
    local_batch_size,
    process_info,
    replicate_global,
)
