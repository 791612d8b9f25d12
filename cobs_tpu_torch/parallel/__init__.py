from cobs_tpu_torch.parallel.sharded import (  # noqa: F401
    Mesh,
    ShardedIndex,
    make_mesh,
    scatter_step,
    shard_words,
    train_step,
)
