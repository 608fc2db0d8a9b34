"""Data parallelism over frame pairs (`vidu4d_tpu/parallel/`)."""

from vidu4d_tpu_torch.parallel.sharding import (
    build_stage3_train_step,
    make_mesh,
    make_synthetic_stage3_inputs,
    shard_batch,
)
