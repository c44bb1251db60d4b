"""Parallelism: process-group start-up, the device mesh, data parallelism,
ZeRO optimizer sharding and the H-sharded ConvLSTM rollout, on
``torch.distributed`` (counterpart of ``satflow_tpu/parallel``)."""

from satflow_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    get_mesh,
    make_mesh,
    replicated_sharding,
    shard_batch,
)
