"""Parallelism over a mesh of torch devices (counterpart of
`bigdl_tpu/parallel`): the device mesh and sequence-parallel attention;
the process mesh, the collectives of data- and tensor-parallel training
over `torch.distributed` (`parallel/collectives.py`) and the sharding
rules (`parallel/sharding.py`)."""

from bigdl_tpu_torch.parallel.mesh import Mesh, ProcessMesh, build_mesh
from bigdl_tpu_torch.parallel.sequence import (
    SequenceParallelAttention, make_sequence_parallel_attention,
    ring_attention, ulysses_attention, zigzag_inverse, zigzag_order,
    zigzag_ring_attention)
from bigdl_tpu_torch.parallel.sharding import (PartitionSpec, ShardingRules,
                                               infer_param_specs,
                                               param_specs, shard_params)

__all__ = ["Mesh", "ProcessMesh", "build_mesh", "PartitionSpec",
           "ShardingRules", "infer_param_specs", "param_specs",
           "shard_params", "SequenceParallelAttention",
           "make_sequence_parallel_attention", "ring_attention",
           "ulysses_attention", "zigzag_inverse", "zigzag_order",
           "zigzag_ring_attention"]
