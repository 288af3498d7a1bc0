"""Parallelism over a mesh of torch devices (counterpart of
`bigdl_tpu/parallel`): the device mesh, its placement helpers and the
single-controller `shard_map`; sequence-parallel attention; pipeline
parallelism (`GPipe`, `PipelineStages` with 1F1B, `split_sequential`)
and expert parallelism (`MoE`); the process mesh, the collectives of
data- and tensor-parallel training over `torch.distributed`
(`parallel/collectives.py`) and the sharding rules
(`parallel/sharding.py`).

`GPipe`, `PipelineStages`, `split_sequential` and `MoE` are imported on
first use: their modules import the layers, whose modules import this
package (the collectives) and the kernels.

Not ported yet: a ring over `torch.distributed` (one process per GPU,
NCCL send/recv), `ROADMAP.md` queue 1 item 7.
"""

import importlib

from bigdl_tpu_torch.parallel.mesh import (Mesh, NamedSharding, ProcessMesh,
                                           build_mesh, data_sharding,
                                           get_shard_map, replicate_sharding,
                                           shard_batch, shard_map)
from bigdl_tpu_torch.parallel.sequence import (
    SequenceParallelAttention, make_sequence_parallel_attention,
    ring_attention, ulysses_attention, zigzag_inverse, zigzag_order,
    zigzag_ring_attention)
from bigdl_tpu_torch.parallel.sharding import (PartitionSpec, ShardingRules,
                                               infer_param_specs,
                                               param_specs, shard_params)

__all__ = ["GPipe", "Mesh", "MoE", "NamedSharding", "PartitionSpec",
           "PipelineStages", "ProcessMesh", "build_mesh", "data_sharding",
           "get_shard_map", "replicate_sharding", "shard_batch",
           "shard_map", "split_sequential", "ShardingRules",
           "infer_param_specs", "param_specs", "shard_params",
           "SequenceParallelAttention", "make_sequence_parallel_attention",
           "ring_attention", "ulysses_attention", "zigzag_inverse",
           "zigzag_order", "zigzag_ring_attention"]

#: the names imported on first use, and their modules
_LAZY = {"GPipe": "pipeline", "PipelineStages": "pipeline",
         "split_sequential": "pipeline", "MoE": "moe"}


def __getattr__(name):
    if name in _LAZY:
        module = importlib.import_module(f"{__name__}.{_LAZY[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
