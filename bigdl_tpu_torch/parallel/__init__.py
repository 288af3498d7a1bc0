"""Parallelism over a mesh of torch devices (counterpart of
`bigdl_tpu/parallel`): the mesh and sequence-parallel attention."""

from bigdl_tpu_torch.parallel.mesh import Mesh, build_mesh
from bigdl_tpu_torch.parallel.sequence import (
    SequenceParallelAttention, make_sequence_parallel_attention,
    ring_attention, ulysses_attention, zigzag_inverse, zigzag_order,
    zigzag_ring_attention)

__all__ = ["Mesh", "build_mesh", "SequenceParallelAttention",
           "make_sequence_parallel_attention", "ring_attention",
           "ulysses_attention", "zigzag_inverse", "zigzag_order",
           "zigzag_ring_attention"]
