"""Checkpoints (counterpart of `bigdl_tpu.serialization`): the durable
format v2 (`checkpoint.py`), interchangeable with the reference's, and
sharded checkpoints through `torch.distributed.checkpoint`
(`sharded_checkpoint.py`). The module serializer is not ported."""

from bigdl_tpu_torch.serialization.checkpoint import (
    CheckpointCorruptError, latest_checkpoint, load_checkpoint,
    load_latest_valid, prune_checkpoints, quarantine_checkpoint,
    restore_optim_method, save_checkpoint, valid_checkpoints,
    verify_checkpoint)
from bigdl_tpu_torch.serialization.sharded_checkpoint import (
    load_checkpoint_sharded, restore_sharded, save_checkpoint_sharded,
    save_sharded)

__all__ = ["load_checkpoint", "save_checkpoint", "latest_checkpoint",
           "valid_checkpoints", "verify_checkpoint", "load_latest_valid",
           "quarantine_checkpoint", "prune_checkpoints",
           "restore_optim_method", "CheckpointCorruptError",
           "save_sharded", "restore_sharded", "save_checkpoint_sharded",
           "load_checkpoint_sharded"]
