"""Checkpoints and model files (counterpart of `bigdl_tpu.serialization`):
the durable checkpoint format v2 (`checkpoint.py`), sharded checkpoints
through `torch.distributed.checkpoint` (`sharded_checkpoint.py`) and the
model-file format (`module_serializer.py`), each interchangeable with the
reference's."""

from bigdl_tpu_torch.serialization.checkpoint import (
    CheckpointCorruptError, latest_checkpoint, load_checkpoint,
    load_latest_valid, prune_checkpoints, quarantine_checkpoint,
    restore_optim_method, save_checkpoint, valid_checkpoints,
    verify_checkpoint)
from bigdl_tpu_torch.serialization.module_serializer import (
    ModuleSerializer, register_module, registered_modules)
from bigdl_tpu_torch.serialization.sharded_checkpoint import (
    load_checkpoint_sharded, restore_sharded, save_checkpoint_sharded,
    save_sharded)

__all__ = ["load_checkpoint", "save_checkpoint", "latest_checkpoint",
           "valid_checkpoints", "verify_checkpoint", "load_latest_valid",
           "quarantine_checkpoint", "prune_checkpoints",
           "restore_optim_method", "CheckpointCorruptError",
           "save_sharded", "restore_sharded", "save_checkpoint_sharded",
           "load_checkpoint_sharded",
           "ModuleSerializer", "register_module", "registered_modules"]
