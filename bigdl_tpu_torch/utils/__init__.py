"""Utilities (counterpart of `bigdl_tpu.utils`). Ported so far:
`filesystem`, the path and URI dispatch the checkpoints go through,
`table`, the 1-based `Table` and its builder `T`, and `engine`, the config
and the process group (`Engine`)."""

from bigdl_tpu_torch.utils.table import T, Table

__all__ = ["T", "Table"]
