"""Utilities (counterpart of `bigdl_tpu.utils`). Ported so far:
`filesystem`, the path and URI dispatch the checkpoints go through,
`table`, the 1-based `Table` and its builder `T`, and `engine`, the config
and the process group (`Engine`). `Engine` is imported on first use: the
engine module imports the parallel package, which imports layers whose
modules import this package."""

from bigdl_tpu_torch.utils.table import T, Table

__all__ = ["Engine", "T", "Table"]


def __getattr__(name):
    if name == "Engine":
        from bigdl_tpu_torch.utils.engine import Engine
        return Engine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
