"""Utilities (counterpart of `bigdl_tpu.utils`). Ported so far:
`filesystem`, the path and URI dispatch the checkpoints go through."""
