"""Graph IR and inference conversion (counterpart of `bigdl_tpu.ir`)."""

from bigdl_tpu_torch.ir.ir_graph import ConversionUtils, IRElement, IRGraph

__all__ = ["ConversionUtils", "IRElement", "IRGraph"]
