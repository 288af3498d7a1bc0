"""Serving (counterpart of `bigdl_tpu.serving`): continuous-batching
generation over `TransformerLM` and the micro-batching `InferenceEngine`."""

from bigdl_tpu_torch.serving.engine import (EngineClosedError,
                                            InferenceEngine,
                                            QueueFullError, ServingEngine,
                                            ServingError,
                                            ServingTimeoutError,
                                            default_buckets)
from bigdl_tpu_torch.serving.generation import (GenerationEngine,
                                                TokenStream,
                                                default_seq_buckets,
                                                greedy_decode_reference)

__all__ = ["EngineClosedError", "GenerationEngine", "InferenceEngine",
           "QueueFullError",
           "ServingEngine", "ServingError", "ServingTimeoutError",
           "TokenStream", "default_buckets",
           "default_seq_buckets", "greedy_decode_reference"]
