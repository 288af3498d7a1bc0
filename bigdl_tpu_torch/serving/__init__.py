"""Serving (counterpart of `bigdl_tpu.serving`): the micro-batching
`InferenceEngine` with its per-bucket circuit breaker, continuous-batching
generation over `TransformerLM`, and `ServingFleet`, N replicas behind a
`Router` with lease membership, drain and exactly-once re-route, re-warm
on rejoin and autoscaling. `optim.predictor.PredictionService` is the
facade over one engine."""

from bigdl_tpu_torch.serving.engine import (EngineClosedError,
                                            InferenceEngine,
                                            QueueFullError, ServingEngine,
                                            ServingError,
                                            ServingTimeoutError,
                                            ServingUnavailableError,
                                            default_buckets)
from bigdl_tpu_torch.serving.fleet import (AutoscalePolicy,
                                           FleetTokenStream, Router,
                                           ServingFleet,
                                           ServingReroutedError,
                                           default_router_policy)
from bigdl_tpu_torch.serving.generation import (GenerationEngine,
                                                TokenStream,
                                                default_seq_buckets,
                                                greedy_decode_reference)
from bigdl_tpu_torch.serving.stats import WindowedHistogram

__all__ = ["AutoscalePolicy", "EngineClosedError", "FleetTokenStream",
           "GenerationEngine", "InferenceEngine", "QueueFullError", "Router",
           "ServingEngine", "ServingError", "ServingFleet",
           "ServingReroutedError", "ServingTimeoutError",
           "ServingUnavailableError", "TokenStream", "WindowedHistogram",
           "default_buckets", "default_router_policy", "default_seq_buckets",
           "greedy_decode_reference"]
