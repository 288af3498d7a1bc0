"""Observability (counterpart of `bigdl_tpu.observability`). Ported so
far: `costs`, the FLOP count of one call, the peak-FLOPs registry and
MFU. Spans, telemetry, health monitors and the rest are not ported
(`ROADMAP.md` queue 1 item 9)."""

from bigdl_tpu_torch.observability.costs import (PEAK_BF16_FLOPS,
                                                 count_flops,
                                                 default_device_kind, mfu,
                                                 peak_flops)

__all__ = ["count_flops", "default_device_kind", "mfu", "peak_flops"]
