"""Workload tools (counterpart of `bigdl_tpu.workload`).

Ported so far: `diff` (`compare_streams`, `DiffResult`, `load_stream`),
which `tools/metrics_cli.py diff` runs. The recorder, the chaos schedule
and the replayer (`record`, `chaos`, `replay`) are not ported yet
(`ROADMAP.md` queue 1 item 9).
"""

from bigdl_tpu_torch.workload.diff import (DiffResult, compare_streams,
                                           load_stream)

__all__ = ["DiffResult", "compare_streams", "load_stream"]
