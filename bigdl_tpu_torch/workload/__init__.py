"""Fleet-scale traffic record/replay (counterpart of `bigdl_tpu.workload`).

Production traffic becomes a *workload file* (`WorkloadRecorder`, or the
seeded Poisson/bursty/diurnal synthesizers). A `WorkloadReplayer` drives
that file against a live `InferenceEngine` / `GenerationEngine` /
`ServingFleet` on an injectable clock, interleaved with a seeded
`ChaosSchedule`, and emits one canonical telemetry stream;
`compare_streams` (the engine under `tools/metrics_cli.py diff`) turns
"does the fleet do the same thing under this traffic with a kill at
peak?" into an exit code. The files and streams are the reference's,
so either package replays the other's workload files.
"""

from bigdl_tpu_torch.workload.chaos import (CHAOS_ACTIONS, ChaosAction,
                                            ChaosSchedule)
from bigdl_tpu_torch.workload.diff import (DiffResult, compare_streams,
                                           load_stream)
from bigdl_tpu_torch.workload.record import (Workload, WorkloadEntry,
                                             WorkloadRecorder,
                                             bursty_arrivals,
                                             diurnal_arrivals,
                                             poisson_arrivals, synthesize)
from bigdl_tpu_torch.workload.replay import (RealClock, VirtualClock,
                                             WorkloadReplayer)

__all__ = [
    "CHAOS_ACTIONS", "ChaosAction", "ChaosSchedule",
    "DiffResult", "compare_streams", "load_stream",
    "Workload", "WorkloadEntry", "WorkloadRecorder",
    "bursty_arrivals", "diurnal_arrivals", "poisson_arrivals",
    "synthesize",
    "RealClock", "VirtualClock", "WorkloadReplayer",
]
