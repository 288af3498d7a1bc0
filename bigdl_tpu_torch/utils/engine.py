"""Engine: the runtime topology and the one config system (counterpart of
`bigdl_tpu/utils/engine.py`).

`Engine.config` is a dict seeded from defaults, overridden by
`BIGDL_TPU_*` environment variables and by `Engine.init(**kwargs)`; an
unknown key or a bad value is refused and leaves the live config as it
was. The keys are the reference's, plus `timeout_s`, the process
group's timeout.

Topology, one process per GPU:
  node_number   the world size of the `torch.distributed` group (the
                reference: the JAX process count)
  core_number   the local CUDA device count (1 on the CPU)

`Engine.init(distributed=True, coordinator_address=..., num_processes=
..., process_id=...)` joins the process group with
`torch.distributed.init_process_group`. With those three unset it reads
the launcher's environment (`MASTER_ADDR`, `MASTER_PORT`, `RANK`,
`WORLD_SIZE`; `LOCAL_RANK`, default the rank). The process's device is
`cuda:{LOCAL_RANK % device_count}`, made the current device so that the
entry points' default (`resolve_device`) is it, or the CPU without CUDA.
Under the group, `get_mesh(data, model)` returns its ranks as a
(data, model) `parallel.mesh.ProcessMesh` for `DistriOptimizer(mesh=...)`.
The backend is NCCL on a CUDA device and gloo on the CPU; the
keyword-only `backend=` names another (gloo on a card, where two ranks
share one device, which NCCL refuses). A failed init raises: nothing
falls back to another backend. The group's `timeout_s` (default 600 s)
bounds every collective, so a dead peer ends the run instead of hanging
it.

    >>> from bigdl_tpu_torch.utils.engine import Engine
    >>> Engine.init(io_threads=2).config["io_threads"]
    2
    >>> Engine.node_number()
    1
"""

from __future__ import annotations

import datetime
import os
import threading
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from bigdl_tpu_torch.parallel import collectives

_DEFAULTS: Dict[str, Any] = {
    # the reference's engine type ('xla' | 'pallas'); the port runs its
    # hand-written kernels wherever they are ported
    "engine_type": "xla",
    # failure handling (the reference's bigdl.failure.retryTimes /
    # retryTimeInterval)
    "failure_retry_times": 5,
    "failure_retry_interval_s": 120,
    # host threads of the input pipeline
    "io_threads": 4,
    # refuse a second Engine in one process
    "check_singleton": False,
    "matmul_dtype": "bfloat16",
    # multi-process: distributed=True (or BIGDL_TPU_DISTRIBUTED=1) joins
    # the process group; the three below default to the launcher's env
    "distributed": False,
    "coordinator_address": "",
    "num_processes": 0,
    "process_id": -1,
    # the process group's timeout, seconds
    "timeout_s": 600.0,
}

_ENV_PREFIX = "BIGDL_TPU_"


class _Engine:
    """Module-level singleton (import `Engine` from this module)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._inited = False
        self._distributed_started = False
        self.config: Dict[str, Any] = dict(_DEFAULTS)
        self._mesh = None
        # the process meshes built under the process group, by shape
        self._process_meshes: Dict[tuple, Any] = {}
        #: this process's device once the process group is joined
        self.device: Optional[torch.device] = None

    def init(self, *, backend: Optional[str] = None,
             **overrides) -> "_Engine":
        """Set the config and, with `distributed`, join the process group
        (once). Later calls only merge config overrides."""
        with self._lock:
            merged = dict(self.config)
            for k, v in os.environ.items():
                if k.startswith(_ENV_PREFIX):
                    key = k[len(_ENV_PREFIX):].lower()
                    if key in merged:
                        merged[key] = type(_DEFAULTS[key])(
                            _coerce(v, _DEFAULTS[key]))
            for k, v in overrides.items():
                if k not in merged:
                    raise KeyError(f"unknown Engine config key: {k}")
                merged[k] = v
            io = merged["io_threads"]
            if not isinstance(io, int) or isinstance(io, bool) or io < 1:
                raise ValueError(
                    f"io_threads must be a positive int, got {io!r}")
            if not merged["timeout_s"] > 0:
                raise ValueError(f"timeout_s must be > 0, got "
                                 f"{merged['timeout_s']!r}")
            self.config.update(merged)
            if self.config["distributed"] and not self._distributed_started:
                self._init_distributed(backend)
                self._distributed_started = True
            if self._inited:
                return self
            if self.config["check_singleton"] and _SINGLETON.locked():
                raise RuntimeError("Engine already initialized in this "
                                   "process (check_singleton)")
            _SINGLETON.acquire(blocking=False)
            self._inited = True
            return self

    def _init_distributed(self, backend: Optional[str]):
        cfg, env = self.config, os.environ

        def need(name):
            if name not in env:
                raise RuntimeError(
                    f"Engine.init(distributed=True): pass coordinator_"
                    f"address, num_processes and process_id, or set "
                    f"{name} (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE)")
            return env[name]

        world = int(cfg["num_processes"]) if cfg["num_processes"] > 0 \
            else int(need("WORLD_SIZE"))
        rank = int(cfg["process_id"]) if cfg["process_id"] >= 0 \
            else int(need("RANK"))
        addr = cfg["coordinator_address"] or \
            f"{need('MASTER_ADDR')}:{need('MASTER_PORT')}"
        local_rank = int(env.get("LOCAL_RANK", rank))
        if torch.cuda.is_available():
            index = local_rank % torch.cuda.device_count()
            torch.cuda.set_device(index)
            device = torch.device("cuda", index)
        else:
            device = torch.device("cpu")
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        collectives.timeout_s = float(cfg["timeout_s"])
        if not dist.is_initialized():
            dist.init_process_group(
                backend, init_method=f"tcp://{addr}", rank=rank,
                world_size=world,
                timeout=datetime.timedelta(seconds=cfg["timeout_s"]))
        self.device = device

    def shutdown(self) -> None:
        """Leave the process group (a later `init(distributed=True)` joins
        a new one)."""
        with self._lock:
            self._process_meshes.clear()
            if dist.is_initialized():
                dist.destroy_process_group()
            self.config["distributed"] = False
            self._distributed_started = False
            self.device = None

    # topology
    def node_number(self) -> int:
        """The process group's world size (1 without one)."""
        return collectives.world_size()

    def core_number(self) -> int:
        """Local CUDA devices (1 on the CPU)."""
        return torch.cuda.device_count() if torch.cuda.is_available() else 1

    def total_devices(self) -> int:
        """Devices training together: one a process."""
        return collectives.world_size()

    def engine_type(self) -> str:
        return self.config["engine_type"]

    def get_mesh(self, data: Optional[int] = None, model: int = 1):
        """Under a process group, the (data, model) mesh of its ranks
        (`parallel.mesh.ProcessMesh`, rank r at (r // model, r % model);
        built once a shape, collectively: every rank calls this with the
        same shape). Without one, build (and cache) this process's device
        mesh."""
        if collectives.is_initialized():
            from bigdl_tpu_torch.parallel.mesh import (ProcessMesh,
                                                       process_mesh_shape)
            key = process_mesh_shape(data, model, collectives.world_size())
            if key not in self._process_meshes:
                self._process_meshes[key] = ProcessMesh(*key,
                                                        device=self.device)
            return self._process_meshes[key]
        if self._mesh is None or data is not None or model != 1:
            from bigdl_tpu_torch.parallel.mesh import build_mesh
            self._mesh = build_mesh(data=data, model=model)
        return self._mesh


_SINGLETON = threading.Lock()


def _coerce(raw: str, default):
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


Engine = _Engine()
