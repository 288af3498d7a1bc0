"""Device selection shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. Asking for CUDA (explicitly or by default) on a machine
    without it raises; the port never falls back to the CPU on its own.
    A CUDA device without an index resolves to the current one."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "bigdl_tpu_torch runs on a CUDA device by default, but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
