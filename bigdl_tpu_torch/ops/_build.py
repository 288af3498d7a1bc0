"""Build and load the port's hand-written CUDA kernels.

Each kernel source `bigdl_tpu_torch/csrc/<name>.cu` exposes a plain C
interface and is compiled by `nvcc` for Hopper (`sm_90a`) into its own
shared library, loaded with `ctypes`. Nothing includes PyTorch's headers,
so a build takes seconds, not minutes. Builds happen at first use, into
`build/kernels/` at the root of the checkout; a library's file name
carries a hash of its source, of every shared header (`csrc/*.cuh`) and of
the flags, so an edited source or header is never served by a stale
build.

`build_kernels()` starts one `nvcc` per source at once and waits for all
of them (what a cold start does); `load_kernel(name)` builds one on
demand and caches the loaded library for the life of the process.
`build_log(name)` is nvcc's report for the current build (ptxas's
registers and spills per kernel), kept beside the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Every kernel source of the port, by name (the `.cu` file's stem).
KERNELS = ("flash_attention_fwd", "flash_attention_carry",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "bn_relu_fwd", "bn_relu_bwd", "stem_conv")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (ptxas register/spill report) per kernel built here
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME); the port's "
        "CUDA kernels are built from source at first use")


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(f"no kernel source {src}")
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str, nvcc: str) -> Optional[subprocess.Popen]:
    """Start one nvcc into a temp file; None if the library is built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    build_logs[name] = log
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: no process ever loads a partial file


def build_log(name: str) -> str:
    """nvcc's output for the current build of kernel `name`, built if
    needed (also when an earlier process built it)."""
    path = build_kernels([name])[0]
    return build_logs.get(name) or path.with_suffix(".log").read_text()


def build_kernels(names: Sequence[str] = KERNELS) -> List[Path]:
    """Build every named kernel that is not built yet, one `nvcc` per
    source, all started together. Returns the library paths."""
    with _lock:
        nvcc = None
        procs = {}
        try:
            for name in names:
                if not _lib_path(name).exists():
                    nvcc = nvcc or _nvcc()
                    procs[name] = _start(name, nvcc)
        finally:
            # wait for every started build, even when a later start failed
            errors = []
            for name, proc in procs.items():
                try:
                    _finish(name, proc)
                except RuntimeError as e:
                    errors.append(str(e))
            if errors:
                raise RuntimeError("\n".join(errors))
        return [_lib_path(n) for n in names]


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel `name`, built if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = build_kernels([name])[0]
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib
