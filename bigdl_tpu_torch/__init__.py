"""bigdl_tpu_torch: the PyTorch + CUDA port of bigdl_tpu for NVIDIA Hopper.

The package mirrors `bigdl_tpu`'s module paths (`ops/attention_kernel.py`
here is the counterpart of `bigdl_tpu/ops/attention_kernel.py`, and so
on) and keeps its conventions at the public functions: attention tensors
are `[B, H, T, D]`, token ids are 1-based, the decode KV cache is
`[slots, H, max_len, head_dim]`.

Every Pallas kernel of the JAX package becomes a kernel written by hand
for Hopper (`csrc/`), built with `nvcc` at first use and bound through
`ctypes` (`ops/_build.py`). Each kernel has a plain PyTorch version in the
same module; a wrapper takes the plain version only for tensors that lie
on the CPU, and on a CUDA tensor launches the kernel or raises.

Entry points default to `device="cuda"` and run on the CPU only when the
caller passes `device="cpu"`.
"""

from bigdl_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
