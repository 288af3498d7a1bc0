"""The fused BatchNorm-affine + ReLU tail and its CUDA kernels for Hopper.

Counterpart of `bigdl_tpu/ops/bn_relu_kernel.py`. Over an `[N, C]` view
of an NHWC activation (leading axes flattened) with the folded BN
coefficients `scale`, `shift` ([C] f32):

    y = relu(cast(x * scale + shift))       (relu=True)
    y =      cast(x * scale + shift)        (relu=False)

- `bn_relu_forward` / `bn_relu_backward`: the CUDA kernels
  `csrc/bn_relu_fwd.cu` / `csrc/bn_relu_bwd.cu` on a CUDA tensor; on a CPU
  tensor their plain versions `bn_relu_forward_plain` /
  `bn_relu_backward_plain`. They never fall back: a CUDA tensor launches
  the kernel or raises. Each counts its launches (`.launches`).
- `BnReluFunction`: the `torch.autograd.Function` around the pair, the
  counterpart of the `custom_vjp` `bn_relu_pallas`. It saves
  `(x, scale, shift)` only; the backward recomputes the pre-activation.
  Autograd carries dscale/dshift on through the batch statistics.
- `bn_relu`: the router the BN layers call (`nn/normalization.py`).

The reference runs the Pallas pair on a TPU and, elsewhere, the unfused
expression with `jax.nn.relu`'s zero gradient at 0. The port runs the
Function on every device; on the CPU its plain versions are that same
unfused expression, the mask `pre > 0` giving the same zero at 0.

Both kernels take x as the f32 upcast the BN layer hands over
(`_stats_scale_shift`), so a bf16 activation is read as f32 here; reading
the bf16 activation directly is a later optimisation.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: elements of the [N, C] matrix one backward tile covers (about): the
#: row tile is picked from N and C alone, which fixes the summation order
_BWD_TILE_ELEMS = 16384
_BWD_MAX_TILE_N = 4096


def bn_relu_forward_plain(x2, scale, shift, relu: bool = True,
                          out_dtype=None):
    """The plain PyTorch version of the forward kernel: the multiply and
    the add in f32 (x upcast), cast to `out_dtype`, then max(., 0)."""
    y = (x2 * scale + shift).to(out_dtype or x2.dtype)
    return y.clamp_min(0) if relu else y


def bn_relu_backward_plain(x2, scale, shift, g2, relu: bool = True):
    """The plain PyTorch version of the backward kernel: (dx [N, C] f32,
    dscale [C], dshift [C]). The mask is taken on the pre-activation cast
    to g's dtype, as the forward's output was."""
    if relu:
        pre = (x2 * scale + shift).to(g2.dtype)
        g2 = torch.where(pre > 0, g2, torch.zeros((), dtype=g2.dtype,
                                                  device=g2.device))
    g32 = g2.float()
    return g32 * scale, (g32 * x2).sum(0), g32.sum(0)


def bwd_tile_rows(n: int, c: int) -> int:
    """Rows per backward tile for an [n, c] matrix: about
    `_BWD_TILE_ELEMS` elements, a multiple of 8, at most
    `_BWD_MAX_TILE_N` rows. A function of (n, c) only."""
    rows = -(-_BWD_TILE_ELEMS // c)
    rows = min(max(8, -(-rows // 8) * 8), _BWD_MAX_TILE_N)
    return min(rows, n)


# --------------------------------------------------------------------------
# The CUDA kernels (csrc/bn_relu_fwd.cu, csrc/bn_relu_bwd.cu), via ctypes
# --------------------------------------------------------------------------

_FNS = {}


def _kernel_fn(name: str):
    fns = _FNS.get(name)
    if fns is None:
        from bigdl_tpu_torch.ops._build import load_kernel
        lib = load_kernel(name)
        fn = getattr(lib, name)
        n_ptrs = 4 if name == "bn_relu_fwd" else 7
        n_ints = 4 if name == "bn_relu_fwd" else 5
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_longlong]
                       + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        fns = _FNS[name] = (fn, err)
    return fns


def _check_2d(name, t, c=None):
    if t.dim() != 2:
        raise ValueError(f"{name} must be [N, C], got shape {tuple(t.shape)}")
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if t.shape[0] < 1 or t.shape[1] < 1:
        raise ValueError(f"{name} is empty: shape {tuple(t.shape)}")
    if c is not None and t.shape[1] != c:
        raise ValueError(f"{name} has {t.shape[1]} columns, expected {c}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous [N, C] view (strides "
                         f"{t.stride()}); the kernels never reinterpret "
                         "strides")


def _check_coeffs(x2, scale, shift):
    c = x2.shape[1]
    for name, t in (("scale", scale), ("shift", shift)):
        if t.shape != (c,) or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [{c}] "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
        if t.device != x2.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2.device}")


def _run(name, args):
    fn, err_str = _kernel_fn(name)
    device = args[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                    for a in args], stream)
    if code != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{err_str(code).decode()} (cudaError {code})")


def bn_relu_forward(x2, scale, shift, relu: bool = True, out_dtype=None):
    """The fused forward over x2 [N, C] (f32 or bf16, contiguous): the CUDA
    kernel on a CUDA tensor, its plain version on a CPU tensor. `out_dtype`
    (f32 or bf16) defaults to x2's. `bn_relu_forward.launches` counts
    kernel launches."""
    _check_2d("x", x2)
    _check_coeffs(x2, scale, shift)
    out_dtype = out_dtype or x2.dtype
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    if x2.device.type == "cpu":
        return bn_relu_forward_plain(x2, scale, shift, relu, out_dtype)
    if x2.device.type != "cuda":
        raise NotImplementedError(
            f"no bn_relu forward for device type {x2.device.type!r}")
    n, c = x2.shape
    y2 = torch.empty((n, c), dtype=out_dtype, device=x2.device)
    _run("bn_relu_fwd", [x2, scale, shift, y2, n, c, _DTYPE_CODES[x2.dtype],
                         _DTYPE_CODES[out_dtype], int(bool(relu))])
    bn_relu_forward.launches += 1
    return y2


bn_relu_forward.launches = 0


def bn_relu_backward(x2, scale, shift, g2, relu: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused backward: (dx [N, C] f32, dscale [C], dshift [C]) from the
    forward's input x2 and the cotangent g2 [N, C] (f32 or bf16, the
    forward output's dtype). The CUDA kernel on a CUDA tensor, its plain
    version on a CPU tensor; the kernel's per-tile partial sums are reduced
    here with `torch.sum`. `bn_relu_backward.launches` counts launches."""
    _check_2d("x", x2)
    _check_2d("g", g2, c=x2.shape[1])
    _check_coeffs(x2, scale, shift)
    if g2.shape[0] != x2.shape[0] or g2.device != x2.device:
        raise ValueError(f"g {tuple(g2.shape)} on {g2.device} does not "
                         f"match x {tuple(x2.shape)} on {x2.device}")
    if x2.device.type == "cpu":
        return bn_relu_backward_plain(x2, scale, shift, g2, relu)
    if x2.device.type != "cuda":
        raise NotImplementedError(
            f"no bn_relu backward for device type {x2.device.type!r}")
    n, c = x2.shape
    tile_n = bwd_tile_rows(n, c)
    n_tiles = -(-n // tile_n)
    dx = torch.empty((n, c), dtype=torch.float32, device=x2.device)
    parts = torch.empty((2, n_tiles, c), dtype=torch.float32,
                        device=x2.device)
    _run("bn_relu_bwd", [x2, scale, shift, g2, dx, parts[0], parts[1], n, c,
                         tile_n, _DTYPE_CODES[x2.dtype],
                         _DTYPE_CODES[g2.dtype], int(bool(relu))])
    bn_relu_backward.launches += 1
    ds, db = torch.sum(parts, dim=1)
    return dx, ds, db


bn_relu_backward.launches = 0


class BnReluFunction(torch.autograd.Function):
    """`bn_relu` with the fused backward: saves (x, scale, shift), no mask
    and no pre-activation. `BnReluFunction.g_copies` counts the backward
    calls whose incoming gradient was not NHWC-contiguous and had to be
    copied before the kernel could read it as [N, C]."""

    g_copies = 0

    @staticmethod
    def forward(ctx, x, scale, shift, relu: bool, out_dtype):
        if not x.is_contiguous():
            raise ValueError(
                f"bn_relu takes an NHWC-contiguous x (a channels_last "
                f"activation), got strides {x.stride()}")
        c = x.shape[-1]
        y2 = bn_relu_forward(x.view(-1, c), scale, shift, relu, out_dtype)
        ctx.save_for_backward(x, scale, shift)
        ctx.relu = relu
        return y2.view(x.shape)

    @staticmethod
    def backward(ctx, g):
        x, scale, shift = ctx.saved_tensors
        c = x.shape[-1]
        if not g.is_contiguous():
            BnReluFunction.g_copies += 1
            g = g.contiguous()
        dx2, ds, db = bn_relu_backward(x.view(-1, c), scale, shift,
                                       g.view(-1, c), ctx.relu)
        return dx2.view(x.shape), ds, db, None, None


def bn_relu(x, scale, shift, relu: bool = True,
            out_dtype: Optional[torch.dtype] = None):
    """Fused `activation(x * scale + shift)` over the trailing channel axis
    of an NHWC-contiguous x (any leading rank): the kernels on a CUDA
    tensor, the plain versions on a CPU tensor, with the fused backward in
    both cases. With scale = 1 this is the bias+activation tail."""
    return BnReluFunction.apply(x, scale, shift, relu,
                                out_dtype or x.dtype)
