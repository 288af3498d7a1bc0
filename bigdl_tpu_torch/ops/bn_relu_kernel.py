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
  counterpart of the `custom_vjp` `bn_relu_pallas`. It saves the tensor
  the kernels read, `scale` and `shift` only; the backward recomputes the
  pre-activation.
  Autograd carries dscale/dshift on through the batch statistics.
- `bn_relu`: the router the BN layers call (`nn/normalization.py`).

The reference runs the Pallas pair on a TPU and, elsewhere, the unfused
expression with `jax.nn.relu`'s zero gradient at 0. The port runs the
Function on every device; on the CPU its plain versions are that same
unfused expression, the mask `pre > 0` giving the same zero at 0.

The kernels read x in its own dtype. The BN layer computes its statistics
on an f32 copy of a bf16 activation and passes that copy as `x`, the
Function's differentiable input (autograd joins the kernel's f32 dx with
the statistics' gradient there, before the one cast back to bf16), and
the bf16 activation itself as `source=`: the kernels read and the
Function saves the source, 2 bytes an element where the copy has 4. The
upcast is exact, so every output is the same bits either way.

The backward reads g with its row stride: a channel slice of a wider NHWC
gradient (a `Concat` branch's share of the joined gradient) goes to the
kernel in place. Only a g whose rows cannot be seen as one [N, C] matrix
with unit column stride (an NCHW-permuted one, an expanded one) is copied
first, and counted in `BnReluFunction.g_copies`.

The partition of the backward (`bwd_partition`: column groups of at most
64 columns, row lanes, row tiles) is a function of (N, C) alone, which
fixes the summation order of dscale and dshift; its sum over tiles is
finished inside the one launch.

Each launch (or, on the CPU, plain version) counts `bn_relu_flops` in
`observability.costs.count_flops`; inside a count, a `meta` tensor only
counts.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from bigdl_tpu_torch.observability import costs

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: columns a kernel thread owns, and the octets of a column group (64
#: columns at most)
_OCTET = 8
_MAX_GROUP_OCTETS = 8
_MAX_THREADS = 256
#: the H100's SMs, and the blocks of the backward an SM holds at once
#: (its launch bounds): the backward's tiling aims at one full wave. A
#: constant, so that the tiling (and so the bits of dscale and dshift)
#: depends on (N, C) alone
_SMS = 132
_BWD_BLOCKS_PER_SM = 4


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


def bn_relu_flops(n: int, c: int, backward: bool) -> int:
    """FLOPs of one launch over [N, C]: 3 an element forward (multiply,
    add, max), 7 backward (the recomputed multiply-add, the mask, dx and
    the two sums)."""
    return (7 if backward else 3) * n * c


class BwdPartition(NamedTuple):
    """How the backward kernel splits an [N, C] matrix: `n_groups` column
    groups of `group_octets` octets (8 columns each; the last group may
    be short) by `n_tiles` row tiles of `tile_rows` rows (the last may be
    short); a block is `group_octets` x `lanes_y` threads."""
    n_groups: int
    group_octets: int
    lanes_y: int
    tile_rows: int
    n_tiles: int


@functools.lru_cache(maxsize=None)
def _layout(n: int, c: int) -> Tuple[int, int, int]:
    """(n_groups, group_octets, lanes_y) of both kernels for [n, c]: the
    octets split evenly into groups of at most 64 columns; row lanes a
    power of 2, as many as fit 256 threads a block, halved (down to a
    warp a block) while a pass of them over the rows would leave SMs
    without a block."""
    octets = -(-c // _OCTET)
    n_groups = -(-octets // _MAX_GROUP_OCTETS)
    group_octets = -(-octets // n_groups)
    lanes_y = 1 << (_MAX_THREADS // group_octets).bit_length() - 1
    while group_octets * lanes_y > 32 and \
            -(-n // lanes_y) * n_groups < _SMS:
        lanes_y //= 2
    return n_groups, group_octets, lanes_y


@functools.lru_cache(maxsize=None)
def bwd_partition(n: int, c: int) -> BwdPartition:
    """The backward's partition of an [n, c] matrix, a function of (n, c)
    alone: `_layout`'s groups and lanes, and row tiles, a multiple of the
    row lanes each, as many as make about one full wave of blocks
    (`_SMS` x `_BWD_BLOCKS_PER_SM`) with the column groups."""
    n_groups, group_octets, lanes_y = _layout(n, c)
    tiles_wanted = max(1, _SMS * _BWD_BLOCKS_PER_SM // n_groups)
    tile_rows = -(-n // tiles_wanted)
    tile_rows = -(-tile_rows // lanes_y) * lanes_y
    return BwdPartition(n_groups, group_octets, lanes_y, tile_rows,
                        -(-n // tile_rows))


# --------------------------------------------------------------------------
# The CUDA kernels (csrc/bn_relu_fwd.cu, csrc/bn_relu_bwd.cu), via ctypes
# --------------------------------------------------------------------------

_FNS = {}
#: per (device index, stream): the backward's ticket counters, one a
#: column group, zero between launches (each launch leaves them at 0)
_TICKETS = {}


def _kernel_fn(name: str):
    fns = _FNS.get(name)
    if fns is None:
        from bigdl_tpu_torch.ops._build import load_kernel
        lib = load_kernel(name)
        fn = getattr(lib, name)
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        if name == "bn_relu_fwd":
            # x, scale, shift, y, n_rows, c, group_octets, lanes_y,
            # x_dtype, y_dtype, relu, stream
            fn.argtypes = [P] * 4 + [L] + [I] * 6 + [P]
        else:
            # x, scale, shift, g, ldg, dx, ds_part, db_part, ds, db,
            # tickets, n_rows, c, group_octets, lanes_y, tile_rows,
            # n_tiles, x_dtype, g_dtype, relu, stream
            fn.argtypes = [P] * 4 + [L] + [P] * 6 + [L] + [I] * 8 + [P]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        fns = _FNS[name] = (fn, err)
    return fns


def _check_2d(name, t, c=None, row_stride=False):
    """t is an [N, C] f32 or bf16 matrix, contiguous, or with
    `row_stride` rows at least C elements apart and unit column stride."""
    if t.dim() != 2:
        raise ValueError(f"{name} must be [N, C], got shape {tuple(t.shape)}")
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if t.shape[0] < 1 or t.shape[1] < 1:
        raise ValueError(f"{name} is empty: shape {tuple(t.shape)}")
    if c is not None and t.shape[1] != c:
        raise ValueError(f"{name} has {t.shape[1]} columns, expected {c}")
    if row_stride:
        if _row_stride(t) is None:
            raise ValueError(
                f"{name} must be an [N, C] view with contiguous rows (unit "
                f"column stride, rows at least C apart), got strides "
                f"{t.stride()}")
    elif not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous [N, C] view (strides "
                         f"{t.stride()}); the kernels never reinterpret "
                         "strides")


def _row_stride(t2) -> Optional[int]:
    """The distance in elements between the rows of an [N, C] matrix whose
    columns are contiguous, or None if its layout is not that."""
    n, c = t2.shape
    if c > 1 and t2.stride(1) != 1:
        return None
    if n == 1:
        return c
    return t2.stride(0) if t2.stride(0) >= c else None


def _rows(t, c) -> Optional[torch.Tensor]:
    """t (any leading rank, C trailing) as an [N, C] matrix with unit
    column stride, without a copy; None where no such view exists."""
    try:
        t2 = t.view(-1, c)
    except RuntimeError:
        return None
    return t2 if _row_stride(t2) is not None else None


def _check_coeffs(x2, scale, shift):
    c = x2.shape[1]
    for name, t in (("scale", scale), ("shift", shift)):
        if t.shape != (c,) or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [{c}] "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
        if t.device != x2.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2.device}")


def _run(name, device, args):
    fn, err_str = _kernel_fn(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                    for a in args], stream)
    if code != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{err_str(code).decode()} (cudaError {code})")


def _tickets(device, n_groups):
    """The backward's ticket counters for the current stream of `device`:
    zeroed once, then left at 0 by every launch."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n_groups:
        t = _TICKETS[key] = torch.zeros(max(n_groups, 64),
                                        dtype=torch.int32, device=device)
    return t


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
    n, c = x2.shape

    def flops():
        return bn_relu_flops(n, c, backward=False)

    if x2.device.type == "cpu":
        return costs.plain_route(flops, bn_relu_forward_plain, x2, scale,
                                 shift, relu, out_dtype)
    if x2.device.type == "meta" and costs.counting():
        costs.tally_kernel(flops)
        return x2.new_empty((n, c), dtype=out_dtype)
    if x2.device.type != "cuda":
        raise NotImplementedError(
            f"no bn_relu forward for device type {x2.device.type!r}")
    _, group_octets, lanes_y = _layout(n, c)
    y2 = torch.empty((n, c), dtype=out_dtype, device=x2.device)
    _run("bn_relu_fwd", x2.device,
         [x2, scale, shift, y2, n, c, group_octets, lanes_y,
          _DTYPE_CODES[x2.dtype], _DTYPE_CODES[out_dtype], int(bool(relu))])
    bn_relu_forward.launches += 1
    costs.tally_kernel(flops)
    return y2


bn_relu_forward.launches = 0


def bn_relu_backward(x2, scale, shift, g2, relu: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused backward: (dx [N, C] f32, dscale [C], dshift [C]) from the
    forward's input x2 (contiguous) and the cotangent g2 [N, C] (f32 or
    bf16, the forward output's dtype; its rows may lie further apart than
    C, as a channel slice's do, its columns contiguous). The CUDA kernel on
    a CUDA tensor, one launch that also sums dscale and dshift over the
    rows; its plain version on a CPU tensor. `bn_relu_backward.launches`
    counts launches."""
    _check_2d("x", x2)
    _check_2d("g", g2, c=x2.shape[1], row_stride=True)
    _check_coeffs(x2, scale, shift)
    if g2.shape[0] != x2.shape[0] or g2.device != x2.device:
        raise ValueError(f"g {tuple(g2.shape)} on {g2.device} does not "
                         f"match x {tuple(x2.shape)} on {x2.device}")
    n, c = x2.shape

    def flops():
        return bn_relu_flops(n, c, backward=True)

    if x2.device.type == "cpu":
        return costs.plain_route(flops, bn_relu_backward_plain, x2, scale,
                                 shift, g2, relu)
    if x2.device.type == "meta" and costs.counting():
        costs.tally_kernel(flops)
        return (x2.new_empty((n, c), dtype=torch.float32),
                scale.new_empty((c,)), scale.new_empty((c,)))
    if x2.device.type != "cuda":
        raise NotImplementedError(
            f"no bn_relu backward for device type {x2.device.type!r}")
    part = bwd_partition(n, c)
    dx = torch.empty((n, c), dtype=torch.float32, device=x2.device)
    parts = torch.empty((2, part.n_tiles, c), dtype=torch.float32,
                        device=x2.device)
    sums = torch.empty((2, c), dtype=torch.float32, device=x2.device)
    tickets = _tickets(x2.device, part.n_groups)
    _run("bn_relu_bwd", x2.device,
         [x2, scale, shift, g2, _row_stride(g2), dx, parts[0], parts[1],
          sums[0], sums[1], tickets, n, c, part.group_octets, part.lanes_y,
          part.tile_rows, part.n_tiles, _DTYPE_CODES[x2.dtype],
          _DTYPE_CODES[g2.dtype], int(bool(relu))])
    bn_relu_backward.launches += 1
    costs.tally_kernel(flops)
    return dx, sums[0], sums[1]


bn_relu_backward.launches = 0


class BnReluFunction(torch.autograd.Function):
    """`bn_relu` with the fused backward: saves (the tensor the kernels
    read, scale, shift), no mask and no pre-activation.
    `BnReluFunction.g_copies` counts the backward calls whose incoming
    gradient could not be read in place as an [N, C] matrix with unit
    column stride and had to be copied first (an NCHW-permuted one; a
    `Concat`'s channel slice is read in place); a `meta` tensor, which
    holds no data, is not counted, as a kernel launch is not."""

    g_copies = 0

    @staticmethod
    def forward(ctx, x, scale, shift, relu: bool, out_dtype, source):
        src = x if source is None else source
        if source is not None and (source.shape != x.shape
                                   or source.device != x.device):
            raise ValueError(
                f"source {tuple(source.shape)} on {source.device} does not "
                f"match x {tuple(x.shape)} on {x.device}")
        if not src.is_contiguous():
            raise ValueError(
                f"bn_relu takes an NHWC-contiguous x (a channels_last "
                f"activation), got strides {src.stride()}")
        c = src.shape[-1]
        y2 = bn_relu_forward(src.view(-1, c), scale, shift, relu, out_dtype)
        ctx.save_for_backward(src, scale, shift)
        ctx.relu = relu
        return y2.view(src.shape)

    @staticmethod
    def backward(ctx, g):
        src, scale, shift = ctx.saved_tensors
        c = src.shape[-1]
        g2 = _rows(g, c)
        if g2 is None:
            if g.device.type != "meta":
                BnReluFunction.g_copies += 1
            g2 = g.contiguous().view(-1, c)
        dx2, ds, db = bn_relu_backward(src.view(-1, c), scale, shift, g2,
                                       ctx.relu)
        return dx2.view(src.shape), ds, db, None, None, None


def bn_relu(x, scale, shift, relu: bool = True,
            out_dtype: Optional[torch.dtype] = None, *,
            source: Optional[torch.Tensor] = None):
    """Fused `activation(x * scale + shift)` over the trailing channel axis
    of an NHWC-contiguous x (any leading rank): the kernels on a CUDA
    tensor, the plain versions on a CPU tensor, with the fused backward in
    both cases. With scale = 1 this is the bias+activation tail.

    `source`: the tensor x was upcast from (the BN layer's bf16 input, of
    which x is the exact f32 copy), NHWC-contiguous. The kernels then read
    it in its own dtype, and the Function saves it in place of x; the
    gradient still goes to x, in f32."""
    return BnReluFunction.apply(
        x, scale, shift, relu, out_dtype or x.dtype,
        None if source is None else source.detach())
