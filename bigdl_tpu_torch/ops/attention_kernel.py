"""Attention: online-softmax blockwise attention and the flash-attention
kernels for Hopper.

Counterpart of `bigdl_tpu/ops/attention_kernel.py`. Layouts are the same:
q, k, v are [B, H, T, D].

- `naive_attention` — reference O(T^2)-memory attention.
- `blockwise_attention` — flash-style attention as a loop over K/V blocks
  carrying (acc, row_max, row_sum); `attention_state_init` /
  `attention_state_finish` expose the carry.
- `flash_attention_forward` — the CUDA kernel `csrc/flash_attention_fwd.cu`
  (O and the per-row logsumexp; bf16 on the tensor cores, f32 on the CUDA
  cores) on a CUDA tensor; on a CPU tensor its plain version
  `flash_attention_forward_plain`, the same online softmax in PyTorch. It
  never falls back: a CUDA tensor launches the kernel or raises.
- `flash_attention_carry` — one ring-attention hop: continue a carried
  (acc, m, l) with one K/V shard at global offsets, the CUDA kernel
  `csrc/flash_attention_carry.cu` on a CUDA tensor, its plain version
  `flash_attention_carry_plain` (`blockwise_attention(..., carry=carry,
  finish=False)`) on a CPU tensor. This kernel and kernel 1's f32 design
  share one tile loop (`csrc/flash_attention_tile.cuh`, CUDA cores).
- `flash_attention_backward` — dq, dk, dv from the saved O and logsumexp:
  `delta = rowsum(dO * O)` in PyTorch, then the CUDA kernels
  `csrc/flash_attention_bwd_dq.cu` (`flash_attention_backward_dq`) and
  `csrc/flash_attention_bwd_dkv.cu` (`flash_attention_backward_dkv`) on a
  CUDA tensor, their plain versions `flash_attention_backward_dq_plain` and
  `flash_attention_backward_dkv_plain` on a CPU tensor.
  `flash_attention_backward_plain` is the two plain versions together, the
  reference the kernels are held against.
- `FlashAttention` — the `torch.autograd.Function` that ties the forward
  kernel to the two backward kernels; `flash_attention` — the router the
  layers call.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def naive_attention(q, k, v, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    mask: Optional[torch.Tensor] = None):
    """Reference O(T^2)-memory attention (for tests, tiny shapes and the
    one-token decode step). `mask` broadcasts against [B, H, Tq, Tk];
    False entries are masked."""
    sm_scale = sm_scale or q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        idx_q = torch.arange(tq, device=s.device)[:, None]
        idx_k = torch.arange(tk, device=s.device)[None, :]
        s = torch.where(idx_q >= idx_k, s, NEG_INF)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def _masked_scores(q, k_blk, sm_scale, causal, q_offset, k_offset):
    """sm_scale * q k_blk^T, [B, H, Tq, Bk], with the causally masked
    pairs at NEG_INF. Offsets are the global positions of q[..., 0, :]
    and k_blk[..., 0, :]."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k_blk) * sm_scale
    if causal:
        tq, bk = s.shape[-2], s.shape[-1]
        gq = torch.arange(tq, device=s.device)[:, None] + q_offset
        gk = torch.arange(bk, device=s.device)[None, :] + k_offset
        s = torch.where(gq >= gk, s, NEG_INF)
    return s


def _block_step(q, k_blk, v_blk, acc, m, l, sm_scale, q_offset, k_offset,
                causal):
    """One online-softmax update of (acc, m, l) with a K/V block.

    q: [B,H,Tq,D]; k_blk/v_blk: [B,H,Bk,D]; acc: [B,H,Tq,D]; m, l:
    [B,H,Tq] running max / normaliser. Offsets are the global positions of
    q[..., 0, :] and k_blk[..., 0, :] for the causal mask."""
    s = _masked_scores(q, k_blk, sm_scale, causal, q_offset, k_offset)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # fully masked rows (m_new == NEG_INF) shift by 0: exp(s - NEG_INF)
    # would overflow
    shift = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
    p = torch.exp(s - shift[..., None])
    scale_old = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - shift))
    l_new = l * scale_old + p.sum(dim=-1)
    acc_new = acc * scale_old[..., None] + torch.einsum("bhqk,bhkd->bhqd",
                                                        p, v_blk)
    return acc_new, m_new, l_new


def attention_state_init(q):
    """Fresh (acc, m, l) accumulators for online-softmax attention."""
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    row = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    return acc, row + NEG_INF, row


def attention_state_finish(acc, m, l):
    """Normalise blockwise partial sums into the attention output."""
    den = torch.where(l == 0.0, 1.0, l)
    return acc / den[..., None]


def blockwise_attention(q, k, v, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        block_k: int = 512, q_offset: int = 0,
                        k_offset: int = 0, carry: Optional[Tuple] = None,
                        finish: bool = True):
    """Flash-style attention as a loop over K/V blocks, math in f32.

    With `carry` / `finish=False` the (acc, m, l) accumulators go in and
    come out, so a caller can continue one softmax across K/V shards. The
    ragged last block is taken at its true length: padded keys never get
    softmax weight."""
    qf, kf, vf = (x.float() for x in (q, k, v))
    sm_scale = sm_scale or q.shape[-1] ** -0.5
    tk = kf.shape[2]
    block_k = min(block_k, tk)
    acc, m, l = carry if carry is not None else attention_state_init(qf)
    for start in range(0, tk, block_k):
        stop = min(start + block_k, tk)
        acc, m, l = _block_step(qf, kf[:, :, start:stop],
                                vf[:, :, start:stop], acc, m, l, sm_scale,
                                q_offset, k_offset + start, causal)
    if not finish:
        return acc, m, l
    return attention_state_finish(acc, m, l).to(q.dtype)


def flash_attention_forward_plain(q, k, v, causal: bool = False,
                                  sm_scale: Optional[float] = None,
                                  q_offset: int = 0, k_offset: int = 0):
    """The plain PyTorch version of the flash forward kernel: O (in q's
    dtype) and the per-row logsumexp [B, H, Tq] (f32). Fully masked rows
    come out as O = 0 and lse = 0, as the kernel's guards give them."""
    acc, m, l = blockwise_attention(q, k, v, causal=causal,
                                    sm_scale=sm_scale, q_offset=q_offset,
                                    k_offset=k_offset, finish=False)
    den = torch.where(l == 0.0, 1.0, l)
    shift = torch.where(m <= NEG_INF / 2, 0.0, m)
    return (acc / den[..., None]).to(q.dtype), shift + torch.log(den)


#: rows of K (dq) or Q (dk, dv) the plain backward takes per block
_PLAIN_BLOCK = 64


def attention_delta(o, do):
    """delta = rowsum(dO * O) in f32, [B, H, Tq]: the backward's per-row
    term, a PyTorch reduction outside the kernels (the JAX package leaves
    it to XLA outside its Pallas kernels)."""
    return (do.float() * o.float()).sum(-1)


def flash_attention_backward_dq_plain(q, k, v, do, lse, delta, causal,
                                      sm_scale, q_offset, k_offset):
    """The plain version of the dq kernel: dq over 64-key blocks, all
    query rows at once; p rebuilt from lse, ds = p * (dO V^T - delta) *
    scale, dq = sum ds K. f32 math, dq in q's dtype."""
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    dq = torch.zeros_like(qf)
    for start in range(0, kf.shape[2], _PLAIN_BLOCK):
        kb = kf[:, :, start:start + _PLAIN_BLOCK]
        vb = vf[:, :, start:start + _PLAIN_BLOCK]
        p = torch.exp(_masked_scores(qf, kb, sm_scale, causal, q_offset,
                                     k_offset + start) - lse[..., None])
        dp = torch.einsum("bhqd,bhkd->bhqk", dof, vb)
        ds = p * (dp - delta[..., None]) * sm_scale
        dq += torch.einsum("bhqk,bhkd->bhqd", ds, kb)
    return dq.to(q.dtype)


def flash_attention_backward_dkv_plain(q, k, v, do, lse, delta, causal,
                                       sm_scale, q_offset, k_offset):
    """The plain version of the dk/dv kernel: dk and dv over 64-query
    blocks, all key rows at once; dv = sum p^T dO, dk = sum ds^T Q. f32
    math, dk and dv in k's dtype."""
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for start in range(0, qf.shape[2], _PLAIN_BLOCK):
        stop = start + _PLAIN_BLOCK
        qb, dob = qf[:, :, start:stop], dof[:, :, start:stop]
        p = torch.exp(_masked_scores(qb, kf, sm_scale, causal,
                                     q_offset + start, k_offset)
                      - lse[:, :, start:stop, None])
        dv += torch.einsum("bhqk,bhqd->bhkd", p, dob)
        dp = torch.einsum("bhqd,bhkd->bhqk", dob, vf)
        ds = p * (dp - delta[:, :, start:stop, None]) * sm_scale
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, qb)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward_plain(q, k, v, o, lse, do, causal: bool = False,
                                   sm_scale: Optional[float] = None,
                                   q_offset: int = 0, k_offset: int = 0):
    """The plain PyTorch version of the flash backward kernels: (dq, dk,
    dv) in the inputs' dtype from q, k, v, the forward's O and f32 lse
    [B, H, Tq], and dO. Blockwise: dq over 64-key blocks, dk and dv over
    64-query blocks, each block's p rebuilt as exp(s - lse), so no score
    matrix wider than one block is built. Masked pairs get p = 0, so a
    fully masked row (lse = 0) contributes nothing."""
    sm_scale = sm_scale or q.shape[-1] ** -0.5
    delta = attention_delta(o, do)
    args = (q, k, v, do, lse, delta, causal, sm_scale, q_offset, k_offset)
    return (flash_attention_backward_dq_plain(*args),
            *flash_attention_backward_dkv_plain(*args))


def flash_attention_carry_plain(q, k, v, carry, causal: bool = False,
                                sm_scale: Optional[float] = None,
                                q_offset: int = 0, k_offset: int = 0):
    """The plain PyTorch version of the carry kernel: the carried f32
    (acc [B, H, Tq, D], m, l [B, H, Tq]) continued with k, v
    [B, H, Tk, D], returned unnormalised."""
    return blockwise_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                               q_offset=q_offset, k_offset=k_offset,
                               carry=carry, finish=False)


# --------------------------------------------------------------------------
# The CUDA kernels (csrc/flash_attention_{fwd,carry,bwd_dq,bwd_dkv}.cu),
# bound through ctypes. Each takes its pointers, then (bh, tq, tk, d,
# sm_scale, causal, q_offset, k_offset, dtype, stream), and returns a
# cudaError code.
# --------------------------------------------------------------------------

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128
#: tensor pointers each kernel takes
_N_PTRS = {"flash_attention_fwd": 5, "flash_attention_carry": 9,
           "flash_attention_bwd_dq": 7, "flash_attention_bwd_dkv": 8}
_FNS = {}


def _kernel_fn(name: str):
    fns = _FNS.get(name)
    if fns is None:
        from bigdl_tpu_torch.ops._build import load_kernel
        lib = load_kernel(name)
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * _N_PTRS[name]
                       + [ctypes.c_int] * 4 + [ctypes.c_float]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        fns = _FNS[name] = (fn, err)
    return fns


def _check_inputs(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, T, D]")
    b, h, _, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtype mismatch: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")


def _check_backward_inputs(q, k, v, do, rows):
    """rows: the [B, H, Tq] f32 tensors (lse, delta), by name."""
    _check_inputs(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dO must match q ({q.dtype} {tuple(q.shape)} on "
                         f"{q.device}), got {do.dtype} {tuple(do.shape)} "
                         f"on {do.device}")
    for name, t in rows.items():
        if t.shape != q.shape[:3] or t.dtype != torch.float32 \
                or t.device != q.device:
            raise ValueError(f"{name} must be float32 {tuple(q.shape[:3])} "
                             f"on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _launch(name, tensors, outs, q, tk, causal, sm_scale, q_offset,
            k_offset):
    """Launch kernel `name` on `tensors` (inputs) and `outs` (outputs,
    already allocated), after the checks every kernel shares."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    b, h, tq, d = q.shape
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {_MAX_HEAD_DIM} is not supported "
                         f"by {name}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous inputs")
    fn, err_str = _kernel_fn(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(*[t.data_ptr() for t in (*tensors, *outs)], b * h, tq, tk,
                  d, float(sm_scale), int(bool(causal)), int(q_offset),
                  int(k_offset), _DTYPE_CODES[q.dtype], stream)
    if code != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{err_str(code).decode()} (cudaError {code})")


def _no_device(q, what):
    return NotImplementedError(
        f"no flash {what} for device type {q.device.type!r}")


def flash_attention_forward(q, k, v, causal: bool = False,
                            sm_scale: Optional[float] = None,
                            return_lse: bool = False, *, q_offset: int = 0,
                            k_offset: int = 0):
    """Flash-attention forward over q [B, H, Tq, D] and k, v [B, H, Tk, D]:
    the CUDA kernel on a CUDA tensor, its plain version on a CPU tensor.
    Ragged Tq / Tk need no padding. `return_lse=True` also returns the
    [B, H, Tq] f32 logsumexp. `q_offset` / `k_offset` are the global
    positions of the first query and key (causal mask only).
    `flash_attention_forward.launches` counts kernel launches. The kernel
    records no backward: inputs that require grad go through
    `flash_attention`."""
    _check_inputs(q, k, v)
    sm_scale = sm_scale or q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            raise NotImplementedError(
                "flash_attention_forward records no backward; call "
                "flash_attention, whose autograd.Function runs the flash "
                "backward kernels, or call this under torch.no_grad()")
        b, h, tq, _ = q.shape
        out = torch.empty_like(q)
        lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
        _launch("flash_attention_fwd", (q, k, v), (out, lse), q, k.shape[2],
                causal, sm_scale, q_offset, k_offset)
        flash_attention_forward.launches += 1
    elif q.device.type == "cpu":
        out, lse = flash_attention_forward_plain(q, k, v, causal, sm_scale,
                                                 q_offset, k_offset)
    else:
        raise _no_device(q, "forward")
    return (out, lse) if return_lse else out


flash_attention_forward.launches = 0


def _check_carry(q, carry):
    if len(carry) != 3:
        raise ValueError("carry must be (acc, m, l)")
    for name, t, shape in zip(("acc", "m", "l"), carry,
                              (q.shape, q.shape[:3], q.shape[:3])):
        if t.shape != shape or t.dtype != torch.float32 \
                or t.device != q.device:
            raise ValueError(f"carry {name} must be float32 {tuple(shape)} "
                             f"on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def flash_attention_carry(q, k, v, carry, causal: bool = False,
                          sm_scale: Optional[float] = None,
                          q_offset: int = 0, k_offset: int = 0, *,
                          inplace: bool = False):
    """One ring-attention hop: continue the online softmax carried in
    `carry` = (acc [B, H, Tq, D], m, l [B, H, Tq], f32, as
    `attention_state_init` makes them) with k, v [B, H, Tk, D] and return
    the updated (acc, m, l), unnormalised; `attention_state_finish`
    normalises after the last hop. `q_offset` / `k_offset` are the global
    positions of the first query and key (causal mask only). The CUDA
    kernel `csrc/flash_attention_carry.cu` on a CUDA tensor (bf16 on the
    tensor cores, f32 on the CUDA cores), its plain version on a CPU
    tensor; `flash_attention_carry.launches` counts kernel launches. Any
    shape is taken (ragged Tq / Tk are masked in the kernel): a CUDA
    tensor launches the kernel or raises. `inplace=True`
    writes the result into the carry's own tensors and returns them. The
    kernel records no backward (ring attention recomputes through the
    plain ring instead)."""
    _check_inputs(q, k, v)
    _check_carry(q, carry)
    sm_scale = sm_scale or q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v, *carry)):
            raise NotImplementedError(
                "flash_attention_carry records no backward; ring attention "
                "differentiates through its plain ring, or call this under "
                "torch.no_grad()")
        outs = carry if inplace else tuple(torch.empty_like(t)
                                           for t in carry)
        _launch("flash_attention_carry", (q, k, v, *carry), outs, q,
                k.shape[2], causal, sm_scale, q_offset, k_offset)
        flash_attention_carry.launches += 1
        return tuple(outs)
    if q.device.type == "cpu":
        outs = flash_attention_carry_plain(q, k, v, carry, causal, sm_scale,
                                           q_offset, k_offset)
        if inplace:
            for t, new in zip(carry, outs):
                t.copy_(new)
            return tuple(carry)
        return outs
    raise _no_device(q, "carry")


flash_attention_carry.launches = 0


def flash_attention_backward_dq(q, k, v, do, lse, delta,
                                causal: bool = False,
                                sm_scale: Optional[float] = None,
                                q_offset: int = 0, k_offset: int = 0):
    """dq in q's dtype from q, k, v, dO, the forward's f32 lse and
    `attention_delta(O, dO)` (both [B, H, Tq]): the CUDA kernel
    `csrc/flash_attention_bwd_dq.cu` on a CUDA tensor, the plain version on
    a CPU tensor. `flash_attention_backward_dq.launches` counts kernel
    launches."""
    _check_backward_inputs(q, k, v, do, {"lse": lse, "delta": delta})
    sm_scale = sm_scale or q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        dq = torch.empty_like(q)
        _launch("flash_attention_bwd_dq", (q, k, v, do, lse, delta), (dq,),
                q, k.shape[2], causal, sm_scale, q_offset, k_offset)
        flash_attention_backward_dq.launches += 1
        return dq
    if q.device.type == "cpu":
        return flash_attention_backward_dq_plain(q, k, v, do, lse, delta,
                                                 causal, sm_scale, q_offset,
                                                 k_offset)
    raise _no_device(q, "backward")


flash_attention_backward_dq.launches = 0


def flash_attention_backward_dkv(q, k, v, do, lse, delta,
                                 causal: bool = False,
                                 sm_scale: Optional[float] = None,
                                 q_offset: int = 0, k_offset: int = 0):
    """(dk, dv) in k's dtype, from the same inputs as
    `flash_attention_backward_dq`: the CUDA kernel
    `csrc/flash_attention_bwd_dkv.cu` on a CUDA tensor, the plain version
    on a CPU tensor. `flash_attention_backward_dkv.launches` counts kernel
    launches."""
    _check_backward_inputs(q, k, v, do, {"lse": lse, "delta": delta})
    sm_scale = sm_scale or q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        _launch("flash_attention_bwd_dkv", (q, k, v, do, lse, delta),
                (dk, dv), q, k.shape[2], causal, sm_scale, q_offset,
                k_offset)
        flash_attention_backward_dkv.launches += 1
        return dk, dv
    if q.device.type == "cpu":
        return flash_attention_backward_dkv_plain(q, k, v, do, lse, delta,
                                                  causal, sm_scale, q_offset,
                                                  k_offset)
    raise _no_device(q, "backward")


flash_attention_backward_dkv.launches = 0


def flash_attention_backward(q, k, v, out, lse, g, causal: bool = False,
                             sm_scale: Optional[float] = None, *,
                             q_offset: int = 0, k_offset: int = 0):
    """(dq, dk, dv) of flash attention from q, k, v, the forward's output
    `out` and f32 lse [B, H, Tq], and the output's gradient `g`: `delta =
    rowsum(g * out)` in PyTorch, then `flash_attention_backward_dq` and
    `flash_attention_backward_dkv` (the kernels on a CUDA tensor, their
    plain versions on a CPU tensor). Ragged Tq / Tk need no padding; the
    offsets are the forward's. It never falls back: a CUDA tensor launches
    both kernels or raises. On the card, bf16 inputs run on the tensor
    cores and f32 inputs on the CUDA cores (see the kernels' sources)."""
    if out.shape != q.shape or out.device != q.device:
        raise ValueError(f"out must have q's shape {tuple(q.shape)} on "
                         f"{q.device}, got {tuple(out.shape)} on "
                         f"{out.device}")
    _check_backward_inputs(q, k, v, g, {"lse": lse})
    delta = attention_delta(out, g)
    args = (q, k, v, g, lse, delta, causal, sm_scale, q_offset, k_offset)
    return (flash_attention_backward_dq(*args),
            *flash_attention_backward_dkv(*args))


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: the forward kernel (O and the
    f32 logsumexp) under no grad, then the dq and dk/dv kernels from the
    saved q, k, v, O and lse (never P). Gradients come back in q's
    dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        with torch.no_grad():
            o, lse = flash_attention_forward(q, k, v, causal, sm_scale,
                                             return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse,
                                              do.contiguous(), ctx.causal,
                                              ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: Optional[float] = None):
    """Flash attention, the layers' entry point. With grad on and an input
    that requires it: `FlashAttention` (forward kernel, then the two
    backward kernels in the backward pass). Otherwise the forward alone.
    CUDA tensors run the kernels, CPU tensors their plain versions; q, k,
    v are made contiguous first (the layers hand over head-split views)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, sm_scale)
    return flash_attention_forward(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal, sm_scale)
