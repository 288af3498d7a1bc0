"""Attention: online-softmax blockwise attention and the flash-attention
forward kernel for Hopper.

Counterpart of `bigdl_tpu/ops/attention_kernel.py`. Layouts are the same:
q, k, v are [B, H, T, D].

- `naive_attention` — reference O(T^2)-memory attention.
- `blockwise_attention` — flash-style attention as a loop over K/V blocks
  carrying (acc, row_max, row_sum); `attention_state_init` /
  `attention_state_finish` expose the carry.
- `flash_attention_forward` — the CUDA kernel `csrc/flash_attention_fwd.cu`
  (O and the per-row logsumexp) on a CUDA tensor; on a CPU tensor its plain
  version `flash_attention_forward_plain`, the same online softmax in
  PyTorch. It never falls back: a CUDA tensor launches the kernel or raises.
- `flash_attention` — the router the layers call (forward only; the
  backward kernels are not ported yet).
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


def _block_step(q, k_blk, v_blk, acc, m, l, sm_scale, q_offset, k_offset,
                causal):
    """One online-softmax update of (acc, m, l) with a K/V block.

    q: [B,H,Tq,D]; k_blk/v_blk: [B,H,Bk,D]; acc: [B,H,Tq,D]; m, l:
    [B,H,Tq] running max / normaliser. Offsets are the global positions of
    q[..., 0, :] and k_blk[..., 0, :] for the causal mask."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k_blk) * sm_scale
    if causal:
        tq, bk = s.shape[-2], s.shape[-1]
        gq = torch.arange(tq, device=s.device)[:, None] + q_offset
        gk = torch.arange(bk, device=s.device)[None, :] + k_offset
        s = torch.where(gq >= gk, s, NEG_INF)
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


# --------------------------------------------------------------------------
# The CUDA kernel (csrc/flash_attention_fwd.cu), bound through ctypes
# --------------------------------------------------------------------------

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128
_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        from bigdl_tpu_torch.ops._build import load_kernel
        lib = load_kernel("flash_attention_fwd")
        fn = lib.flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_float] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = lib.flash_attention_fwd_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _FN = (fn, err)
    return _FN


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


def _launch(q, k, v, causal, sm_scale, q_offset, k_offset):
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the flash forward kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {_MAX_HEAD_DIM} is not supported "
                         "by the flash forward kernel")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the flash forward kernel takes contiguous q, k, v")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "the flash backward kernels are not ported yet; call the "
            "forward kernel under torch.no_grad()/inference_mode()")
    fn, err_str = _kernel_fn()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), b * h, tq, tk, d, float(sm_scale),
                  int(bool(causal)), int(q_offset), int(k_offset),
                  _DTYPE_CODES[q.dtype], stream)
    if code != 0:
        raise RuntimeError("flash_attention_fwd launch failed: "
                           f"{err_str(code).decode()} (cudaError {code})")
    flash_attention_forward.launches += 1
    return o, lse


def flash_attention_forward(q, k, v, causal: bool = False,
                            sm_scale: Optional[float] = None,
                            return_lse: bool = False, q_offset: int = 0,
                            k_offset: int = 0):
    """Flash-attention forward over q [B, H, Tq, D] and k, v [B, H, Tk, D]:
    the CUDA kernel on a CUDA tensor, its plain version on a CPU tensor.
    Ragged Tq / Tk need no padding. `return_lse=True` also returns the
    [B, H, Tq] f32 logsumexp. `q_offset` / `k_offset` are the global
    positions of the first query and key (causal mask only).
    `flash_attention_forward.launches` counts kernel launches."""
    _check_inputs(q, k, v)
    sm_scale = sm_scale or q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        out, lse = _launch(q, k, v, causal, sm_scale, q_offset, k_offset)
    elif q.device.type == "cpu":
        out, lse = flash_attention_forward_plain(q, k, v, causal, sm_scale,
                                                 q_offset, k_offset)
    else:
        raise NotImplementedError(
            f"no flash forward for device type {q.device.type!r}")
    return (out, lse) if return_lse else out


flash_attention_forward.launches = 0


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: Optional[float] = None):
    """Flash attention, forward only: the CUDA kernel on a CUDA tensor (q,
    k, v made contiguous first: the layers hand over head-split views), the
    plain online-softmax version on a CPU tensor."""
    return flash_attention_forward(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal, sm_scale)
