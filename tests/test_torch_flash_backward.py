"""Port parity: the flash-attention backward of
`bigdl_tpu_torch.ops.attention_kernel` against
`bigdl_tpu.ops.attention_kernel`.

- `flash_attention_backward_plain` (the dq and dk/dv plain versions that
  the port runs on a CPU tensor) against the JAX `flash_attention_backward`, its two Pallas kernels run
  in interpret mode, at block sizes that divide T, on the same q, k, v, O,
  lse and dO;
- the gradients of the port's router `flash_attention` (through the
  `FlashAttention` autograd.Function) against `jax.grad` of the JAX
  `flash_attention` with its Pallas path forced through `INTERPRET`, at
  ragged T where the JAX package pads, and at Tq != Tk where it takes its
  XLA path;
- a bf16 case against JAX blockwise autodiff.

Inputs come from numpy with a fixed seed. Tolerances: f32 atol
1e-5 * max|JAX| + 1e-6 (the same f32 terms summed in another order); bf16
atol 2e-2 * max|JAX| (both compute in f32 from the same bf16 inputs and
round the gradients to bf16, one ulp near the max is 2**-8 relative; the
forward's O, rounded to bf16 before delta, adds as much again).

The CUDA kernels themselves are held against the plain version on the card
by `tests/test_torch_cuda.py` and `chip_smoke.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.ops import attention_kernel as jak
from bigdl_tpu_torch.ops import attention_kernel as tak


def _arrays(b, h, tq, tk, d, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, h, tq, d).astype(np.float32)
    k = rs.randn(b, h, tk, d).astype(np.float32)
    v = rs.randn(b, h, tk, d).astype(np.float32)
    do = rs.randn(b, h, tq, d).astype(np.float32)
    return q, k, v, do


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * np.abs(want).max() + 1e-6)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,d,block_q,block_k",
                         [(64, 16, 16, 32), (128, 32, 64, 32)])
def test_plain_backward_matches_interpret_kernels(causal, t, d, block_q,
                                                  block_k):
    q, k, v, do = _arrays(1, 2, t, t, d, seed=t + d)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    o, lse = jak.flash_attention_forward(jq, jk, jv, causal=causal,
                                         block_q=block_q, block_k=block_k,
                                         interpret=True, return_lse=True)
    want = jak.flash_attention_backward(jq, jk, jv, o, lse, jdo,
                                        causal=causal, block_q=block_q,
                                        block_k=block_k, interpret=True)
    got = tak.flash_attention_backward_plain(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.from_numpy(np.array(o)), torch.from_numpy(np.array(lse)),
        torch.from_numpy(do), causal)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("causal,tq,tk", [
    (True, 64, 64),      # tiled: no padding
    (True, 100, 100),    # ragged: JAX pads to 104
    (True, 300, 300),    # ragged: JAX pads q to 512, k to 304
    (False, 24, 40),     # Tq != Tk on the Pallas path
    (False, 20, 36)])    # Tq != Tk, ragged keys: JAX's XLA path
def test_router_gradients_match_jax(causal, tq, tk, monkeypatch):
    monkeypatch.setattr(jak, "INTERPRET", True)
    q, k, v, do = _arrays(1, 2, tq, tk, 16, seed=tq + tk)

    def jloss(q_, k_, v_):
        return jnp.sum(jak.flash_attention(q_, k_, v_, causal)
                       * jnp.asarray(do))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq_, tk_, tv_ = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tak.flash_attention(tq_, tk_, tv_, causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, (tq_, tk_, tv_), torch.from_numpy(do))
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_bf16_gradients_match_jax_blockwise_autodiff():
    q, k, v, do = _arrays(1, 2, 96, 96, 16, seed=11)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))

    def jloss(q_, k_, v_):
        o = jak.blockwise_attention(q_, k_, v_, causal=True, block_k=32)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(do))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq_, tk_, tv_ = (torch.from_numpy(a).bfloat16().requires_grad_()
                     for a in (q, k, v))
    out = tak.flash_attention(tq_, tk_, tv_, True)
    got = torch.autograd.grad(out, (tq_, tk_, tv_),
                              torch.from_numpy(do).bfloat16())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _close(g.float().numpy(), np.asarray(w, np.float32), rel=2e-2)


def test_strided_incoming_gradient():
    """A loss that reads O through a transpose hands the Function a
    non-contiguous dO; the gradients equal naive attention's."""
    q, k, v, do = _arrays(2, 2, 40, 40, 8, seed=3)
    w = torch.from_numpy(do).transpose(1, 2).contiguous()
    grads = []
    for fn in (tak.flash_attention, tak.naive_attention):
        xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        (fn(*xs, True).transpose(1, 2) * w).sum().backward()
        grads.append([x.grad for x in xs])
    for g, w_ in zip(*grads):
        _close(g.numpy(), w_.numpy())


def test_fully_masked_rows_get_zero_dq():
    """Queries placed before every key (q_offset = -16): the forward gives
    O = 0, lse = 0 there, and the backward dq = 0, no NaN."""
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(1, 2, 48, 48, 8, 4))
    o, lse = tak.flash_attention_forward(q, k, v, True, return_lse=True,
                                         q_offset=-16)
    dq, dk, dv = tak.flash_attention_backward(q, k, v, o, lse, do, True,
                                              q_offset=-16)
    assert (dq[:, :, :16] == 0).all()
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))
    assert (dq[:, :, 16:] != 0).any()


def test_router_without_grad_runs_the_forward_alone():
    q, k, v, _ = (torch.from_numpy(a) for a in _arrays(1, 1, 16, 16, 8, 5))
    assert tak.flash_attention(q, k, v, True).grad_fn is None
    with torch.no_grad():
        out = tak.flash_attention(q.requires_grad_(), k, v, True)
    assert out.grad_fn is None


def test_cpu_tensors_never_count_as_launches():
    counters = (tak.flash_attention_forward, tak.flash_attention_backward_dq,
                tak.flash_attention_backward_dkv)
    before = [f.launches for f in counters]
    xs = [torch.from_numpy(a).requires_grad_()
          for a in _arrays(1, 1, 16, 16, 8, 6)[:3]]
    tak.flash_attention(*xs, True).sum().backward()
    assert [f.launches for f in counters] == before


def test_backward_rejects_bad_inputs():
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(1, 2, 8, 8, 8, 7))
    o, lse = tak.flash_attention_forward(q, k, v, return_lse=True)
    delta = tak.attention_delta(o, do)
    with pytest.raises(ValueError, match="dO"):
        tak.flash_attention_backward(q, k, v, o, lse, do[:, :1])
    with pytest.raises(ValueError, match="lse"):
        tak.flash_attention_backward(q, k, v, o, lse.double(), do)
    with pytest.raises(ValueError, match="delta"):
        tak.flash_attention_backward_dq(q, k, v, do, lse, delta[..., :4])
    meta = [t.to("meta") for t in (q, k, v, do, lse, delta)]
    for fn in (tak.flash_attention_backward_dq,
               tak.flash_attention_backward_dkv):
        with pytest.raises(NotImplementedError, match="meta"):
            fn(*meta)


def _bf16_round(x):
    return x.bfloat16().float()


def _emulate_tensor_core_backward(q, k, v, do, lse, delta, sm_scale, split):
    """The arithmetic of the bf16 kernels 3-4 (csrc/flash_attention_bwd_
    {dq,dkv}.cu), causal: bf16 operands, f32 sums; P and dS are f32 and
    enter their products as bf16 hi + bf16 lo (`split`) or rounded once
    to bf16 (not `split`). Gradients rounded to bf16 at the end."""
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    tq, tk = q.shape[2], k.shape[2]
    seen = torch.arange(tq)[:, None] >= torch.arange(tk)[None, :]
    s = qf @ kf.transpose(-1, -2)
    p = torch.where(seen, torch.exp(s * sm_scale - lse[..., None]), 0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None]) * sm_scale

    def times(a, b):  # a @ b with a in bf16 (hi + lo, or hi alone)
        hi = _bf16_round(a)
        return hi @ b + (_bf16_round(a - hi) @ b if split else 0.0)

    dq = times(ds, kf)
    dk = times(ds.transpose(-1, -2), qf)
    dv = times(p.transpose(-1, -2), dof)
    return tuple(g.bfloat16() for g in (dq, dk, dv))


def _share_of_limit(got, want):
    """The largest share of chip_smoke.py phase 7's per-element limit,
    |got - want| <= 2**-7 |want| + 1e-4 max|want|, that `got` takes."""
    got, want = got.float(), want.float()
    lim = 2 ** -7 * want.abs() + 1e-4 * want.abs().max()
    return float(((got - want).abs() / lim).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_split_bf16_arithmetic_meets_the_kernel_limit(seed):
    """Why kernels 3-4 split P and dS into two bf16 halves: at B2 H4 T256
    D64 causal (bf16 inputs from numpy), the emulated split stays within
    the per-element limit that holds the kernels to their plain versions
    on the card; one bf16 rounding of P and dS breaks it (PERF.md records
    both shares; run with -s to print them)."""
    q, k, v, do = (torch.from_numpy(a).bfloat16()
                   for a in _arrays(2, 4, 256, 256, 64, seed))
    o, lse = tak.flash_attention_forward_plain(q, k, v, True)
    delta = tak.attention_delta(o, do)
    sm = 64 ** -0.5
    args = (q, k, v, do, lse, delta, True, sm, 0, 0)
    want = (tak.flash_attention_backward_dq_plain(*args),
            *tak.flash_attention_backward_dkv_plain(*args))
    shares = {}
    for split in (True, False):
        got = _emulate_tensor_core_backward(q, k, v, do, lse, delta, sm,
                                            split)
        shares[split] = [_share_of_limit(g, w) for g, w in zip(got, want)]
    print(f"seed {seed}: share of the limit (dq, dk, dv): split hi+lo "
          f"{shares[True]}, rounded once {shares[False]}")
    assert max(shares[True]) <= 1.0
    assert max(shares[False]) > 1.0
