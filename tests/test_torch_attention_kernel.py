"""Port parity: `bigdl_tpu_torch.ops.attention_kernel` against
`bigdl_tpu.ops.attention_kernel`.

The flash forward kernel's plain version (what the port runs on a CPU
tensor) is held against the JAX Pallas kernel in interpret mode, and the
router against the JAX router with its Pallas path forced through
`INTERPRET`. Inputs come from numpy with a fixed seed and go to both
frameworks. Tolerance: atol 1e-5 in f32, the same online softmax summed in
another order.

The CUDA kernel itself is held against its plain version on the card by
`tests/test_torch_cuda.py`.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigdl_tpu.ops import attention_kernel as jak
from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops import attention_kernel as tak

ATOL = 1e-5


def _qkv(b, h, tq, tk, d, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, h, tq, d).astype(np.float32)
    k = rs.randn(b, h, tk, d).astype(np.float32)
    v = rs.randn(b, h, tk, d).astype(np.float32)
    return q, k, v


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


class TestPlainFlashForwardVsPallas:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("t,d,block_q,block_k",
                             [(64, 16, 16, 32), (128, 32, 64, 32)])
    def test_o_and_lse_match_interpret_kernel(self, causal, t, d, block_q,
                                              block_k):
        (jq, jk, jv), (q, k, v) = _both(*_qkv(2, 2, t, t, d, seed=t))
        o_j, lse_j = jak.flash_attention_forward(
            jq, jk, jv, causal=causal, block_q=block_q, block_k=block_k,
            interpret=True, return_lse=True)
        o_t, lse_t = tak.flash_attention_forward(q, k, v, causal=causal,
                                                 return_lse=True)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=ATOL)
        np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                                   atol=ATOL)

    def test_explicit_scale(self):
        (jq, jk, jv), (q, k, v) = _both(*_qkv(1, 2, 32, 32, 16, seed=3))
        o_j = jak.flash_attention_forward(jq, jk, jv, causal=True,
                                          sm_scale=0.3, block_q=16,
                                          block_k=16, interpret=True)
        o_t = tak.flash_attention_forward(q, k, v, causal=True,
                                          sm_scale=0.3)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=ATOL)


class TestRouter:
    @pytest.mark.parametrize("causal,tq,tk", [
        (True, 64, 64), (False, 64, 64),      # tiled: Pallas interpret
        (True, 40, 40), (False, 40, 40),      # ragged T
        (False, 24, 40), (True, 40, 24)])     # Tq != Tk
    def test_router_matches_jax(self, causal, tq, tk, monkeypatch):
        monkeypatch.setattr(jak, "INTERPRET", True)
        (jq, jk, jv), (q, k, v) = _both(*_qkv(2, 2, tq, tk, 16, seed=tq))
        out_j = jak.flash_attention(jq, jk, jv, causal)
        out_t = tak.flash_attention(q, k, v, causal)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                                   atol=ATOL)

    def test_router_takes_head_split_views(self):
        q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 16, 16, 8))
        qt = q.transpose(1, 2).contiguous().transpose(1, 2)  # strided view
        assert not qt.is_contiguous()
        torch.testing.assert_close(tak.flash_attention(qt, k, v, True),
                                   tak.flash_attention(q, k, v, True))

    def test_fully_masked_rows_are_zero_with_zero_lse(self):
        """Keys placed after every query: rows 0..15 see nothing. The
        guards give O = 0 and lse = 0 there, as in the JAX kernels."""
        (jq, jk, jv), (q, k, v) = _both(*_qkv(1, 2, 32, 32, 16, seed=5))
        o_t, lse_t = tak.flash_attention_forward(
            q, k, v, causal=True, return_lse=True, k_offset=16)
        o_j = jak.blockwise_attention(jq, jk, jv, causal=True, k_offset=16,
                                      block_k=8)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=ATOL)
        assert (o_t[:, :, :16] == 0).all() and (lse_t[:, :, :16] == 0).all()
        assert (lse_t[:, :, 16:] != 0).all()

    def test_naive_fully_masked_row_matches_jax(self):
        """naive_attention's masked row is a softmax over NEG_INF alone:
        uniform weights, in both frameworks."""
        (jq, jk, jv), (q, k, v) = _both(*_qkv(1, 1, 4, 6, 8, seed=6))
        mask = np.ones((1, 1, 4, 6), bool)
        mask[0, 0, 1] = False
        out_j = jak.naive_attention(jq, jk, jv, mask=jnp.asarray(mask))
        out_t = tak.naive_attention(q, k, v, mask=torch.from_numpy(mask))
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                                   atol=ATOL)

    @pytest.mark.parametrize("causal", [False, True])
    def test_naive_and_blockwise_agree(self, causal):
        (jq, jk, jv), (q, k, v) = _both(*_qkv(2, 2, 24, 40, 8, seed=7))
        ref = np.asarray(jak.naive_attention(jq, jk, jv, causal=causal))
        naive = tak.naive_attention(q, k, v, causal=causal)
        block = tak.blockwise_attention(q, k, v, causal=causal, block_k=16)
        np.testing.assert_allclose(naive.numpy(), ref, atol=ATOL)
        np.testing.assert_allclose(block.numpy(), ref, atol=ATOL)

    def test_carry_continues_softmax_across_shards(self):
        (jq, jk, jv), (q, k, v) = _both(*_qkv(1, 2, 32, 32, 8, seed=8))
        state_t = tak.attention_state_init(q)
        state_j = jak.attention_state_init(jq)
        for off in (0, 16):
            sl = slice(off, off + 16)
            state_t = tak.blockwise_attention(
                q, k[:, :, sl], v[:, :, sl], causal=True, k_offset=off,
                block_k=8, carry=state_t, finish=False)
            state_j = jak.blockwise_attention(
                jq, jk[:, :, sl], jv[:, :, sl], causal=True, k_offset=off,
                block_k=8, carry=state_j, finish=False)
        for got, want in zip(state_t, state_j):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(
            tak.attention_state_finish(*state_t).numpy(),
            np.asarray(jak.naive_attention(jq, jk, jv, causal=True)),
            atol=ATOL)

    def test_bf16_plain_matches_jax_blockwise(self):
        q, k, v = _qkv(1, 2, 32, 32, 16, seed=9)
        jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
        tq_, tk_, tv_ = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
        out_t = tak.flash_attention(tq_, tk_, tv_, True)
        out_j = jak.blockwise_attention(jq, jk, jv, causal=True)
        assert out_t.dtype == torch.bfloat16
        # same f32 math on the same bf16 inputs; outputs rounded to bf16
        np.testing.assert_allclose(out_t.float().numpy(),
                                   np.asarray(out_j, np.float32), atol=1e-2)


class TestWrapper:
    def test_cpu_tensors_never_count_as_launches(self):
        before = tak.flash_attention_forward.launches
        q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 8, 8, 8))
        tak.flash_attention_forward(q, k, v, causal=True)
        assert tak.flash_attention_forward.launches == before

    def test_rejects_bad_inputs(self):
        q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 8, 8, 8))
        with pytest.raises(ValueError):
            tak.flash_attention_forward(q, k[:, :1], v[:, :1])
        with pytest.raises(ValueError):
            tak.flash_attention_forward(q, k.double(), v)
        with pytest.raises(ValueError):
            tak.flash_attention_forward(q[0], k[0], v[0])
        with pytest.raises(NotImplementedError):
            tak.flash_attention_forward(q.to("meta"), k.to("meta"),
                                        v.to("meta"))

    def test_build_without_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build_kernels()

    def test_library_name_follows_the_source(self, monkeypatch, tmp_path):
        src = tmp_path / "k.cu"
        src.write_text("// a")
        monkeypatch.setattr(_build, "CSRC", tmp_path)
        first = _build._lib_path("k")
        src.write_text("// b")
        assert _build._lib_path("k") != first
        with pytest.raises(FileNotFoundError):
            _build._lib_path("missing")


def _bf16_round(x):
    return x.bfloat16().float()


LOG2E = 1.4426950408889634


def _tensor_core_loop(q, k, v, acc, m, l, sm_scale, split, causal=True,
                      q_offset=0, k_offset=0, block_k=64):
    """The arithmetic of the bf16 loop that kernels 1 and 2 share
    (csrc/flash_attention_tc_tile.cuh) on a state (acc, m, l), m in log2
    units: bf16 operands; S = Q K^T summed in f32 in 16-deep steps; the
    online softmax over 64-key tiles in f32, in log2 units; acc += P V in
    16-key steps with P as bf16 hi + bf16 lo (`split`) or rounded once to
    bf16 (not `split`). A key tile that a row cannot see leaves its state
    exactly as it was, so the kernel's causal tile skipping needs no
    emulation."""
    qf, kf, vf = (x.float() for x in (q, k, v))
    d = q.shape[-1]
    neg = tak.NEG_INF
    rows = torch.arange(q.shape[2])[:, None] + q_offset
    for k0 in range(0, kf.shape[2], block_k):
        kb, vb = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        s = torch.zeros(q.shape[:3] + (kb.shape[2],))
        for c in range(0, d, 16):
            s = s + qf[..., c:c + 16] @ kb[..., c:c + 16].transpose(-1, -2)
        x = s * (sm_scale * LOG2E)
        if causal:
            cols = torch.arange(k0, k0 + kb.shape[2])[None] + k_offset
            x = torch.where(rows >= cols, x, neg)
        mx = torch.maximum(m, x.amax(-1))
        shift = torch.where(mx <= neg / 2, 0.0, mx)
        scale_old = torch.where(m <= neg / 2, 0.0, torch.exp2(m - shift))
        p = torch.exp2(x - shift[..., None])
        l = l * scale_old + p.sum(-1)
        acc = acc * scale_old[..., None]
        hi = _bf16_round(p)
        lo = _bf16_round(p - hi)
        for c in range(0, kb.shape[2], 16):
            acc = acc + hi[..., c:c + 16] @ vb[:, :, c:c + 16]
            if split:
                acc = acc + lo[..., c:c + 16] @ vb[:, :, c:c + 16]
        m = mx
    return acc, m, l


def _emulate_tensor_core_forward(q, k, v, sm_scale, split):
    """Kernel 1's bf16 design (csrc/flash_attention_fwd.cu), causal, from
    a fresh state: O = acc / l rounded to bf16, lse in f32."""
    acc, m, l = _tensor_core_loop(q, k, v, *tak.attention_state_init(
        q.float()), sm_scale, split)
    den = torch.where(l == 0, 1.0, l)
    shift = torch.where(m <= tak.NEG_INF / 2, 0.0, m)
    return (acc / den[..., None]).bfloat16(), shift * math.log(2) \
        + torch.log(den)


def _emulate_tensor_core_carry(q, k, v, carry, sm_scale, split, causal,
                               q_offset, k_offset):
    """Kernel 2's bf16 design (csrc/flash_attention_carry.cu): the loop
    continued from a carried (acc, m, l) whose m is in natural-log units,
    converted to log2 units on load and back on store (NEG_INF kept
    exact); a 64-row q tile that sees no key of the shard passes the
    carry through untouched."""
    neg = tak.NEG_INF
    acc, m, l = (x.clone() for x in carry)
    m2 = torch.where(m <= neg / 2, neg, m * LOG2E)
    acc2, m2, l2 = _tensor_core_loop(q, k, v, acc, m2, l, sm_scale, split,
                                     causal, q_offset, k_offset)
    m_out = torch.where(m2 <= neg / 2, neg, m2 * math.log(2))
    for q0 in range(0, q.shape[2], 64):
        if causal and q_offset + q0 + 63 < k_offset:
            continue  # n_kb == 0: the carry stays as it came
        sl = slice(q0, q0 + 64)
        acc[:, :, sl], m[:, :, sl], l[:, :, sl] = (
            acc2[:, :, sl], m_out[:, :, sl], l2[:, :, sl])
    return acc, m, l


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_split_bf16_arithmetic_meets_the_kernel_limits(seed):
    """Why kernel 1's bf16 design splits P into two bf16 halves: at B2 H4
    T256 D64 causal (bf16 inputs from numpy), the emulated split stays
    within phase 3's limits against the plain version (O 2e-2, lse 1e-4,
    absolute) and within phase 9(b)'s per-element limit (2**-7 |ref| +
    1e-4 max|ref|) against the f32-P result, which ring and zigzag
    attention (kernel 2) give; one bf16 rounding of P breaks the latter
    (PERF.md records the shares; run with -s to print them)."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(2, 4, 256, 256, 64, seed=seed))
    sm = 64 ** -0.5
    o_ref, lse_ref = tak.flash_attention_forward_plain(q, k, v, True, sm)
    want = o_ref.float()
    lim = 2 ** -7 * want.abs() + 1e-4 * want.abs().max()
    shares = {}
    for split in (True, False):
        o, lse = _emulate_tensor_core_forward(q, k, v, sm, split)
        shares[split] = (float((o.float() - want).abs().max() / 2e-2),
                         float((lse - lse_ref).abs().max() / 1e-4),
                         float(((o.float() - want).abs() / lim).max()))
    print(f"seed {seed}: share of the limits (phase 3 O, phase 3 lse, "
          f"phase 9(b)): split hi+lo {shares[True]}, rounded once "
          f"{shares[False]}")
    assert max(shares[True]) <= 1.0
    assert shares[False][2] > 1.0


CARRY_TOL = 1e-5


def _carry_shares(got, want):
    """Shares of phase 9(a)'s limit (acc within CARRY_TOL * max|plain|, m
    and l within CARRY_TOL * max(|plain|, 1) per element)."""
    shares = [float((got[0] - want[0]).abs().max()
                    / (CARRY_TOL * want[0].abs().max()))]
    for a, b in zip(got[1:], want[1:]):
        shares.append(float(((a - b).abs()
                             / (CARRY_TOL * b.abs().clamp(min=1))).max()))
    return shares


def _bf16_carry_case(b, h, tq, tk, d, masked_rows, seed):
    """bf16 q, k, v and a carry from the plain non-causal hop over other
    keys, with the first `masked_rows` rows still fully masked."""
    q, k0, v0 = (torch.from_numpy(a).bfloat16()
                 for a in _qkv(b, h, tq, tk, d, seed=seed))
    _, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(b, h, tq, tk, d, seed=seed + 100))
    acc, m, l = tak.flash_attention_carry_plain(q, k0, v0,
                                                tak.attention_state_init(q))
    acc[:, :, :masked_rows] = 0
    m[:, :, :masked_rows] = tak.NEG_INF
    l[:, :, :masked_rows] = 0
    return q, k, v, (acc, m, l)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name,tq,tk,q_offset,k_offset,masked", [
    ("below the diagonal", 384, 192, 0, 192, 0),
    ("diagonal", 256, 256, 256, 256, 0),
    ("rows still fully masked", 128, 128, 0, 16, 32)])
def test_carry_split_bf16_arithmetic_meets_the_carry_limit(
        seed, name, tq, tk, q_offset, k_offset, masked):
    """Why kernel 2's bf16 design splits P into two bf16 halves, as kernel
    1's does: on a carried (acc, m, l), causal at B2 H4 D64 (bf16 inputs
    from numpy), the emulated split stays within phase 9(a)'s carry limit
    against the plain version on acc, m and l; P rounded once to bf16
    does not. Rows that see no key in this hop and came in fully masked
    leave as (NEG_INF, 0, 0) exactly. (PERF.md records the shares; run
    with -s to print them.)"""
    q, k, v, carry = _bf16_carry_case(2, 4, tq, tk, 64, masked, seed)
    kw = dict(causal=True, q_offset=q_offset, k_offset=k_offset)
    want = tak.flash_attention_carry_plain(q, k, v, carry,
                                           sm_scale=64 ** -0.5, **kw)
    shares = {}
    for split in (True, False):
        got = _emulate_tensor_core_carry(q, k, v, carry, 64 ** -0.5, split,
                                         **kw)
        shares[split] = _carry_shares(got, want)
        if masked:  # rows 0-15 see no key here either
            assert (got[1][:, :, :16] == tak.NEG_INF).all()
            assert (got[2][:, :, :16] == 0).all()
            assert (got[0][:, :, :16] == 0).all()
    print(f"{name}, seed {seed}: share of the carry limit (acc, m, l): "
          f"split hi+lo {shares[True]}, rounded once {shares[False]}")
    assert max(shares[True]) <= 1.0
    assert shares[False][0] > 1.0


def test_carry_emulation_passes_a_future_shard_through_bitwise():
    """A shard wholly in the queries' future: no q tile sees a key, so the
    carry comes back bit for bit. m's trip through log2 units would not
    give it back: that is why the kernel skips the trip there."""
    q, k, v, carry = _bf16_carry_case(2, 4, 192, 192, 64, 0, seed=2)
    got = _emulate_tensor_core_carry(q, k, v, carry, 64 ** -0.5, True,
                                     causal=True, q_offset=0, k_offset=192)
    assert all(torch.equal(a, b) for a, b in zip(got, carry))
    m = carry[1]
    assert not torch.equal(m * LOG2E * math.log(2), m)


@pytest.mark.parametrize("name,kind", [
    ("void (anonymous namespace)::flash_fwd_tc_kernel<64>((anonymous "
     "namespace)::TileArgs<__nv_bfloat16>, int)",
     "flash_attention_fwd (csrc, kernel 1)"),
    ("void (anonymous namespace)::flash_fwd_kernel<64>((anonymous "
     "namespace)::TileArgs<float>)", "flash_attention_fwd (csrc, kernel 1)"),
    ("void (anonymous namespace)::flash_carry_tc_kernel<64>((anonymous "
     "namespace)::TileArgs<__nv_bfloat16>, int)",
     "flash_attention_carry (csrc, kernel 2)"),
    ("void (anonymous namespace)::flash_carry_kernel<64>((anonymous "
     "namespace)::TileArgs<float>)", "flash_attention_carry (csrc, kernel 2)"),
    ("void (anonymous namespace)::flash_attention_bwd_dq_tc_kernel<64>(",
     "flash_attention_bwd_dq (csrc, kernel 3)"),
    ("void (anonymous namespace)::stem_conv_tc_kernel<4>(__nv_bfloat16 "
     "const*", "stem_conv (csrc, kernel 5)"),
    ("void (anonymous namespace)::stem_conv_kernel<float, float, 4>(",
     "stem_conv (csrc, kernel 5)")])
def test_profile_names_both_designs_of_each_kernel(name, kind):
    """`tools/bench.py --profile` files the tensor-core and the CUDA-core
    design of a kernel under that kernel, by the names the profiler
    gives them."""
    from bigdl_tpu_torch.tools import bench
    assert bench._kind(name) == kind
