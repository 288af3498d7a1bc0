"""Port parity: `bigdl_tpu_torch.ops.bn_relu_kernel` against
`bigdl_tpu.ops.bn_relu_kernel`.

The plain forward and backward (what the port runs on a CPU tensor) are
held against the JAX Pallas kernels in interpret mode at the reference's
boundary shapes, and the port's autograd Function against `jax.grad`
through the Pallas custom_vjp (`FORCE_PALLAS`) and against torch autograd
of the unfused expression. Inputs come from numpy with a fixed seed.

Tolerances: forward atol 1e-6 in f32 (the same two roundings; only an FMA
contraction could differ) and one bf16 ulp relative (2**-8) where the
output is bf16; dx atol 1e-6 (the same product); dscale/dshift atol 1e-5
(sums of up to a few hundred terms of size ~1 in another order).

The CUDA kernels themselves are held against the plain versions on the
card by `tests/test_torch_cuda.py` and `chip_smoke.py`; here their
partition of the matrix is checked (`bwd_partition`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.ops import bn_relu_kernel as jbk
from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops import bn_relu_kernel as tbk

SHAPES = [(7, 5), (1, 129), (2, 12), (16, 130)]
OUT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}
ATOL_SUM = 1e-5


def _inputs(n, c, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, c).astype(np.float32)
    scale = (rs.rand(c) + 0.5).astype(np.float32)
    shift = (rs.randn(c) * 0.5).astype(np.float32)
    g = rs.randn(n, c).astype(np.float32)
    return x, scale, shift, g


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("n,c", SHAPES)
def test_plain_forward_matches_interpret_kernel(n, c, out, relu):
    x, s, b, _ = _inputs(n, c, seed=n * c)
    jdt, tdt = OUT[out]
    y_j = jbk.bn_relu_forward(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                              relu=relu, out_dtype=jdt, interpret=True)
    y_t = tbk.bn_relu_forward(*_t(x, s, b), relu=relu, out_dtype=tdt)
    assert y_t.dtype == tdt
    rtol = 2.0 ** -8 if out == "bf16" else 0
    np.testing.assert_allclose(_np(y_t), np.asarray(y_j, np.float32),
                               rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("gdt", ["f32", "bf16"])
@pytest.mark.parametrize("n,c", SHAPES)
def test_plain_backward_matches_interpret_kernel(n, c, gdt, relu):
    x, s, b, g = _inputs(n, c, seed=n + c)
    jdt, tdt = OUT[gdt]
    dx_j, ds_j, db_j = jbk.bn_relu_backward(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
        jnp.asarray(g).astype(jdt), relu=relu, interpret=True)
    xt, st, bt, gt = _t(x, s, b, g)
    dx_t, ds_t, db_t = tbk.bn_relu_backward(xt, st, bt, gt.to(tdt), relu)
    assert dx_t.dtype == torch.float32
    np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j), atol=1e-6)
    np.testing.assert_allclose(ds_t.numpy(), np.asarray(ds_j),
                               atol=ATOL_SUM)
    np.testing.assert_allclose(db_t.numpy(), np.asarray(db_j),
                               atol=ATOL_SUM)


#: ResNet-50 b128's eight fused sites, the zoo's three (Inception-v2 b32
#: at 7x7 C=352 and 28x28 C=96, VggForCifar10's [32, 512]), a data-parallel
#: rank's b64 stem, and ragged shapes
PARTITION_SHAPES = [
    (1605632, 64), (401408, 64), (401408, 128), (100352, 128),
    (100352, 256), (25088, 256), (25088, 512), (6272, 512),
    (1568, 352), (25088, 96), (32, 512), (802816, 64),
    (7, 5), (1, 129), (2, 12), (16, 130), (100, 3), (1000, 2049)]


@pytest.mark.parametrize("n,c", PARTITION_SHAPES)
def test_backward_tiles_cover_every_row(n, c):
    """The backward's partition (row tiles x column groups, and each
    thread's octet of columns within its group, as the kernel maps them)
    covers every (row, column) exactly once, leaves no tile or group
    empty, keeps a block within 256 threads with power-of-2 row lanes,
    and depends on (N, C) alone; the reference's own tile-size quirks do
    not carry over."""
    part = tbk.bwd_partition(n, c)
    tbk.bwd_partition.cache_clear()
    tbk._layout.cache_clear()
    assert tbk.bwd_partition(n, c) == part
    ng, go, ly, tr, nt = part
    assert go * ly <= 256 and ly & (ly - 1) == 0 and 1 <= go <= 8
    assert tr % ly == 0 and (nt - 1) * tr < n <= nt * tr
    rows = np.zeros(n, np.int64)
    for t in range(nt):
        rows[t * tr:min((t + 1) * tr, n)] += 1
    assert (rows == 1).all()
    cols = np.zeros(c, np.int64)
    for grp in range(ng):
        owned = [col for tx in range(go) for col in
                 range((grp * go + tx) * 8, (grp * go + tx + 1) * 8)
                 if col < c]
        assert owned, f"column group {grp} is empty"
        cols[owned] += 1
    assert (cols == 1).all()
    # enough blocks for every SM wherever a warp a block allows it
    warps = n * -(-c // 8) // 32
    assert nt * ng >= min(tbk._SMS, warps)
    # the forward's blocks take the same column groups and row lanes
    assert tbk._layout(n, c) == (ng, go, ly)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_function_grads_match_jax_pallas_vjp(out, relu, monkeypatch):
    """Gradients of sum(y * w) through the port's Function against
    `jax.grad` through `bn_relu_pallas` (the Pallas custom_vjp, interpret
    mode), for x [2, 3, 4, 6] and its coefficients."""
    monkeypatch.setattr(jbk, "FORCE_PALLAS", True)
    rs = np.random.RandomState(5)
    x = rs.randn(2, 3, 4, 6).astype(np.float32)
    s = (rs.rand(6) + 0.5).astype(np.float32)
    b = rs.randn(6).astype(np.float32)
    w = rs.randn(2, 3, 4, 6).astype(np.float32)
    jdt, tdt = OUT[out]

    def f(x_, s_, b_):
        y = jbk.bn_relu(x_, s_, b_, relu, jdt)
        return jnp.sum(y.astype(jnp.float32) * w)

    gj = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (x, s, b)))
    xt, st, bt = (t.requires_grad_() for t in _t(x, s, b))
    y = tbk.bn_relu(xt, st, bt, relu, tdt)
    (y.float() * torch.from_numpy(w)).sum().backward()
    for t, j in zip((xt, st, bt), gj):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   atol=ATOL_SUM)


@pytest.mark.parametrize("relu", [True, False])
def test_function_grads_match_torch_autograd_of_unfused(relu):
    """The fused backward against autograd through `(x*s + b)` and
    `torch.relu`, which has the same zero gradient at 0."""
    rs = np.random.RandomState(6)
    x, s, b, w = (rs.randn(*shape).astype(np.float32)
                  for shape in ((3, 5, 5, 8), (8,), (8,), (3, 5, 5, 8)))
    wt = torch.from_numpy(w)
    fused = [t.requires_grad_() for t in _t(x, s, b)]
    (tbk.bn_relu(*fused, relu) * wt).sum().backward()
    ref = [t.requires_grad_() for t in _t(x, s, b)]
    y = ref[0] * ref[1] + ref[2]
    ((torch.relu(y) if relu else y) * wt).sum().backward()
    for a, r in zip(fused, ref):
        np.testing.assert_allclose(a.grad.numpy(), r.grad.numpy(),
                                   atol=ATOL_SUM)


def test_function_copies_a_strided_gradient_and_counts_it():
    x = torch.randn(2, 3, 3, 4, requires_grad=True)
    s, b = torch.ones(4), torch.zeros(4)
    y = tbk.bn_relu(x, s, b)
    before = tbk.BnReluFunction.g_copies
    g = torch.randn(2, 4, 3, 3).permute(0, 2, 3, 1)  # NCHW-contiguous
    y.backward(g)
    assert tbk.BnReluFunction.g_copies == before + 1
    np.testing.assert_allclose(x.grad.numpy(),
                               (g * (x > 0)).detach().numpy(), atol=1e-7)


def test_wrappers_check_their_inputs():
    x, s, b = torch.randn(4, 6), torch.ones(6), torch.zeros(6)
    with pytest.raises(ValueError, match="contiguous"):
        tbk.bn_relu_forward(x.t(), torch.ones(4), torch.zeros(4))
    with pytest.raises(ValueError, match="scale"):
        tbk.bn_relu_forward(x, torch.ones(5), b)
    with pytest.raises(TypeError):
        tbk.bn_relu_forward(x.half(), s, b)
    with pytest.raises(ValueError, match="columns"):
        tbk.bn_relu_backward(x, s, b, torch.randn(4, 5))
    with pytest.raises(ValueError, match="empty"):
        tbk.bn_relu_forward(torch.zeros(0, 6), s, b)
    nhwc = torch.randn(2, 6, 2, 2).permute(0, 2, 3, 1)  # not channels_last
    with pytest.raises(ValueError, match="contiguous"):
        tbk.bn_relu(nhwc, s, b)


def test_plain_route_never_counts_a_launch():
    f0, b0 = tbk.bn_relu_forward.launches, tbk.bn_relu_backward.launches
    x = torch.randn(5, 3, requires_grad=True)
    tbk.bn_relu(x, torch.ones(3), torch.zeros(3)).sum().backward()
    assert (tbk.bn_relu_forward.launches, tbk.bn_relu_backward.launches) \
        == (f0, b0)


def test_kernels_are_listed_for_the_build():
    assert {"bn_relu_fwd", "bn_relu_bwd"} <= set(_build.KERNELS)
    for name in ("bn_relu_fwd", "bn_relu_bwd"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int {name}(' in src
        assert "__fmul_rn" in src and "__fadd_rn" in src
