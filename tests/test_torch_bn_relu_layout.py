"""What the fused BN+ReLU tail hands its kernels: x in its own dtype, and
g read with its row stride (`bigdl_tpu_torch/ops/bn_relu_kernel.py`).

- A bf16 activation goes to the kernels as it is (`bn_relu(..., source=)`)
  while its f32 copy, which the BN statistics use, stays the Function's
  differentiable input. The training-mode layer on a bf16 input gives the
  same bits (y, the input's gradient, dweight, dbias, the running stats)
  as the path that hands the kernels the f32 copy: the upcast is exact,
  and autograd still joins dx with the statistics' gradient in f32. The
  layer is also held to the JAX layer's `apply_with_activation` through
  the Pallas kernels in interpret mode (`FORCE_PALLAS`, `INTERPRET`).
- A `Concat`-style channel slice of an NHWC gradient is read in place:
  `BnReluFunction.g_copies` stays put, and the gradients are bitwise those
  of the contiguous copy. A g whose rows are not one [N, C] matrix with
  unit column stride is still copied and counted
  (`tests/test_torch_bn_relu_kernel.py`).

Inputs come from numpy with a fixed seed; on the CPU the wrappers run
their plain versions. Tolerances against JAX, in f32 after the bf16
output: outputs atol 2e-2 (one bf16 ulp at |y| ~ 4, as
`tests/test_torch_resnet.py` holds a bf16 BN); the input's bf16 gradient
within one bf16 ulp (2**-7 relative) plus 1e-6 of its largest element
(the statistics' gradient sums the same f32 terms in another order before
the cast, which may round one element to its neighbour); dweight and
dbias (f32) within 1e-5 of their largest element (the same f32 terms
summed in another order, as `ATOL_SUM` in
`tests/test_torch_bn_relu_kernel.py`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
from bigdl_tpu.nn.module import functional_apply
from bigdl_tpu.ops import bn_relu_kernel as jbk
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.interop import load_module_params, module_state
from bigdl_tpu_torch.ops import bn_relu_kernel as tbk


def _bn_params(c, seed):
    rs = np.random.RandomState(seed)
    return {"weight": (rs.rand(c) + 0.5).astype(np.float32),
            "bias": (rs.randn(c) * 0.3).astype(np.float32)}


def _port_bn(cls, c, params):
    bn = cls(c, device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["weight"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
    return bn.train()


def _run(bn, x, w, fused_path):
    """(y, dx, dweight, dbias, mean, var) of sum(y * w) through
    `forward_with_activation` (fused_path "source") or through the same
    statistics with the f32 copy handed to the kernels ("f32 copy")."""
    xb = x.clone().requires_grad_()
    if fused_path == "source":
        y = bn.forward_with_activation(xb)
    else:
        x32, scale, shift, out_dtype = bn._stats_scale_shift(xb)
        y = tbk.bn_relu(x32, scale, shift, True, out_dtype)
    (y.float() * w).sum().backward()
    return (y.detach(), xb.grad, bn.weight.grad, bn.bias.grad,
            bn.mean.clone(), bn.var.clone())


@pytest.mark.parametrize("cls,shape", [
    (tnn.SpatialBatchNormalization, (2, 4, 4, 16)),
    (tnn.SpatialBatchNormalization, (3, 5, 5, 12)),
    (tnn.BatchNormalization, (32, 24)),
])
def test_bf16_layer_reads_its_input_in_place_with_the_same_bits(
        cls, shape, monkeypatch):
    c = shape[-1]
    params = _bn_params(c, seed=c)
    rs = np.random.RandomState(sum(shape))
    x = torch.from_numpy((rs.randn(*shape) * 2).astype(np.float32)).to(
        torch.bfloat16)
    w = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    seen = []
    fwd, bwd = tbk.bn_relu_forward, tbk.bn_relu_backward

    def seen_fwd(x2, *a, **k):
        seen.append(("fwd", x2.dtype))
        return fwd(x2, *a, **k)

    def seen_bwd(x2, *a, **k):
        seen.append(("bwd", x2.dtype))
        return bwd(x2, *a, **k)
    monkeypatch.setattr(tbk, "bn_relu_forward", seen_fwd)
    monkeypatch.setattr(tbk, "bn_relu_backward", seen_bwd)
    got = _run(_port_bn(cls, c, params), x, w, "source")
    assert seen == [("fwd", torch.bfloat16), ("bwd", torch.bfloat16)]
    seen.clear()
    want = _run(_port_bn(cls, c, params), x, w, "f32 copy")
    assert seen == [("fwd", torch.float32), ("bwd", torch.float32)]
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    for name, a, b in zip(("y", "dx", "dweight", "dbias", "mean", "var"),
                          got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_the_function_saves_the_bf16_source():
    bn = _port_bn(tnn.SpatialBatchNormalization, 8, _bn_params(8, 0))
    x = torch.randn(2, 3, 3, 8).to(torch.bfloat16).requires_grad_()
    y = bn.forward_with_activation(x)
    saved = y.grad_fn.saved_tensors
    assert saved[0].dtype == torch.bfloat16 and saved[0].shape == x.shape
    # an f32 layer input is read and saved as it is
    y32 = bn.forward_with_activation(x.detach().float().requires_grad_())
    assert y32.grad_fn.saved_tensors[0].dtype == torch.float32


def test_source_must_match_x():
    x = torch.randn(2, 3, 3, 4)
    s, b = torch.ones(4), torch.zeros(4)
    with pytest.raises(ValueError, match="source"):
        tbk.bn_relu(x, s, b, source=torch.randn(2, 3, 4, 3).to(
            torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        tbk.bn_relu(x, s, b, source=torch.randn(2, 4, 3, 3).to(
            torch.bfloat16).permute(0, 2, 3, 1))


@pytest.mark.parametrize("shape", [(2, 4, 4, 16), (2, 3, 5, 8)])
def test_bf16_layer_matches_jax_pallas_apply_with_activation(shape,
                                                             monkeypatch):
    """Sequential(SpatialBatchNormalization, ReLU) on a bf16 input in
    training mode: the port's fused tail (reading the bf16 input) against
    the JAX layer's `apply_with_activation` through the Pallas custom_vjp
    in interpret mode; outputs, the input's gradient, dweight, dbias and
    the running stats."""
    monkeypatch.setattr(jbk, "FORCE_PALLAS", True)
    monkeypatch.setattr(jbk, "INTERPRET", True)
    pallas_calls = []
    jfwd = jbk.bn_relu_forward

    def counted(*a, **k):
        pallas_calls.append(1)
        return jfwd(*a, **k)
    monkeypatch.setattr(jbk, "bn_relu_forward", counted)
    c = shape[-1]
    j = jnn.Sequential().add(jnn.SpatialBatchNormalization(c)) \
        .add(jnn.ReLU())
    t = tnn.Sequential().add(tnn.SpatialBatchNormalization(
        c, device="cpu")).add(tnn.ReLU())
    params = jax.tree_util.tree_map(
        np.asarray, j.init(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(c)
    key = "0_SpatialBatchNormalization"
    params[key] = _bn_params(c, seed=c + 1)
    load_module_params(t, params)
    x = (rs.randn(*shape) * 2).astype(np.float32)
    w = rs.randn(*shape).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)

    def f(p, xx):
        out, new = functional_apply(j, p, xx, training=True)
        return jnp.sum(out.astype(jnp.float32) * w), (out, new)
    (_, (out_j, new_j)), (gp_j, gx_j) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, xb)
    assert pallas_calls, "the JAX side did not reach the Pallas kernel"

    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    with tnn.fusion_scope(True):
        out_t = t(xt)
    (out_t.float() * torch.from_numpy(w)).sum().backward()
    assert out_t.dtype == torch.bfloat16 and xt.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(out_t.detach().float().numpy(),
                               np.asarray(out_j, np.float32), atol=2e-2)
    gx_j = np.asarray(gx_j, np.float32)
    gx_t = xt.grad.float().numpy()
    assert (np.abs(gx_t - gx_j) <= 2 ** -7 * np.abs(gx_j)
            + 1e-6 * np.abs(gx_j).max()).all()
    bn = getattr(t, key)
    for name, got in (("weight", bn.weight.grad), ("bias", bn.bias.grad)):
        want = np.asarray(gp_j[key][name])
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-5 * np.abs(want).max())
    state_t = module_state(t)
    for k in ("mean", "var"):
        np.testing.assert_allclose(state_t[(key,)][k],
                                   np.asarray(new_j[(key,)][k]), atol=1e-5)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("gdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset,width", [
    ((2, 3, 3, 8), 5, 20),      # an NHWC branch, an odd offset
    ((2, 4, 4, 16), 16, 48),    # a whole-octet offset
    ((6, 12), 12, 40),          # a 2-D [B, C] slice
])
def test_concat_slice_gradient_is_read_in_place(shape, offset, width, gdt,
                                                relu):
    rs = np.random.RandomState(width + offset)
    c = shape[-1]
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    s = torch.from_numpy((rs.rand(c) + 0.5).astype(np.float32))
    b = torch.from_numpy((rs.randn(c) * 0.5).astype(np.float32))
    full = torch.from_numpy(
        rs.randn(*shape[:-1], width).astype(np.float32)).to(gdt)
    g = full[..., offset:offset + c]
    assert not g.is_contiguous()

    def grads(gg):
        leaves = [t.clone().requires_grad_() for t in (x, s, b)]
        y = tbk.bn_relu(*leaves, relu, gdt)
        return torch.autograd.grad(y, leaves, gg)

    copies = tbk.BnReluFunction.g_copies
    got = grads(g)
    assert tbk.BnReluFunction.g_copies == copies
    want = grads(g.contiguous())
    for a, w_ in zip(got, want):
        assert torch.equal(a, w_)


def test_rows_reads_slices_and_refuses_other_layouts():
    full = torch.randn(2, 3, 3, 20)
    g2 = tbk._rows(full[..., 4:12], 8)
    assert g2.shape == (18, 8) and g2.stride() == (20, 1)
    assert g2.data_ptr() == full[..., 4:12].data_ptr()
    assert tbk._rows(torch.randn(2, 8, 3, 3).permute(0, 2, 3, 1), 8) is None
    assert tbk._rows(torch.ones(()).expand(2, 3, 3, 8), 8) is None
    assert tbk._rows(torch.randn(1, 1, 1, 8)[..., :], 8).stride(1) == 1
    # the backward wrapper takes a row-strided g, not a column-strided one
    x, s, b = torch.randn(18, 8), torch.ones(8), torch.zeros(8)
    dx, ds, db = tbk.bn_relu_backward(x, s, b, g2)
    dx_c, ds_c, db_c = tbk.bn_relu_backward(x, s, b, g2.contiguous())
    assert torch.equal(dx, dx_c) and torch.equal(ds, ds_c) \
        and torch.equal(db, db_c)
    with pytest.raises(ValueError, match="contiguous rows"):
        tbk.bn_relu_backward(x, s, b, torch.randn(8, 18).t())
