"""Port parity: int8 post-training quantization (`bigdl_tpu_torch.nn.
quantized`, `tensor.quantized`, `nn.conv.SpatialDilatedConvolution`)
against `bigdl_tpu`.

- Each layer, from the same seeded float weights carried into both
  packages, on the same numpy inputs: the int8 weights and f32 scales
  bitwise; full-int8 and weight-only outputs within 1e-6 * max|ref| in f32
  (in practice the same bits: the int32 sums are exact and the epilogue
  is the same f32 arithmetic) and 1e-2 in bf16; the float
  `SpatialDilatedConvolution` within 1e-6.
- `QuantizedTensor` (per channel, per tensor, `matmul_t`) within 1e-6.
- The reference's own cases (`tests/test_quantized.py`) on the port, one
  parametrised test; `Quantizer` leaving the space-to-depth stem float;
  `int8_mm`'s zero padding (M <= 16, K = 147) equal to an int32 matmul.
- A CIFAR ResNet-8 quantized both ways in both packages: the trees' keys
  and int8 leaves equal, the port's forward within 1e-6 (full int8) and
  1e-5 (weight-only: f32 convolutions summed in another order) of the
  JAX package's, the JAX tree carried into the port and back; a
  checkpoint round trip bit for bit with int8 leaves stored as int8, and
  the JAX package loading the port's checkpoint within 1e-6.
- The engine against offline predict (`tests/test_serving.py:402-412`):
  every row bitwise, both schemes.
- `tools/bench.py --model int8_serving` at LeNet scale and
  `tools/quantized_inference.py` at a small `--n`, on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
from bigdl_tpu.models.resnet import ResNet as JResNet
from bigdl_tpu.nn.quantized import Quantizer as JQuantizer
from bigdl_tpu.serialization import checkpoint as jckpt
from bigdl_tpu.tensor.quantized import QuantizedTensor as JQuantizedTensor
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.dataset import Sample
from bigdl_tpu_torch.interop import (load_module_params, module_params_tree,
                                     module_state)
from bigdl_tpu_torch.models import ResNet as TResNet
from bigdl_tpu_torch.nn.quantized import Quantizer, int8_mm
from bigdl_tpu_torch.optim import SGD, LocalPredictor
from bigdl_tpu_torch.serialization.checkpoint import (load_checkpoint,
                                                      save_checkpoint)
from bigdl_tpu_torch.serving import InferenceEngine
from bigdl_tpu_torch.tensor import QuantizedTensor

#: |port - JAX| <= TOL * max|JAX| per dtype
TOL = {"f32": 1e-6, "bf16": 1e-2}


def rel_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-8)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _tree_np(tree):
    return {k: _tree_np(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


# ------------------------------------------------------------------ layers

#: name -> (JAX class, port class, positional args, keywords, input HWC)
LAYERS = {
    "linear": ("Linear", (64, 40), {}, (64,)),
    "linear_odd": ("Linear", (6, 10), {}, (6,)),
    "conv3x3": ("SpatialConvolution", (8, 16, 3, 3, 1, 1, 1, 1), {},
                (10, 9, 8)),
    "grouped_strided": ("SpatialConvolution", (8, 16, 3, 3, 2, 2, 1, 1),
                        {"n_group": 2}, (9, 9, 8)),
    "stem_7x7_s2": ("SpatialConvolution", (3, 16, 7, 7, 2, 2, 3, 3),
                    {"with_bias": False}, (12, 14, 3)),
    "shortcut_1x1_s2": ("SpatialConvolution", (16, 32, 1, 1, 2, 2, 0, 0),
                        {"with_bias": False}, (8, 8, 16)),
    "pointwise_1x1": ("SpatialConvolution", (16, 24, 1, 1), {}, (5, 6, 16)),
    "dilated_same_grouped": ("SpatialDilatedConvolution",
                             (4, 6, 3, 3, 1, 1, -1, -1, 2, 2),
                             {"n_group": 2}, (9, 10, 4)),
}


def _same_weights(j, t, seed=0):
    """Seeded numpy weights in the JAX tree's shapes (the port's tree, so
    no JAX init runs), set on the JAX layer `j` and carried into the port
    layer `t`; returns the tree."""
    rs = np.random.RandomState(seed)
    params = {k: (rs.randn(*v.shape) * (0.1 if k == "bias" else 0.3)
                  ).astype(np.float32)
              for k, v in module_params_tree(t).items()}
    j.set_params(jax.tree_util.tree_map(jnp.asarray, params))
    load_module_params(t, params)
    return params


def _pair(name, seed=0):
    """(JAX float layer, port float layer) with the same seeded weights
    and a non-zero bias."""
    cls, args, kw, _ = LAYERS[name]
    j = getattr(jnn, cls)(*args, **kw)
    t = getattr(tnn, cls)(*args, **kw, device="cpu")
    _same_weights(j, t, seed)
    return j, t


def _x(name, batch=3, seed=1):
    return np.random.RandomState(seed).randn(
        batch, *LAYERS[name][3]).astype(np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("weight_only", [False, True],
                         ids=["full", "weight_only"])
@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_matches_jax(name, weight_only, dtype):
    j, t = _pair(name)
    jq = JQuantizer._convert(j, j.parameters(), weight_only)
    tq = Quantizer._convert(t, None, weight_only)
    assert type(tq).__name__ == type(jq).__name__
    jp = jq.parameters()
    np.testing.assert_array_equal(tq.weight.numpy(), np.asarray(jp["weight"]))
    assert tq.weight.dtype == torch.int8
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jp["scale"]))
    x = _x(name)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x)
    if dtype == "bf16":
        tx = tx.bfloat16()
    want = jq.forward(jx)
    with torch.inference_mode():
        got = tq(tx)
    assert str(got.dtype) == f"torch.{want.dtype}"
    assert tuple(got.shape) == tuple(want.shape)
    assert rel_err(_np(got), _np(want)) <= TOL[dtype]


def test_quantized_dilated_alias_matches_jax():
    """`QuantizedSpatialDilatedConvolution.from_float` of a dilated layer
    in both packages: the same class, dilation and output."""
    j, t = _pair("dilated_same_grouped")
    jq = jnn.QuantizedSpatialDilatedConvolution.from_float(j, j.parameters())
    tq = tnn.QuantizedSpatialDilatedConvolution.from_float(t)
    assert (tq.dh, tq.dw) == (jq.dh, jq.dw) == (2, 2)
    x = _x("dilated_same_grouped")
    with torch.inference_mode():
        got = tq(torch.from_numpy(x))
    assert rel_err(_np(got), _np(jq.forward(jnp.asarray(x)))) <= TOL["f32"]


@pytest.mark.parametrize("pad,groups,dil", [(0, 1, 2), (-1, 2, 2),
                                            ("SAME", 1, 3), (1, 1, 1)])
def test_spatial_dilated_convolution_matches_jax(pad, groups, dil):
    """The float atrous layer: outputs and input gradients within 1e-6,
    the reference's `dil_w` / `dil_h` attributes, the HWIO carry."""
    j = jnn.SpatialDilatedConvolution(4, 6, 3, 3, 1, 1, pad, pad, dil, dil,
                                      n_group=groups)
    t = tnn.SpatialDilatedConvolution(4, 6, 3, 3, 1, 1, pad, pad, dil, dil,
                                      n_group=groups, device="cpu")
    assert (t.dil_w, t.dil_h) == (j.dil_w, j.dil_h) == (dil, dil)
    params = _same_weights(j, t, 3)
    np.testing.assert_array_equal(module_params_tree(t)["weight"],
                                  params["weight"])
    x = _x("dilated_same_grouped", seed=4)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want, vjp = jax.vjp(lambda xx: j.apply(jp, xx, None), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = t(tx)
    assert got.shape == want.shape
    assert rel_err(_np(got), _np(want)) <= TOL["f32"]
    g = np.random.RandomState(5).randn(*want.shape).astype(np.float32)
    got.backward(torch.from_numpy(g))
    assert rel_err(_np(tx.grad), _np(vjp(jnp.asarray(g))[0])) <= TOL["f32"]


# ------------------------------------------------------------- the tensor

@pytest.mark.parametrize("channel_axis", [0, 1, None])
def test_quantized_tensor_matches_jax(channel_axis):
    rs = np.random.RandomState(6)
    w = rs.randn(24, 20).astype(np.float32)
    x = rs.randn(5, 20).astype(np.float32)
    jq = JQuantizedTensor.from_float(w, channel_axis)
    tq = QuantizedTensor.from_float(w, channel_axis)
    np.testing.assert_array_equal(tq.data.numpy(), np.asarray(jq.data))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    assert tq.nElement() == jq.nElement() == 480
    assert tq.shape == jq.shape and repr(tq) == repr(jq)
    assert rel_err(_np(tq.dequantize()), jq.dequantize()) <= TOL["f32"]
    if channel_axis == 1:
        with pytest.raises(ValueError, match="channel_axis"):
            tq.matmul_t(x)
        return
    assert rel_err(_np(tq.matmul_t(x)), jq.matmul_t(jnp.asarray(x))) \
        <= TOL["f32"]


@pytest.mark.parametrize("m,k,n", [(1, 147, 64), (16, 152, 10), (17, 6, 3),
                                   (40, 64, 1000)])
def test_int8_mm_pads_to_an_exact_product(m, k, n):
    """Zero rows to 32 where M <= 16, K and N to multiples of 8: the same
    int32 values as an int32 matmul, cut back to [M, N]."""
    rs = np.random.RandomState(m + k + n)
    a = torch.from_numpy(rs.randint(-127, 128, (m, k)).astype(np.int8))
    b = torch.from_numpy(rs.randint(-127, 128, (k, n)).astype(np.int8))
    before = int8_mm.launches
    got = int8_mm(a, b)
    assert int8_mm.launches == before + 1
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    torch.testing.assert_close(got, a.int() @ b.int(), rtol=0, atol=0)


# --------------------------------------------------- the reference's cases

def _toy(jax_side=False):
    nn_ = jnn if jax_side else tnn
    kw = {} if jax_side else {"device": "cpu"}
    return (nn_.Sequential()
            .add(nn_.SpatialConvolution(1, 8, 3, 3, 1, 1, 1, 1, **kw))
            .add(nn_.ReLU())
            .add(nn_.SpatialMaxPooling(2, 2, 2, 2))
            .add(nn_.Reshape([8 * 7 * 7]))
            .add(nn_.Linear(8 * 7 * 7, 10, **kw))
            .add(nn_.LogSoftMax()))


def _linear_close_to_fp32():
    rs = np.random.RandomState(0)
    m = tnn.Linear(64, 32, device="cpu")
    x = torch.from_numpy(rs.randn(8, 64).astype(np.float32))
    q = tnn.QuantizedLinear.from_float(m)
    assert rel_err(_np(q(x)), _np(m(x))) < 0.02


def _conv_close_to_fp32(n_group=1, stride=1, shape=(2, 10, 10, 8)):
    rs = np.random.RandomState(1)
    m = tnn.SpatialConvolution(8, 16, 3, 3, stride, stride, 1, 1,
                               n_group=n_group, device="cpu")
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    q = tnn.QuantizedSpatialConvolution.from_float(m)
    assert rel_err(_np(q(x)), _np(m(x))) < 0.03


def _weight_bytes_4x_smaller(weight_only):
    m = tnn.Linear(256, 256, device="cpu")
    cls = tnn.WeightOnlyQuantizedLinear if weight_only \
        else tnn.QuantizedLinear
    q = cls.from_float(m)
    assert m.weight.numpy().nbytes == 4 * q.weight.numpy().nbytes


def _swaps_types_and_keys():
    """The converted children's types and their `<i>_Quantized<name>`
    keys, in place and in order, equal the JAX package's."""
    j, t = _toy(True), _toy()
    j.set_params(jax.tree_util.tree_map(jnp.asarray, module_params_tree(t)))
    jq, tq = JQuantizer.quantize(j), Quantizer.quantize(t)
    types = [type(c).__name__ for c in tq.children()]
    assert types == [type(c).__name__ for c in jq.children]
    assert "QuantizedSpatialConvolution" in types
    assert "QuantizedLinear" in types
    assert "SpatialConvolution" not in types and "Linear" not in types
    assert list(tq._modules) == list(jq._child_keys)
    assert list(tq._modules)[0] == "0_QuantizedSpatialConvolution"


def _argmax_agrees_on_toy():
    rs = np.random.RandomState(3)
    m = _toy().eval()
    x = torch.from_numpy((rs.rand(4, 14, 14, 1) * 2 - 1).astype(np.float32))
    want = _np(m(x))
    got = _np(m.quantize()(x))
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    assert np.abs(got - want).max() < 0.15


def _top_level_layer():
    q = Quantizer.quantize(tnn.Linear(6, 4, device="cpu"))
    assert type(q).__name__ == "QuantizedLinear"


def _original_left_intact():
    m = (tnn.Sequential().add(tnn.Linear(8, 16, device="cpu"))
         .add(tnn.ReLU())
         .add(tnn.Sequential().add(tnn.Linear(16, 4, device="cpu"))))
    before = [type(c).__name__ for c in m.children()]
    x = torch.from_numpy(
        np.random.RandomState(0).randn(4, 8).astype(np.float32))
    want = m.eval()(x).detach().clone()
    q = Quantizer.quantize(m)
    assert q is not m
    assert [type(c).__name__ for c in m.children()] == before
    assert type(list(q.children())[0]).__name__ == "QuantizedLinear"
    assert type(list(list(q.children())[2].children())[0]).__name__ \
        == "QuantizedLinear"
    assert all(p.requires_grad for p in m.parameters())
    torch.testing.assert_close(m(x), want, rtol=0, atol=0)


def _weight_only_tighter_than_full():
    rs = np.random.RandomState(3)
    m = tnn.Linear(64, 32, device="cpu")
    x = torch.from_numpy(rs.randn(8, 64).astype(np.float32))
    want = _np(m(x))
    err_wo = rel_err(_np(tnn.WeightOnlyQuantizedLinear.from_float(m)(x)),
                     want)
    err_full = rel_err(_np(tnn.QuantizedLinear.from_float(m)(x)), want)
    assert err_wo < 0.01 and err_wo <= err_full


def _weight_only_conv_close():
    rs = np.random.RandomState(4)
    m = tnn.SpatialConvolution(8, 16, 3, 3, 1, 1, 1, 1, device="cpu")
    x = torch.from_numpy(rs.randn(2, 10, 10, 8).astype(np.float32))
    wo = tnn.WeightOnlyQuantizedSpatialConvolution.from_float(m)
    assert rel_err(_np(wo(x)), _np(m(x))) < 0.01


def _compute_dtype_follows_input():
    wo = tnn.WeightOnlyQuantizedLinear.from_float(
        tnn.Linear(16, 8, device="cpu"))
    assert wo.weight.dtype == torch.int8
    assert wo(torch.ones(2, 16, dtype=torch.bfloat16)).dtype == \
        torch.bfloat16


def _weight_only_walk():
    rs = np.random.RandomState(5)
    m = (tnn.Sequential()
         .add(tnn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1, device="cpu"))
         .add(tnn.ReLU()).add(tnn.Reshape([8 * 6 * 6]))
         .add(tnn.Linear(8 * 6 * 6, 10, device="cpu")))
    q = Quantizer.quantize(m, weight_only=True)
    kinds = [type(c).__name__ for c in q.children()]
    assert kinds[0] == "WeightOnlyQuantizedSpatialConvolution"
    assert kinds[-1] == "WeightOnlyQuantizedLinear"
    x = torch.from_numpy(rs.randn(2, 6, 6, 3).astype(np.float32))
    assert rel_err(_np(q(x)), _np(m(x))) < 0.01


def _module_quantize_keyword():
    m = tnn.Linear(8, 4, device="cpu")
    q = m.quantize(weight_only=True)
    assert type(q).__name__ == "WeightOnlyQuantizedLinear"
    assert type(m).__name__ == "Linear"


REFERENCE_CASES = {
    "linear_close_to_fp32": _linear_close_to_fp32,
    "conv_close_to_fp32": _conv_close_to_fp32,
    "grouped_strided_conv": lambda: _conv_close_to_fp32(2, 2, (2, 9, 9, 8)),
    "weight_bytes_4x_smaller": lambda: _weight_bytes_4x_smaller(False),
    "weight_only_bytes_4x_smaller": lambda: _weight_bytes_4x_smaller(True),
    "swaps_types_and_keys": _swaps_types_and_keys,
    "argmax_agrees_on_toy": _argmax_agrees_on_toy,
    "top_level_layer": _top_level_layer,
    "original_left_intact": _original_left_intact,
    "weight_only_tighter_than_full": _weight_only_tighter_than_full,
    "weight_only_conv_close": _weight_only_conv_close,
    "compute_dtype_follows_input": _compute_dtype_follows_input,
    "weight_only_walk": _weight_only_walk,
    "module_quantize_keyword": _module_quantize_keyword,
}


@pytest.mark.parametrize("case", list(REFERENCE_CASES))
def test_reference_case(case):
    """`tests/test_quantized.py`'s cases, on the port."""
    with torch.inference_mode():
        REFERENCE_CASES[case]()


def test_quantizer_leaves_the_s2d_stem_float():
    """Only exact `SpatialConvolution`s convert: the space-to-depth stem
    (a subclass) stays float, as in the reference."""
    m = tnn.Sequential().add(tnn.SpaceToDepthStemConvolution(
        3, 8, device="cpu")).add(tnn.ReLU()).add(
        tnn.SpatialConvolution(8, 8, 3, 3, 1, 1, 1, 1, device="cpu"))
    for weight_only in (False, True):
        kinds = [type(c).__name__ for c in
                 Quantizer.quantize(m, weight_only).children()]
        assert kinds[0] == "SpaceToDepthStemConvolution"
        assert kinds[2].endswith("QuantizedSpatialConvolution")


# --------------------------------------------------- the slice as a whole

@pytest.fixture(scope="module")
def resnet8():
    """A CIFAR ResNet-8 with randomized BN state in both packages (the
    port's carried from the JAX one), eval mode, and one input."""
    jm = JResNet(10, depth=8, data_set="cifar10")
    tm = TResNet(10, depth=8, data_set="cifar10", device="cpu")
    rs = np.random.RandomState(7)
    params = module_params_tree(tm)  # the JAX tree's layout, no JAX init

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else
                ((rs.rand(*v.shape) + 0.5).astype(np.float32)
                 if k == "weight" and v.ndim == 1 else
                 (rs.randn(*v.shape) * 0.1).astype(np.float32)
                 if k == "bias" else v)
                for k, v in t.items()}

    params = walk(params)
    state = {p: {"mean": (rs.randn(*np.shape(s["mean"])) * 0.1).astype(
                     np.float32),
                 "var": (rs.rand(*np.shape(s["var"])) + 0.5).astype(
                     np.float32)}
             for p, s in module_state(tm).items()}
    jm.set_params(jax.tree_util.tree_map(jnp.asarray, params))
    jm._state = {p: {k: jnp.asarray(v) for k, v in s.items()}
                 for p, s in state.items()}
    jm.evaluate()
    load_module_params(tm, params, state)
    x = rs.randn(2, 16, 16, 3).astype(np.float32)
    return jm, tm.eval(), x


@pytest.mark.parametrize("weight_only", [False, True],
                         ids=["full", "weight_only"])
def test_resnet_quantized_matches_jax(resnet8, weight_only):
    jm, tm, x = resnet8
    jq = JQuantizer.quantize(jm, weight_only=weight_only)
    tq = Quantizer.quantize(tm, weight_only=weight_only)
    jtree = _tree_np(jq.ensure_params())
    ttree = module_params_tree(tq)

    def same(a, b, path=""):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k], f"{path}.{k}")
            else:
                assert a[k].dtype == b[k].dtype, f"{path}.{k}"
                np.testing.assert_array_equal(a[k], b[k])

    same(ttree, jtree)
    assert module_state(tq).keys() == jq._state.keys()
    want = jq.forward(jnp.asarray(x), training=False)
    with torch.inference_mode():
        got = tq(torch.from_numpy(x))
    assert rel_err(_np(got), _np(want)) <= (1e-5 if weight_only else 1e-6)
    # the JAX tree carried into a port quantized twin built from other
    # weights, and back
    other = Quantizer.quantize(
        TResNet(10, depth=8, data_set="cifar10", device="cpu",
                generator=torch.Generator().manual_seed(1)),
        weight_only=weight_only)
    load_module_params(other, jtree, _tree_np_state(jq._state))
    same(module_params_tree(other), jtree)
    with torch.inference_mode():
        torch.testing.assert_close(other.eval()(torch.from_numpy(x)), got,
                                   rtol=0, atol=0)


def _tree_np_state(state):
    return {p: {k: np.asarray(v) for k, v in s.items()}
            for p, s in state.items()}


def test_quantized_checkpoint_round_trip(resnet8, tmp_path):
    """`save_checkpoint` / `load_checkpoint` of a full-int8 ResNet-8: int8
    leaves stored as int8 (a float widening would store them as f32),
    loaded back bit for bit; the JAX package loads the same checkpoint
    into its quantized twin and forwards within 1e-6 of the port."""
    jm, tm, x = resnet8
    tq = Quantizer.quantize(tm)
    ckpt = save_checkpoint(str(tmp_path), tq, module_params_tree(tq),
                           module_state(tq), SGD(), tag="q")
    params, state, _ = load_checkpoint(ckpt)
    stem = params["0_QuantizedSpatialConvolution"]
    assert stem["weight"].dtype == np.int8
    assert stem["scale"].dtype == np.float32
    back = Quantizer.quantize(TResNet(
        10, depth=8, data_set="cifar10", device="cpu",
        generator=torch.Generator().manual_seed(2)))
    load_module_params(back, params, state)
    for (n, a), (_, b) in zip(tq.state_dict().items(),
                              back.state_dict().items()):
        assert a.dtype == b.dtype, n
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with torch.inference_mode():
        got = tq(torch.from_numpy(x))
    jparams, jstate, _ = jckpt.load_checkpoint(ckpt)
    jq = JQuantizer.quantize(jm)
    jq.set_params(jax.tree_util.tree_map(jnp.asarray, jparams))
    jq._state = {p: {k: jnp.asarray(v) for k, v in s.items()}
                 for p, s in jstate.items()}
    want = jq.forward(jnp.asarray(x), training=False)
    assert rel_err(_np(got), _np(want)) <= TOL["f32"]


def _mlp():
    return (tnn.Sequential().add(tnn.Linear(6, 16, device="cpu"))
            .add(tnn.ReLU()).add(tnn.Linear(16, 3, device="cpu"))
            .add(tnn.LogSoftMax()))


def _cnn():
    return (tnn.Sequential()
            .add(tnn.SpatialConvolution(3, 8, 3, 3, 2, 2, 1, 1,
                                        device="cpu"))
            .add(tnn.ReLU()).add(tnn.Reshape([8 * 3 * 3]))
            .add(tnn.Linear(8 * 3 * 3, 4, device="cpu"))
            .add(tnn.LogSoftMax()))


@pytest.mark.parametrize("weight_only", [False, True],
                         ids=["full", "weight_only"])
@pytest.mark.parametrize("build,shape", [(_mlp, (6,)), (_cnn, (6, 6, 3))],
                         ids=["mlp", "cnn"])
def test_engine_matches_offline_predict(build, shape, weight_only):
    """Both schemes quantize per sample, so the engine's padded batch of 8
    gives offline predict's rows bit for bit."""
    q = Quantizer.quantize(build(), weight_only=weight_only)
    rs = np.random.RandomState(0)
    samples = [Sample(rs.rand(*shape).astype(np.float32)) for _ in range(6)]
    ref = LocalPredictor(q, batch_size=6, convert=False,
                         device="cpu").predict(samples)
    eng = InferenceEngine(q, max_batch_size=8, max_wait_ms=25.0,
                          convert=False, device="cpu", start=False)
    try:
        futs = [eng.submit(s) for s in samples]
        eng.start()
        out = [f.result(60) for f in futs]
    finally:
        eng.close()
    for i in range(6):
        np.testing.assert_array_equal(out[i], ref[i])


# ------------------------------------------------------------ entry points

def test_bench_int8_serving_at_lenet_scale():
    from bigdl_tpu_torch.tools import bench
    out = bench.bench_int8_serving(batch_size=8, iters=2, model="lenet",
                                   device="cpu")
    v = out["variants"]
    assert list(v) == ["bf16", "weight-only int8", "full int8"]
    # 4 products a forward: two convolutions, two Linears
    assert v["full int8"]["int8_mm_per_forward"] == 4
    assert v["full int8"]["float_product_per_forward"] == 0
    assert v["weight-only int8"]["float_product_per_forward"] == 4
    assert v["weight-only int8"]["int8_mm_per_forward"] == 0
    assert v["bf16"]["int8_mm_per_forward"] == 0
    for name in ("weight-only int8", "full int8"):
        # int8 weights against bf16 ones: about half the bytes
        assert 1.8 < v["bf16"]["params_mb"] / v[name]["params_mb"] < 2.1
        assert 0 <= v[name]["top1_agreement_with_bf16"] <= 1
    assert all(r["images_per_s"] > 0 for r in v.values())


def test_quantized_inference_tool():
    from bigdl_tpu_torch.tools import quantized_inference
    res = quantized_inference.main(["--n", "96", "--max-epoch", "3",
                                    "--device", "cpu"])
    assert res["top1_agreement"] > 0.95
    assert 2.5 < res["size_ratio"] < 4.1


def test_module_doctests():
    import doctest

    import bigdl_tpu_torch.nn.quantized as mod
    res = doctest.testmod(mod, optionflags=doctest.NORMALIZE_WHITESPACE)
    assert res.attempted > 0 and res.failed == 0
