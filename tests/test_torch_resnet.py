"""Port parity: the ResNet layers, the CIFAR ResNet-8 and ResNet-50 of
`bigdl_tpu_torch` against `bigdl_tpu`, forward and gradients, with the JAX
weights and BN state carried over (`interop.load_module_params`).

Inputs come from numpy with a fixed seed; losses are `sum(out * w)` with a
random `w`, so every output element carries a gradient. The JAX side runs
on the CPU in f32 with "highest" matmul precision (tests/conftest.py); its
fused BN+ReLU tail is there the plain unfused expression, as the port's is
on the CPU.

Tolerances (all stated in f32): single layers atol 1e-5 on outputs and
gradients (the same arithmetic, summed in another order by oneDNN and
XLA); bf16 BN atol 2e-2 (one bf16 ulp at |y| ~ 4); whole models rtol 1e-4
on the output and atol 1e-4 * max|grad| per parameter (a few thousand f32
terms per convolution, summed in other orders through 10 to 50 layers).

ResNet-50 runs at b2, 64x64. At 32x32 its last stage is 1x1, so each BN
there normalizes 2 rows per channel: the normalized values are exactly
+-1 and the gradient into them is rounding noise in both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
from bigdl_tpu.models.resnet import ResNet as JResNet
from bigdl_tpu.nn.module import functional_apply
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.interop import (load_module_params, module_params_tree,
                                     module_state)
from bigdl_tpu_torch.models import ResNet as TResNet
from bigdl_tpu_torch.ops import bn_relu_kernel as tbk

ATOL = 1e-5


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize_bn(tree, seed=0):
    """BN gammas ~ U(0.5, 1.5) and betas ~ N(0, 0.1). The zero-init gammas
    (zero_gamma, the last BN of each block) become U(0.05, 0.15): at 0
    they would leave every residual branch without a gradient, and at ~1
    the 16 residual sums of ResNet-50 blow the gradients up until f32
    rounding alone moves them by 1% (the port in f32 against itself in
    f64), which no parity test can see through."""
    rs = np.random.RandomState(seed)

    def walk(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "weight" and np.ndim(v) == 1:
                gamma = 0.1 if not np.any(v) else 1.0
                out[k] = ((rs.rand(*np.shape(v)) + 0.5)
                          * gamma).astype(np.float32)
            elif k == "bias" and np.ndim(v) == 1:
                out[k] = (rs.randn(*np.shape(v)) * 0.1).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return walk(tree)


def _jax_value_and_grads(jmod, params, state, x, w, training=True):
    """(out, new_state, d/dparams, d/dx) of sum(out * w) in JAX."""
    def f(p, xx):
        out, new = functional_apply(jmod, p, xx, state=state,
                                    training=training)
        return jnp.sum(out.astype(jnp.float32) * w), (out, new)
    (_, (out, new)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    return np.asarray(out), new, _tree_np(gp), np.asarray(gx)


def _torch_value_and_grads(tmod, x, w, training=True):
    tmod.train(training)
    xt = torch.from_numpy(x).requires_grad_()
    out = tmod(xt)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return out.detach(), xt.grad.numpy()


def _assert_trees_close(got, want, atol=None, rel=None, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_close(got[k], want[k], atol, rel, f"{path}.{k}")
            continue
        tol = atol if rel is None else rel * max(np.abs(want[k]).max(), 1e-6)
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0,
                                   err_msg=f"{path}.{k}")


def _check_layer(jmod, tmod, x, state=None, training=True, atol=ATOL):
    params = _tree_np(jmod.init(jax.random.PRNGKey(1)))
    params = _randomize_bn(params) if params else params
    load_module_params(tmod, params, state)
    rs = np.random.RandomState(9)
    w = rs.randn(*_out_shape(jmod, params, x)).astype(np.float32)
    out_j, new_j, gp_j, gx_j = _jax_value_and_grads(jmod, params,
                                                    state or {}, x, w,
                                                    training)
    out_t, gx_t = _torch_value_and_grads(tmod, x, w, training)
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32), atol=atol)
    np.testing.assert_allclose(gx_t, gx_j, atol=atol)
    if params:
        _assert_trees_close(module_params_tree(tmod, grad=True), gp_j, atol)
    return new_j


def _out_shape(jmod, params, x):
    out, _ = functional_apply(jmod, params, jnp.asarray(x), training=True)
    return np.shape(out)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


class TestLayers:
    @pytest.mark.parametrize("cin,cout,k,s,pad,groups", [
        (3, 8, 3, 1, 1, 1),      # C_in <= 4: the reference's im2col branch
        (4, 6, 7, 2, 3, 1),      # im2col branch, strided
        (8, 6, 3, 2, 1, 1),      # the convolution branch
        (8, 8, 1, 1, 0, 2),      # grouped 1x1
        (6, 5, 3, 2, -1, 1),     # TF-style SAME, odd size
    ])
    def test_spatial_convolution(self, cin, cout, k, s, pad, groups):
        kw = dict(pad_w=pad, pad_h=pad, n_group=groups)
        j = jnn.SpatialConvolution(cin, cout, k, k, s, s, **kw)
        t = tnn.SpatialConvolution(cin, cout, k, k, s, s, **kw,
                                   device="cpu")
        _check_layer(j, t, _x(2, 9, 9, cin))

    @pytest.mark.parametrize("hw", [16, 15])  # s2d, and the odd fallback
    def test_space_to_depth_stem(self, hw):
        j = jnn.SpaceToDepthStemConvolution(3, 8, 7)
        t = tnn.SpaceToDepthStemConvolution(3, 8, 7, device="cpu")
        _check_layer(j, t, _x(2, hw, hw, 3))

    def test_spatial_batchnorm_training_updates_running_stats(self):
        j, t = jnn.SpatialBatchNormalization(6), \
            tnn.SpatialBatchNormalization(6, device="cpu")
        rs = np.random.RandomState(2)
        state = {(): {"mean": rs.randn(6).astype(np.float32),
                      "var": (rs.rand(6) + 0.5).astype(np.float32)}}
        new = _check_layer(j, t, _x(3, 4, 5, 6) * 2 + 1, state)
        for k in ("mean", "var"):
            np.testing.assert_allclose(getattr(t, k).numpy(),
                                       np.asarray(new[()][k]), atol=ATOL)

    def test_spatial_batchnorm_eval_uses_running_stats(self):
        j, t = jnn.SpatialBatchNormalization(6), \
            tnn.SpatialBatchNormalization(6, device="cpu")
        rs = np.random.RandomState(3)
        state = {(): {"mean": rs.randn(6).astype(np.float32),
                      "var": (rs.rand(6) + 0.5).astype(np.float32)}}
        _check_layer(j, t, _x(3, 4, 5, 6), state, training=False)
        np.testing.assert_array_equal(t.mean.numpy(), state[()]["mean"])

    def test_batchnorm_1d(self):
        j, t = jnn.BatchNormalization(5), \
            tnn.BatchNormalization(5, device="cpu")
        _check_layer(j, t, _x(7, 5))

    @pytest.mark.parametrize("fuse", [True, False])
    def test_bn_relu_sequential_bf16_input(self, fuse):
        """Statistics in f32 under bf16 input, output back in bf16; fused
        (the matcher) and not."""
        j = jnn.Sequential().add(jnn.SpatialBatchNormalization(6)) \
            .add(jnn.ReLU())
        t = tnn.Sequential().add(tnn.SpatialBatchNormalization(
            6, device="cpu")).add(tnn.ReLU())
        params = _randomize_bn(_tree_np(j.init(jax.random.PRNGKey(0))))
        load_module_params(t, params)
        x = _x(2, 4, 4, 6) * 3
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        out_j, new = functional_apply(j, params, xb, training=True)
        with tnn.fusion_scope(fuse):
            out_t = t(torch.from_numpy(x).to(torch.bfloat16))
        assert out_t.dtype == torch.bfloat16
        np.testing.assert_allclose(out_t.detach().float().numpy(),
                                   np.asarray(out_j, np.float32), atol=2e-2)
        state_t = module_state(t)
        for k in ("mean", "var"):
            np.testing.assert_allclose(state_t[("0_SpatialBatchNormalization",
                                                )][k],
                                       np.asarray(new[(
                                           "0_SpatialBatchNormalization",
                                       )][k]), atol=1e-5)

    @pytest.mark.parametrize("k,s,pad,ceil", [
        (3, 2, 1, False), (3, 2, 1, True), (2, 2, 0, True), (3, 2, -1,
                                                                False)])
    def test_spatial_max_pooling(self, k, s, pad, ceil):
        j = jnn.SpatialMaxPooling(k, k, s, s, pad, pad, ceil_mode=ceil)
        t = tnn.SpatialMaxPooling(k, k, s, s, pad, pad, ceil_mode=ceil)
        _check_layer(j, t, _x(2, 9, 8, 3))

    def test_spatial_average_pooling(self):
        _check_layer(jnn.SpatialAveragePooling(2, 2, 2, 2),
                     tnn.SpatialAveragePooling(2, 2, 2, 2), _x(2, 6, 4, 3))

    def test_pooler_linear_logsoftmax(self):
        j = jnn.Sequential().add(jnn.Pooler()).add(jnn.Linear(6, 4)) \
            .add(jnn.LogSoftMax())
        t = tnn.Sequential().add(tnn.Pooler()) \
            .add(tnn.Linear(6, 4, device="cpu")).add(tnn.LogSoftMax())
        _check_layer(j, t, _x(3, 2, 5, 6))

    def test_linear_keeps_the_in_out_layout(self):
        t = tnn.Linear(3, 2, device="cpu")
        assert tuple(t.weight.shape) == (3, 2)
        x = torch.randn(4, 5, 3)
        torch.testing.assert_close(t(x), x @ t.weight + t.bias)

    @pytest.mark.parametrize("kw", [
        {}, {"size_average": False}, {"zero_based": True},
        {"weights": [0.5, 2.0, 1.0, 3.0]}])
    def test_class_nll_criterion(self, kw):
        rs = np.random.RandomState(4)
        logp = np.log(rs.dirichlet(np.ones(4), size=6)).astype(np.float32)
        tgt = rs.randint(0, 4, size=6) + (0 if kw.get("zero_based") else 1)
        jc, tc = jnn.ClassNLLCriterion(**kw), tnn.ClassNLLCriterion(**kw)
        lj, gj = jax.value_and_grad(lambda o: jc.apply(o, jnp.asarray(tgt)))(
            jnp.asarray(logp))
        lt_in = torch.from_numpy(logp).requires_grad_()
        lt = tc(lt_in, torch.from_numpy(tgt.astype(np.int32)))
        lt.backward()
        np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-6)
        np.testing.assert_allclose(lt_in.grad.numpy(), np.asarray(gj),
                                   atol=1e-7)


def _whole_model(jmodel, tmodel, x, n_class, seed=0):
    """Forward in training mode and parameter gradients of a whole model,
    JAX vs port, with randomized BN affines and carried weights."""
    params = _randomize_bn(_tree_np(jmodel.ensure_params()), seed)
    state = jmodel._state
    load_module_params(tmodel, params, _tree_np(state))
    rs = np.random.RandomState(seed + 1)
    w = rs.randn(x.shape[0], n_class).astype(np.float32)
    out_j, new_j, gp_j, _ = _jax_value_and_grads(jmodel, params, state, x, w)
    out_t, _ = _torch_value_and_grads(tmodel, x, w)
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=1e-4, atol=1e-5)
    _assert_trees_close(module_params_tree(tmodel, grad=True), gp_j,
                        rel=1e-4)
    state_t = module_state(tmodel)
    assert set(state_t) == set(new_j)
    for path in new_j:
        for k in ("mean", "var"):
            np.testing.assert_allclose(state_t[path][k],
                                       np.asarray(new_j[path][k]),
                                       atol=1e-5, rtol=1e-5)


def _count_fused(monkeypatch):
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tbk.bn_relu_forward, tbk.bn_relu_backward

    def counted_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def counted_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)
    monkeypatch.setattr(tbk, "bn_relu_forward", counted_fwd)
    monkeypatch.setattr(tbk, "bn_relu_backward", counted_bwd)
    return calls


class TestWholeModels:
    def test_cifar_resnet8_forward_and_grads(self, monkeypatch):
        calls = _count_fused(monkeypatch)
        _whole_model(JResNet(10, depth=8, data_set="cifar10"),
                     TResNet(10, depth=8, data_set="cifar10", device="cpu"),
                     _x(2, 32, 32, 3, seed=1), 10)
        assert calls == {"fwd": 4, "bwd": 4}

    def test_cifar_resnet8_shortcut_a(self):
        _whole_model(JResNet(10, depth=8, data_set="cifar10",
                             shortcut_type="A"),
                     TResNet(10, depth=8, data_set="cifar10",
                             shortcut_type="A", device="cpu"),
                     _x(2, 16, 16, 3, seed=2), 10)

    def test_resnet50_s2d_forward_and_grads(self, monkeypatch):
        from bigdl_tpu.models.resnet import ResNet50 as JResNet50
        from bigdl_tpu_torch.models import ResNet50 as TResNet50
        calls = _count_fused(monkeypatch)
        _whole_model(JResNet50(class_num=10, s2d_stem=True),
                     TResNet50(class_num=10, s2d_stem=True, device="cpu"),
                     _x(2, 64, 64, 3, seed=3), 10)
        assert calls == {"fwd": 33, "bwd": 33}

    def test_eval_mode_forward(self):
        jm = JResNet(10, depth=8, data_set="cifar10")
        tm = TResNet(10, depth=8, data_set="cifar10", device="cpu")
        params = _randomize_bn(_tree_np(jm.ensure_params()), 4)
        rs = np.random.RandomState(5)
        state = {p: {"mean": rs.randn(*np.shape(v["mean"])).astype(
                         np.float32) * 0.1,
                     "var": (rs.rand(*np.shape(v["var"])) + 0.5).astype(
                         np.float32)} for p, v in jm._state.items()}
        load_module_params(tm, params, state)
        x = _x(2, 16, 16, 3, seed=6)
        out_j, _ = functional_apply(jm, params, jnp.asarray(x), state=state,
                                    training=False)
        with torch.no_grad():
            out_t = tm.eval()(torch.from_numpy(x))
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                                   rtol=1e-4, atol=1e-5)

    def test_fusion_off_calls_no_fused_tail(self, monkeypatch):
        calls = _count_fused(monkeypatch)
        tm = TResNet(10, depth=8, data_set="cifar10", device="cpu")
        with tnn.fusion_scope(False):
            tm(torch.randn(2, 8, 8, 3)).sum().backward()
        assert calls == {"fwd": 0, "bwd": 0}
        assert tnn.fusion_enabled()


class TestCarry:
    def test_load_rejects_missing_extra_and_misshapen(self):
        jm = JResNet(10, depth=8, data_set="cifar10")
        tm = TResNet(10, depth=8, data_set="cifar10", device="cpu")
        params = _tree_np(jm.ensure_params())
        state = _tree_np(jm._state)
        extra = dict(params, junk={})
        with pytest.raises(KeyError):
            load_module_params(tm, extra)
        missing = {k: v for k, v in params.items() if k != "7_Linear"}
        with pytest.raises(KeyError):
            load_module_params(tm, missing)
        bad = dict(params, **{"7_Linear": {"weight": np.zeros((10, 64)),
                                           "bias": np.zeros(10)}})
        with pytest.raises(ValueError, match="7_Linear.weight"):
            load_module_params(tm, bad)
        with pytest.raises(KeyError, match="BN state"):
            load_module_params(tm, params, dict(list(state.items())[1:]))

    def test_round_trip_and_conv_layout(self):
        jm = JResNet(10, depth=8, data_set="cifar10")
        tm = TResNet(10, depth=8, data_set="cifar10", device="cpu")
        params = _tree_np(jm.ensure_params())
        load_module_params(tm, params, _tree_np(jm._state))
        _assert_trees_close(module_params_tree(tm), params, atol=0)
        w_hwio = params["0_SpatialConvolution"]["weight"]
        w_oihw = tm.get_submodule("0_SpatialConvolution").weight
        np.testing.assert_array_equal(w_oihw.detach().numpy(),
                                      w_hwio.transpose(3, 2, 0, 1))

    def test_port_init_is_sane(self):
        """Port-built weights (no carry): He-normal convs, zero-gamma last
        BN of each block, finite log-probabilities."""
        tm = TResNet(10, depth=8, data_set="cifar10", device="cpu",
                     generator=torch.Generator().manual_seed(3))
        conv = tm.get_submodule("3_Sequential.0_ConcatTable.0_Sequential."
                                "0_SpatialConvolution")
        std = float(conv.weight.detach().std())
        assert abs(std - (2.0 / (3 * 3 * 16)) ** 0.5) < 0.03
        last_bn = tm.get_submodule("3_Sequential.0_ConcatTable.0_Sequential."
                                   "4_SpatialBatchNormalization")
        assert float(last_bn.weight.detach().abs().sum()) == 0.0
        out = tm(torch.randn(2, 16, 16, 3))
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out.exp().sum(1), torch.ones(2))
