"""Port parity: inference conversion (`bigdl_tpu_torch.ir`), `LocalPredictor`
and `InferenceEngine` against `bigdl_tpu`.

- The IR passes mirror `tests/test_ir.py`: BN folding keeps the outputs and
  removes the BNs, noise layers vanish, `convert(inference=False)` folds
  nothing, `elements()` flattens in order, the stem restatement moves the
  same parameters into a `SpaceToDepthStemConvolution` and leaves
  ineligible convolutions alone, and a BN after the s2d stem is not folded
  (the exact type test). Each converted model is held against the JAX
  package's converted model with the same weights.
- `LocalPredictor.predict` / `predict_class` against the JAX
  `LocalPredictor` on a 7x7/s2-stem CNN at 32x32 (arrays, tensors,
  `Sample`s, `MiniBatch`es, a dataset) and on ResNet-50 at b2, 64x64 in
  both stem branches, with `BIGDL_TPU_PALLAS_STEM` set (the port's stem
  kernel route, its plain version on the CPU) and the JAX stem in Pallas
  interpret mode (`INTERPRET` monkeypatched).
- `InferenceEngine` mirrors `tests/test_serving.py`: buckets, padding
  parity for every batch size, list outputs and two-feature inputs, the
  warm-up count, concurrent clients, deadline and failed-batch isolation,
  reject / block admission, drain / no-drain close.

Weights are carried from the JAX models with randomized BN state (gammas,
betas, running means and variances: the init's 1 / 0 / 0 / 1 would make a
fold the identity). Tolerances, all f32: outputs within 1e-5 * max|ref|
for the small models (the same sums in another order) and 1e-4 * max|ref|
for ResNet-50 (53 layers of them); folded weights within 1e-6 * max|ref|
(the port folds in float64, the reference in float32). Bitwise equality
across batch shapes, which the reference's own serving tests assert, is
not asked of the port.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset.sample import Sample as JSample
from bigdl_tpu.ir import ConversionUtils as JConversion
from bigdl_tpu.ir import IRGraph as JIRGraph
from bigdl_tpu.nn.module import functional_apply
from bigdl_tpu.ops import stem_kernel as jsk
from bigdl_tpu.optim.predictor import LocalPredictor as JPredictor
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.dataset import DataSet, MiniBatch, Sample
from bigdl_tpu_torch.interop import load_module_params, module_params_tree
from bigdl_tpu_torch.ir import ConversionUtils, IRGraph
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.ops import stem_kernel as tsk
from bigdl_tpu_torch.optim import LocalPredictor, Predictor
from bigdl_tpu_torch.serving import (EngineClosedError, InferenceEngine,
                                     QueueFullError, ServingError,
                                     ServingTimeoutError, default_buckets)

RTOL = 1e-5
RTOL_R50 = 1e-4
STEM_ENV = "BIGDL_TPU_PALLAS_STEM"


class Dropout(Module):
    """A stand-in noise layer: the port has no Dropout module yet, and the
    noise pass matches layers by class name, as the reference's does."""

    def forward(self, x):
        return x


def _close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rtol * max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _randomized(jmodel, seed=0):
    """The JAX model's params and BN state, as numpy trees, with BN gammas
    U(0.5, 1.5) (U(0.05, 0.15) where the init zeroed them), betas
    N(0, 0.1), running means N(0, 0.1) and variances U(0.5, 1.5)."""
    rs = np.random.RandomState(seed)

    def walk(t):
        out = {}
        for k, v in t.items():
            v = v if isinstance(v, dict) else np.asarray(v)
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "weight" and v.ndim == 1:
                scale = 1.0 if np.any(v) else 0.1
                out[k] = ((rs.rand(*v.shape) + 0.5) * scale).astype(
                    np.float32)
            elif k == "bias" and v.ndim == 1:
                out[k] = (rs.randn(*v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = v
        return out

    params = walk(jmodel.ensure_params())
    state = {p: {"mean": (rs.randn(*np.shape(s["mean"])) * 0.1).astype(
                     np.float32),
                 "var": (rs.rand(*np.shape(s["var"])) + 0.5).astype(
                     np.float32)}
             for p, s in (jmodel._state or {}).items()}
    return params, state


def _carry(jmodel, tmodel, seed=0):
    """Randomize the JAX model's BN state, set it on the JAX model and
    carry everything into the port model (left in eval mode)."""
    params, state = _randomized(jmodel, seed)
    jmodel.set_params(jax.tree_util.tree_map(jnp.asarray, params))
    jmodel._state = {p: {k: jnp.asarray(v) for k, v in s.items()}
                     for p, s in state.items()}
    jmodel.evaluate()
    load_module_params(tmodel, params, state)
    return tmodel.eval()


def _jax_eval(jmodel, x):
    out, _ = functional_apply(jmodel, jmodel.ensure_params(),
                              jnp.asarray(x), state=jmodel._state,
                              training=False)
    return np.asarray(out)


def _port_eval(tmodel, x):
    with torch.no_grad():
        return tmodel.eval()(torch.from_numpy(x)).numpy()


def _kinds(m):
    return [type(c).__name__ for c in m.children_in_order()]


# --------------------------------------------------------------------------
# The IR passes (tests/test_ir.py)
# --------------------------------------------------------------------------

def _bn_models():
    j = (jnn.Sequential()
         .add(jnn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1))
         .add(jnn.SpatialBatchNormalization(8))
         .add(jnn.ReLU())
         .add(jnn.Pooler())
         .add(jnn.Linear(8, 4))
         .add(jnn.BatchNormalization(4))
         .add(jnn.Dropout(0.5))
         .add(jnn.LogSoftMax()))
    t = (tnn.Sequential()
         .add(tnn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1, device="cpu"))
         .add(tnn.SpatialBatchNormalization(8, device="cpu"))
         .add(tnn.ReLU())
         .add(tnn.Pooler())
         .add(tnn.Linear(8, 4, device="cpu"))
         .add(tnn.BatchNormalization(4, device="cpu"))
         .add(Dropout())
         .add(tnn.LogSoftMax()))
    t = _carry(j, t, seed=1)
    x = np.random.RandomState(0).rand(8, 6, 6, 3).astype(np.float32)
    return j, t, x


class TestFoldBatchnorm:
    def test_outputs_preserved_and_bn_removed(self):
        j, t, x = _bn_models()
        want = _port_eval(t, x)
        _close(want, _jax_eval(j, x), what="unconverted")
        jc = JConversion.convert(j, inference=True)
        tc = ConversionUtils.convert(t, inference=True)
        got = _port_eval(tc, x)
        _close(got, want, what="converted vs unconverted")
        _close(got, _jax_eval(jc, x), what="converted vs JAX converted")
        kinds = _kinds(tc)
        assert kinds == [type(c).__name__ for c in jc.children]
        assert "SpatialBatchNormalization" not in kinds
        assert "BatchNormalization" not in kinds
        assert "Dropout" not in kinds
        assert kinds.count("Identity") == 3
        # the folded parameters are the reference's, and keyed as before
        want_p = jax.tree_util.tree_map(np.asarray, jc.ensure_params())
        got_p = module_params_tree(tc)
        assert set(got_p) == set(want_p)
        for key in ("0_SpatialConvolution", "4_Linear"):
            for leaf in ("weight", "bias"):
                _close(got_p[key][leaf], want_p[key][leaf], rtol=1e-6,
                       what=f"{key}.{leaf}")

    def test_conv_without_bias_gains_one(self):
        t = (tnn.Sequential()
             .add(tnn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1,
                                         with_bias=False, device="cpu"))
             .add(tnn.SpatialBatchNormalization(4, device="cpu")))
        bn = t.get_submodule("1_SpatialBatchNormalization")
        with torch.no_grad():
            bn.mean.copy_(torch.tensor([0.1, -0.2, 0.3, 0.0]))
            bn.var.copy_(torch.tensor([0.5, 2.0, 1.0, 1.5]))
            bn.bias.copy_(torch.tensor([0.3, 0.0, -0.1, 0.2]))
        x = np.random.RandomState(1).rand(2, 5, 5, 3).astype(np.float32)
        want = _port_eval(t, x)
        tc = ConversionUtils.convert(t)
        conv = tc.get_submodule("0_SpatialConvolution")
        assert conv.with_bias and isinstance(conv.bias, torch.nn.Parameter)
        assert conv.bias.device == conv.weight.device
        _close(_port_eval(tc, x), want)

    def test_train_mode_bn_not_folded(self):
        j, t, _ = _bn_models()
        t.train()
        tc = ConversionUtils.convert(t, inference=False)
        jc = JConversion.convert(j.training(), inference=False)
        assert "SpatialBatchNormalization" in _kinds(tc)
        assert _kinds(tc) == [type(c).__name__ for c in jc.children]


class TestIRGraph:
    def test_elements_flatten(self):
        j, t, _ = _bn_models()
        ops = [e.op_type for e in IRGraph.from_module(t).elements()]
        assert ops == [e.op_type for e in JIRGraph.from_module(j).elements()]
        assert ops[0] == "SpatialConvolution" and len(ops) == 8
        conv = IRGraph.from_module(t).elements()[0]
        assert set(conv.params) == {"weight", "bias"}


class TestS2DStemRestatement:
    @staticmethod
    def _stem_models():
        j = (jnn.Sequential()
             .add(jnn.SpatialConvolution(3, 16, 7, 7, 2, 2, 3, 3,
                                         with_bias=False, name="conv1"))
             .add(jnn.ReLU())
             .add(jnn.SpatialConvolution(16, 8, 3, 3, 2, 2, 1, 1,
                                         name="conv2"))
             .add(jnn.Pooler())
             .add(jnn.Linear(8, 4)))
        t = (tnn.Sequential()
             .add(tnn.SpatialConvolution(3, 16, 7, 7, 2, 2, 3, 3,
                                         with_bias=False, name="conv1",
                                         device="cpu"))
             .add(tnn.ReLU())
             .add(tnn.SpatialConvolution(16, 8, 3, 3, 2, 2, 1, 1,
                                         name="conv2", device="cpu"))
             .add(tnn.Pooler())
             .add(tnn.Linear(8, 4, device="cpu")))
        return j, _carry(j, t)

    @pytest.mark.parametrize("env", ["", "1"])
    def test_restates_stem_only_with_the_same_parameters(self, monkeypatch,
                                                         env):
        monkeypatch.setenv(STEM_ENV, env)
        monkeypatch.setattr(jsk, "INTERPRET", True)
        j, t = self._stem_models()
        x = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
        want = _port_eval(t, x)
        w_before = t.get_submodule("0_conv1").weight
        out = ConversionUtils.apply_tpu_restatements(t)
        jout = JConversion.apply_tpu_restatements(j)
        kinds = _kinds(out)
        assert kinds == [type(c).__name__ for c in jout.children]
        assert kinds[0] == "SpaceToDepthStemConvolution"
        assert kinds[2] == "SpatialConvolution"  # 16 channels: not a stem
        stem = out.get_submodule("0_conv1")
        assert stem.name == "conv1" and stem.weight is w_before
        assert stem.bias is None and not stem.with_bias
        calls = {"n": 0}
        plain = tsk.stem_conv_forward_plain

        def counted(*a, **kw):
            calls["n"] += 1
            return plain(*a, **kw)
        monkeypatch.setattr(tsk, "stem_conv_forward_plain", counted)
        got = _port_eval(out, x)
        assert calls["n"] == (1 if env else 0)
        _close(got, want)
        _close(got, _jax_eval(jout, x))

    def test_ineligible_stems_untouched(self):
        t = (tnn.Sequential()
             .add(tnn.SpatialConvolution(3, 8, 7, 7, 1, 1, 3, 3,
                                         device="cpu"))
             .add(tnn.SpatialConvolution(8, 8, 5, 5, 2, 2, 2, 2,
                                         device="cpu"))
             .add(tnn.SpatialConvolution(8, 8, 7, 7, 2, 2, 3, 3,
                                         device="cpu")))  # 8 planes
        out = ConversionUtils.apply_tpu_restatements(t)
        assert _kinds(out) == ["SpatialConvolution"] * 3

    def test_bn_after_the_s2d_stem_is_not_folded(self):
        j = (jnn.Sequential()
             .add(jnn.SpaceToDepthStemConvolution(3, 8, 7, name="conv1"))
             .add(jnn.SpatialBatchNormalization(8)).add(jnn.ReLU()))
        t = (tnn.Sequential()
             .add(tnn.SpaceToDepthStemConvolution(3, 8, 7, name="conv1",
                                                  device="cpu"))
             .add(tnn.SpatialBatchNormalization(8, device="cpu"))
             .add(tnn.ReLU()))
        t = _carry(j, t)
        x = np.random.RandomState(2).rand(2, 16, 16, 3).astype(np.float32)
        tc = ConversionUtils.convert(t)
        jc = JConversion.convert(j)
        assert _kinds(tc) == [type(c).__name__ for c in jc.children] == [
            "SpaceToDepthStemConvolution", "SpatialBatchNormalization",
            "ReLU"]
        _close(_port_eval(tc, x), _jax_eval(jc, x))


# --------------------------------------------------------------------------
# LocalPredictor
# --------------------------------------------------------------------------

def _stem_cnn():
    j = (jnn.Sequential()
         .add(jnn.SpatialConvolution(3, 8, 7, 7, 2, 2, 3, 3,
                                     with_bias=False))
         .add(jnn.SpatialBatchNormalization(8)).add(jnn.ReLU())
         .add(jnn.SpatialMaxPooling(3, 3, 2, 2, 1, 1))
         .add(jnn.SpatialConvolution(8, 8, 3, 3, 1, 1, 1, 1))
         .add(jnn.SpatialBatchNormalization(8)).add(jnn.ReLU())
         .add(jnn.Pooler()).add(jnn.Linear(8, 5)).add(jnn.LogSoftMax()))
    t = (tnn.Sequential()
         .add(tnn.SpatialConvolution(3, 8, 7, 7, 2, 2, 3, 3,
                                     with_bias=False, device="cpu"))
         .add(tnn.SpatialBatchNormalization(8, device="cpu"))
         .add(tnn.ReLU())
         .add(tnn.SpatialMaxPooling(3, 3, 2, 2, 1, 1))
         .add(tnn.SpatialConvolution(8, 8, 3, 3, 1, 1, 1, 1, device="cpu"))
         .add(tnn.SpatialBatchNormalization(8, device="cpu"))
         .add(tnn.ReLU())
         .add(tnn.Pooler()).add(tnn.Linear(8, 5, device="cpu"))
         .add(tnn.LogSoftMax()))
    return j, _carry(j, t, seed=3)


def _images(n, hw=32, seed=0):
    return np.random.RandomState(seed).rand(n, hw, hw, 3).astype(np.float32)


def _n_bn(m):
    return sum(isinstance(c, tnn.BatchNormalization) for c in m.modules())


class TestLocalPredictor:
    def test_applies_conversion_and_leaves_the_model(self):
        j, t, x = _bn_models()
        w_before = t.get_submodule("0_SpatialConvolution").weight.clone()
        pred = LocalPredictor(t, batch_size=3, device="cpu")
        assert _n_bn(pred.model) == 0 and _n_bn(t) == 2
        torch.testing.assert_close(
            t.get_submodule("0_SpatialConvolution").weight, w_before,
            rtol=0, atol=0)
        outs = pred.predict([Sample(x[i]) for i in range(len(x))])
        want = JPredictor(j, batch_size=3).predict(
            [JSample(x[i]) for i in range(len(x))])
        _close(np.stack(outs), np.stack(want))

    def test_predict_and_predict_class_against_jax(self, monkeypatch):
        monkeypatch.setenv(STEM_ENV, "1")
        monkeypatch.setattr(jsk, "INTERPRET", True)
        j, t = _stem_cnn()
        x = _images(10)
        jpred = JPredictor(j, batch_size=4)
        want = np.stack(jpred.predict(x))
        pred = Predictor(t, batch_size=4, device="cpu")
        assert type(pred.model.get_submodule("0_SpatialConvolution")) \
            is tnn.SpaceToDepthStemConvolution
        assert _n_bn(pred.model) == 0
        inputs = {
            "array": x, "tensor": torch.from_numpy(x),
            "samples": [Sample(x[i]) for i in range(10)],
            "minibatches": [MiniBatch(x[:6]), MiniBatch(x[6:])],
            "dataset": DataSet.from_arrays(x)}
        for name, data in inputs.items():
            got = pred.predict(data)
            assert len(got) == 10, name
            _close(np.stack(got), want, what=name)
        classes = pred.predict_class(x)
        top2 = np.sort(want, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-3
        assert np.array_equal(np.array(classes)[clear],
                              np.array(jpred.predict_class(x))[clear])
        assert min(classes) >= 1

    def test_runs_on_the_card_unless_asked(self):
        _, t = _stem_cnn()
        with pytest.raises((RuntimeError, ValueError)):
            LocalPredictor(t)  # default CUDA: no card here, or a CPU model

    @pytest.mark.parametrize("s2d_stem,bns_left", [(True, 1), (False, 0)])
    def test_resnet50_both_stem_branches(self, monkeypatch, s2d_stem,
                                         bns_left):
        from bigdl_tpu.models.resnet import ResNet50 as JResNet50
        from bigdl_tpu_torch.models import ResNet50 as TResNet50
        monkeypatch.setenv(STEM_ENV, "1")
        monkeypatch.setattr(jsk, "INTERPRET", True)
        calls = {"n": 0, "bias": []}
        plain = tsk.stem_conv_forward_plain

        def counted(x2, wk, bias, *a):
            calls["n"] += 1
            calls["bias"].append(bias is not None)
            return plain(x2, wk, bias, *a)
        monkeypatch.setattr(tsk, "stem_conv_forward_plain", counted)
        j = JResNet50(class_num=10, s2d_stem=s2d_stem)
        t = _carry(j, TResNet50(class_num=10, s2d_stem=s2d_stem,
                                device="cpu"), seed=4)
        x = _images(2, hw=64, seed=5)
        want = np.stack(JPredictor(j, batch_size=2).predict(x))
        _close(_port_eval(t, x), want, rtol=RTOL_R50, what="unconverted")
        calls.update(n=0, bias=[])
        pred = LocalPredictor(t, batch_size=2, device="cpu")
        assert _n_bn(pred.model) == bns_left
        stem = pred.model.get_submodule("0_conv1")
        assert type(stem) is tnn.SpaceToDepthStemConvolution
        assert stem.with_bias == (not s2d_stem)
        _close(np.stack(pred.predict(x)), want, rtol=RTOL_R50,
               what="LocalPredictor")
        assert calls["n"] == 1 and calls["bias"] == [not s2d_stem]
        with InferenceEngine(t, max_batch_size=2, max_wait_ms=50.0,
                             device="cpu", start=False) as eng:
            futs = [eng.submit(x[i]) for i in range(2)]
            eng.start()
            got = np.stack([f.result(120) for f in futs])
            assert eng.stats()["batches"] == 1
        _close(got, want, rtol=RTOL_R50, what="InferenceEngine")
        assert calls["n"] == 2


# --------------------------------------------------------------------------
# InferenceEngine (tests/test_serving.py)
# --------------------------------------------------------------------------

def _mlp():
    return (tnn.Sequential().add(tnn.Linear(6, 16, device="cpu"))
            .add(tnn.ReLU()).add(tnn.Linear(16, 3, device="cpu"))
            .add(tnn.LogSoftMax()))


def _conv_models():
    j = (jnn.Sequential()
         .add(jnn.SpatialConvolution(3, 8, 3, 3, pad_w=1, pad_h=1))
         .add(jnn.ReLU()).add(jnn.SpatialMaxPooling(2, 2))
         .add(jnn.Pooler()).add(jnn.Linear(8, 5)).add(jnn.LogSoftMax()))
    t = (tnn.Sequential()
         .add(tnn.SpatialConvolution(3, 8, 3, 3, pad_w=1, pad_h=1,
                                     device="cpu"))
         .add(tnn.ReLU()).add(tnn.SpatialMaxPooling(2, 2))
         .add(tnn.Pooler()).add(tnn.Linear(8, 5, device="cpu"))
         .add(tnn.LogSoftMax()))
    return j, _carry(j, t)


def _samples(n, shape=(6,), seed=0):
    rs = np.random.RandomState(seed)
    return [Sample(rs.rand(*shape).astype(np.float32)) for _ in range(n)]


def _engine(model, **kw):
    kw.setdefault("device", "cpu")
    return InferenceEngine(model, **kw)


def _serve_one_batch(model, samples, **kw):
    """Queue `samples` on a paused engine, then start it: one gather window
    sees them all. Returns (results, stats)."""
    kw.setdefault("max_wait_ms", 25.0)
    eng = _engine(model, start=False, **kw)
    try:
        futs = [eng.submit(s) for s in samples]
        eng.start()
        results = [f.result(60) for f in futs]
        stats = eng.stats()
    finally:
        eng.close()
    return results, stats


def _settle(baseline, timeout=5.0):
    deadline = time.time() + timeout
    while threading.active_count() > baseline and time.time() < deadline:
        time.sleep(0.02)
    return threading.active_count()


class TestBuckets:
    def test_default_buckets(self):
        assert default_buckets(32) == [2, 4, 8, 16, 32]
        assert default_buckets(24) == [2, 4, 8, 16, 24]
        assert default_buckets(2) == [2]
        assert default_buckets(1) == [1]
        with pytest.raises(ValueError):
            default_buckets(0)

    @pytest.mark.parametrize("kw", [{"queue_capacity": 0},
                                    {"admission": "maybe"},
                                    {"buckets": [4, 4]}, {"buckets": [0]},
                                    {"inflight": 0}, {"max_wait_ms": -1}])
    def test_validation(self, kw):
        with pytest.raises(ValueError):
            _engine(_mlp(), start=False, **kw)

    def test_explicit_buckets_cap_batch(self):
        with _engine(_mlp(), max_batch_size=32, buckets=[6, 2],
                     start=False) as eng:
            assert eng.buckets == [2, 6] and eng.max_batch_size == 6
            assert eng._bucket_for(1) == 2 and eng._bucket_for(5) == 6


class TestBucketPaddingParity:
    def test_every_batch_size_matches_offline_predict(self):
        j, t = _conv_models()
        samples = _samples(12, shape=(8, 8, 3))
        x = np.stack([s.feature for s in samples])
        ref = LocalPredictor(t, batch_size=12, device="cpu").predict(x)
        want = JPredictor(j, batch_size=12).predict(x)
        _close(np.stack(ref), np.stack(want))
        for n in range(1, 13):  # buckets [2, 4, 8, 12]: every pad amount
            out, stats = _serve_one_batch(t, samples[:n], max_batch_size=12)
            assert stats["batches"] == 1
            assert stats["padded_rows"] == min(
                b for b in (2, 4, 8, 12) if b >= n) - n
            _close(np.stack(out), np.stack(ref[:n]), what=f"n={n}")

    def test_list_output_model(self):
        # a ConcatTable gives a list; serving keeps LocalPredictor's
        # convention (the first element)
        m = (tnn.Sequential().add(tnn.Linear(6, 8, device="cpu"))
             .add(tnn.ConcatTable().add(tnn.Linear(8, 3, device="cpu"))
                  .add(tnn.Linear(8, 2, device="cpu"))))
        samples = _samples(7)
        ref = LocalPredictor(m, batch_size=7, device="cpu").predict(samples)
        out, _ = _serve_one_batch(m, samples, max_batch_size=8)
        assert out[0].shape == (3,)
        _close(np.stack(out), np.stack(ref))

    def test_two_feature_model(self):
        class TwoInputs(Module):
            def __init__(self):
                super().__init__()
                self.a = tnn.Linear(4, 3, device="cpu")
                self.b = tnn.Linear(5, 3, device="cpu")

            def forward(self, xs):
                return self.a(xs[0]) + self.b(xs[1])

        m = TwoInputs()
        rs = np.random.RandomState(3)
        samples = [Sample([rs.rand(4).astype(np.float32),
                           rs.rand(5).astype(np.float32)]) for _ in range(5)]
        ref = LocalPredictor(m, batch_size=5, device="cpu").predict(samples)
        out, _ = _serve_one_batch(m, samples, max_batch_size=8)
        _close(np.stack(out), np.stack(ref))


class TestWarmup:
    def test_compiles_bounded_by_buckets(self):
        samples = _samples(12)
        with _engine(_mlp(), max_batch_size=12, max_wait_ms=25.0) as eng:
            for n in range(1, 13):
                for f in [eng.submit(s) for s in samples[:n]]:
                    f.result(60)
            assert eng.compile_count() <= len(eng.buckets) == 4

    def test_warmup_runs_every_bucket(self):
        with _engine(_mlp(), max_batch_size=8) as eng:
            n = eng.warmup(_samples(1)[0])
            assert n == len(eng.buckets) == 3
            for k in range(1, 9):
                for f in [eng.submit(s) for s in _samples(k, seed=k)]:
                    f.result(60)
            assert eng.compile_count() == n
            stats = eng.stats()
            assert stats["bucket_hit_rate"] == 1.0
            for key in ("batch_size_p50", "latency_ms_p50", "latency_ms_p95",
                        "latency_ms_p99", "queue_wait_ms_p50"):
                assert key in stats, key


class TestConcurrency:
    def test_interleaved_clients_get_their_own_results(self):
        m = _mlp()
        samples = _samples(48)
        ref = LocalPredictor(m, batch_size=16, device="cpu").predict(samples)
        results = [None] * 48
        with _engine(m, max_batch_size=16, max_wait_ms=2.0) as eng:
            eng.warmup(samples[0])

            def client(i):
                results[i] = eng.predict(samples[i], timeout=60)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(48)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        _close(np.stack(results), np.stack(ref))

    def test_deadline_expired_isolated_from_batch_neighbors(self):
        s = _samples(3)
        with _engine(_mlp(), max_batch_size=4, max_wait_ms=150.0) as eng:
            f1 = eng.submit(s[0])
            time.sleep(0.01)
            f_exp = eng.submit(s[1], deadline_ms=5)
            f2 = eng.submit(s[2])
            assert f1.result(60).shape == (3,)
            assert f2.result(60).shape == (3,)
            with pytest.raises(ServingTimeoutError):
                f_exp.result(60)
            assert eng.stats()["timed_out"] == 1

    def test_failed_batch_rejects_only_its_own_requests(self):
        good = _samples(4)
        bad = Sample(np.random.rand(9).astype(np.float32))
        with _engine(_mlp(), max_batch_size=8, max_wait_ms=25.0,
                     start=False) as eng:
            f_bad = eng.submit(bad)
            f_good = [eng.submit(s) for s in good]
            eng.start()
            for f in f_good:
                assert f.result(60).shape == (3,)
            with pytest.raises(ServingError):
                f_bad.result(60)
            assert eng.predict(good[0], timeout=60).shape == (3,)
            assert eng.stats()["failed"] == 1


class TestAdmission:
    def test_reject_on_full(self):
        s = _samples(3)
        with _engine(_mlp(), queue_capacity=2, admission="reject",
                     start=False) as eng:
            f0 = eng.submit(s[0])
            eng.submit(s[1])
            with pytest.raises(QueueFullError):
                eng.submit(s[2])
            assert eng.stats()["rejected"] == 1
            eng.start()  # queued work still completes
            assert f0.result(60).shape == (3,)

    def test_client_side_timeout_raises_serving_timeout(self):
        eng = _engine(_mlp(), start=False)  # paused: never serves
        try:
            t0 = time.perf_counter()
            with pytest.raises(ServingTimeoutError):
                eng.predict(_samples(1)[0], timeout=0.05)
            assert time.perf_counter() - t0 < 5.0
        finally:
            eng.close(drain=False)

    def test_block_admission_observes_deadline(self):
        s = _samples(3)
        with _engine(_mlp(), queue_capacity=2, admission="block",
                     start=False) as eng:
            eng.submit(s[0])
            eng.submit(s[1])
            t0 = time.perf_counter()
            with pytest.raises(ServingTimeoutError):
                eng.submit(s[2], deadline_ms=50)
            assert time.perf_counter() - t0 < 5.0
            eng.start()

    def test_block_admission_unblocks_when_space_frees(self):
        s = _samples(4)
        with _engine(_mlp(), queue_capacity=2, admission="block",
                     max_wait_ms=1.0, start=False) as eng:
            f0 = eng.submit(s[0])
            eng.submit(s[1])
            got = []
            th = threading.Thread(target=lambda: got.append(
                eng.submit(s[2])))
            th.start()
            time.sleep(0.05)
            assert not got  # parked on the full queue
            eng.start()
            th.join(10)
            assert got and got[0].result(60).shape == (3,)
            assert f0.result(60).shape == (3,)


class TestShutdown:
    def test_drain_close_resolves_everything(self):
        base = threading.active_count()
        samples = _samples(24)
        eng = _engine(_mlp(), max_batch_size=8, max_wait_ms=1.0,
                      start=False)
        futs = [eng.submit(s) for s in samples]
        eng.start()
        eng.close()  # drain=True: every queued request finishes
        for f in futs:
            assert f.result(0).shape == (3,)
        assert _settle(base) == base
        eng.close()  # idempotent
        with pytest.raises(EngineClosedError):
            eng.submit(samples[0])

    def test_no_drain_close_fails_queued(self):
        eng = _engine(_mlp(), start=False)
        futs = [eng.submit(s) for s in _samples(3)]
        eng.close(drain=False)
        for f in futs:
            with pytest.raises(EngineClosedError):
                f.result(0)
        s = eng.stats()
        assert s["cancelled"] == 3 and s["failed"] == 0

    def test_close_unblocks_parked_producers(self):
        s = _samples(3)
        eng = _engine(_mlp(), queue_capacity=1, admission="block",
                      start=False)
        eng.submit(s[0])
        errs = []

        def blocked():
            try:
                eng.submit(s[1])
            except EngineClosedError as e:
                errs.append(e)

        th = threading.Thread(target=blocked)
        th.start()
        time.sleep(0.05)
        eng.close(drain=False)
        th.join(10)
        assert not th.is_alive() and len(errs) == 1
