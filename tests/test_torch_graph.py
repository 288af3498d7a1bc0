"""Port parity: `nn.Graph` and the node DSL, with its IR, quantizer,
optimizer and deep-copy paths, against `bigdl_tpu`.

- The reference's Graph cases (`tests/test_layers.py:218-234`: several
  outputs; several inputs joined by `JoinTable`) and fusion cases
  (`tests/test_fusion.py:225-268`: the plan's sets, here by `exec_order`
  index; the fused output and BN state bitwise the unfused ones; a frozen
  BN not fusible).
- A CIFAR ResNet-8 built as a Graph in both packages from its Sequential
  (`graph_of`: every leaf a node, a `ConcatTable` a fan-out, a
  `CAddTable` a node with two inputs): the forward, the loss and every
  gradient, then the losses and BN state after 2 `LocalOptimizer` steps
  with `set_graph_optimizations(True)`.
- `freeze` and `stop_gradient` gradients; `lenet_graph`; the IR's Graph
  restatement and `set_graph_optimizations` on a Graph
  (`tests/test_ir.py:127-159`); the Graph quantization of
  `tests/test_quantized.py:89`, bitwise; `functional_apply`,
  `merge_state` and `param_count`; the error probes (a cycle, a wrong
  input count, a "." in a key); `copy.deepcopy` of a 300-node chain and of
  a ResNet-50 Graph at each of the port's deep-copy sites, at Python's
  default recursion limit; the weights carried by position both ways;
  `InferenceEngine` serving a Graph.

Weights come from the port (seeded), carried to the JAX twin under its
own node keys (`interop.module_params_tree(like=...)`: node ids differ
between the packages). JAX runs in f32 at "highest" precision
(tests/conftest.py). Tolerances: outputs and BN state rtol 1e-5 / atol
1e-6, gradients rtol 1e-4 / atol 1e-6, int8 bitwise.
"""

import copy
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset.dataset import LocalDataSet as JLocalDataSet
from bigdl_tpu.dataset.sample import MiniBatch as JMiniBatch
from bigdl_tpu.ir import ConversionUtils as JConversion
from bigdl_tpu.models.lenet import lenet_graph as jlenet_graph
from bigdl_tpu.models.resnet import ResNet as JResNet
from bigdl_tpu.nn import fusion as jfusion
from bigdl_tpu.nn.module import functional_apply as jfunctional_apply
from bigdl_tpu.nn.module import merge_state as jmerge_state
from bigdl_tpu.nn.module import param_count as jparam_count
from bigdl_tpu.nn.quantized import Quantizer as JQuantizer
from bigdl_tpu.utils.table import T as JT
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
from bigdl_tpu_torch.interop import (load_module_params, module_params_tree,
                                     module_state)
from bigdl_tpu_torch.ir import ConversionUtils
from bigdl_tpu_torch.models import ResNet as TResNet
from bigdl_tpu_torch.models import lenet_graph
from bigdl_tpu_torch.nn import fusion
from bigdl_tpu_torch.utils import T

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: this file runs JAX beside torch (see
    tests/test_torch_recurrent.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------- helpers
def graph_of(seq, nn):
    """`seq` (a Sequential of `nn`, either package's) as a `nn.Graph` over
    the same leaf modules: a `Sequential` chains, a `ConcatTable` fans
    out, a node after a fan-out takes every branch."""
    def kids(m):
        return m.children_in_order() if hasattr(m, "children_in_order") \
            else m.children

    def chain(m, node):
        kind = type(m).__name__
        if kind == "Sequential":
            for c in kids(m):
                node = chain(c, node)
            return node
        if kind == "ConcatTable":
            return [chain(c, node) for c in kids(m)]
        return m.inputs(node)

    inp = nn.InputNode()
    return nn.Graph([inp], [chain(seq, inp)])


def keys_like(jm):
    """The JAX model's parameter-tree keys in its own order (a graph's in
    `exec_order`), leaves left out: what `like=` pairs by."""
    if hasattr(jm, "_child_keys"):
        return {k: keys_like(c) for k, c in zip(jm._child_keys, jm.children)}
    return {}


def carry_to_jax(tm, jm):
    """Set the JAX twin's parameters and BN state from the port model."""
    like = keys_like(jm)
    jm.set_params(_jnp_tree(module_params_tree(tm, like=like)))
    jm._state = {k: {s: jnp.asarray(v) for s, v in d.items()}
                 for k, d in module_state(tm, like=like).items()}
    return like


def _jnp_tree(t):
    return {k: _jnp_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in t.items()}


def _np_tree(t):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in t.items()}


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=what)


def _trees_close(got, want, rtol, atol, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _trees_close(got[k], want[k], rtol, atol, f"{path}/{k}")
        else:
            _close(got[k], want[k], rtol, atol, f"{path}/{k}")


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ------------------------------------------------ the reference's cases
def test_graph_with_two_outputs_matches_jax():
    def build(nn, **kw):
        inp = nn.InputNode()
        h2 = nn.ReLU().inputs(nn.Linear(4, 8, **kw).inputs(inp))
        return nn.Graph([inp], [nn.Linear(8, 2, **kw).inputs(h2),
                                nn.Linear(8, 3, **kw).inputs(h2)])
    tg, jg = build(tnn, device="cpu"), build(jnn)
    carry_to_jax(tg, jg)
    x = _x(2, 4)
    got = tg(torch.from_numpy(x))
    want = jg.forward(jnp.asarray(x))
    assert got[1].shape == (2, 2) and got[2].shape == (2, 3)
    _close(got[1].detach(), want[1])
    _close(got[2].detach(), want[2])


def test_graph_with_two_inputs_joined_matches_jax():
    def build(nn, **kw):
        i1, i2 = nn.InputNode(), nn.InputNode()
        j = nn.JoinTable(axis=1).inputs(i1, i2)
        return nn.Graph([i1, i2], [nn.Linear(7, 2, **kw).inputs(j)])
    tg, jg = build(tnn, device="cpu"), build(jnn)
    carry_to_jax(tg, jg)
    a, b = _x(2, 3, seed=1), _x(2, 4, seed=2)
    got = tg(T(torch.from_numpy(a), torch.from_numpy(b)))
    assert got.shape == (2, 2)
    _close(got.detach(), jg.forward(JT(jnp.asarray(a), jnp.asarray(b))))
    # a list of inputs is taken as the Table is
    torch.testing.assert_close(tg([torch.from_numpy(a),
                                   torch.from_numpy(b)]), got,
                               rtol=0, atol=0)


def _bn_relu_graph(nn, fan_out=False, **kw):
    bn_kw = {k: v for k, v in kw.items() if k != "generator"}
    inp = nn.InputNode()
    if fan_out:
        b = nn.BatchNormalization(4, **bn_kw).inputs(inp)
        return nn.Graph([inp], [nn.CAddTable().inputs(
            nn.ReLU().inputs(b), b)])
    h = nn.Linear(4, 6, **kw).inputs(inp)
    b = nn.BatchNormalization(6, **bn_kw).inputs(h)
    out = nn.Linear(6, 2, **kw).inputs(nn.ReLU().inputs(b))
    return nn.Graph([inp], [out])


@pytest.mark.parametrize("fan_out", [False, True])
def test_fusion_plan_matches_the_reference_by_index(fan_out):
    tg = _bn_relu_graph(tnn, fan_out, device="cpu")
    jg = _bn_relu_graph(jnn, fan_out)
    fused, skip = tg._fusion_plan()
    jfused, jskip = jg._fusion_plan()
    at = {n.id: i for i, n in enumerate(jg.exec_order)}
    assert fused == {at[i] for i in jfused}
    assert skip == {at[r]: at[b] for r, b in jskip.items()}
    assert (len(fused), len(skip)) == ((0, 0) if fan_out else (1, 1))
    assert [type(n.module).__name__ for n in tg.exec_order] == \
        [type(n.module).__name__ for n in jg.exec_order]


def test_fused_graph_output_and_state_bitwise_the_unfused():
    x = torch.from_numpy(_x(5, 4))
    runs = []
    for fuse in (True, False):
        g = _bn_relu_graph(tnn, device="cpu",
                           generator=torch.Generator().manual_seed(3))
        calls = {"n": 0}
        bn = g.exec_order[2].module
        orig = bn.forward_with_activation

        def counted(x, relu=True, _orig=orig):
            calls["n"] += 1
            return _orig(x, relu)
        bn.forward_with_activation = counted
        with fusion.fusion_scope(fuse):
            out = g.train()(x)
        runs.append((out.detach(), bn.mean.clone(), bn.var.clone(),
                     calls["n"]))
    (o1, m1, v1, n1), (o0, m0, v0, n0) = runs
    assert (n1, n0) == (1, 0)
    for a, b in ((o1, o0), (m1, m0), (v1, v0)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_frozen_or_cut_modules_are_not_fusible_as_the_reference():
    for pkg, kw in ((tnn, {"device": "cpu"}), (jnn, {})):
        bn = pkg.SpatialBatchNormalization(4, **kw)
        relu = pkg.ReLU()
        fus = fusion if pkg is tnn else jfusion
        assert fus.fusible_bn(bn) and fus.fusible_activation(relu)
        bn.freeze()
        assert not fus.fusible_bn(bn)
        bn.unfreeze()
        assert fus.fusible_bn(bn)
        relu.stop_gradient([relu.name])
        assert not fus.fusible_activation(relu)
    # a freeze after the first forward changes the cached plan
    g = _bn_relu_graph(tnn, device="cpu")
    assert len(g._fusion_plan()[0]) == 1
    g.freeze(["BatchNormalization"])
    assert g._fusion_plan() == (frozenset(), {})


# ------------------------------------------------------ CIFAR ResNet-8
STEPS = 2


def _resnet8_pair():
    tm = TResNet(10, depth=8, data_set="cifar10", device="cpu",
                 generator=torch.Generator().manual_seed(4))
    with torch.no_grad():  # small non-zero gammas for the zero-init BNs
        rs = np.random.RandomState(5)
        for m in tm.modules():
            if isinstance(m, tnn.BatchNormalization):
                scale = 1.0 if bool(m.weight.any()) else 0.1
                m.weight.copy_(torch.from_numpy(
                    ((rs.rand(m.n_output) + 0.5) * scale).astype(
                        np.float32)))
                m.bias.copy_(torch.from_numpy(
                    (rs.randn(m.n_output) * 0.1).astype(np.float32)))
    tg = graph_of(tm, tnn)
    jg = graph_of(JResNet(10, depth=8, data_set="cifar10"), jnn)
    carry_to_jax(tg, jg)
    return tg, jg


def _cifar_batch():
    rs = np.random.RandomState(7)
    return (rs.rand(4, 8, 8, 3).astype(np.float32),
            (rs.randint(0, 10, size=4) + 1).astype(np.int32))


def test_resnet8_graph_forward_loss_and_gradients_match_jax():
    tg, jg = _resnet8_pair()
    fused, _ = tg._fusion_plan()
    assert len(fused) == 1 + 3  # the stem and each basic block's bn1
    x, y = _cifar_batch()
    like = keys_like(jg)
    params = jg.ensure_params()
    crit = jnn.ClassNLLCriterion()

    def loss(p):
        out, new = jfunctional_apply(jg, p, jnp.asarray(x),
                                     state=jg._state, training=True)
        return crit.forward(out, jnp.asarray(y)), (out, new)
    (jloss, (jout, jnew)), jgrad = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    out = tg.train()(torch.from_numpy(x))
    tloss = tnn.ClassNLLCriterion()(out, torch.from_numpy(y))
    tloss.backward()
    _close(out.detach(), jout)
    _close(tloss.item(), float(jloss))
    _trees_close(module_params_tree(tg, grad=True, like=like),
                 _np_tree(jgrad), GRAD_RTOL, GRAD_ATOL)
    tstate = module_state(tg, like=like)
    assert set(tstate) == set(jnew)
    for path, stats in jnew.items():
        for k in ("mean", "var"):
            _close(tstate[path][k], stats[k], what=f"{path} {k}")


def test_resnet8_graph_trains_as_the_jax_graph():
    tg, jg = _resnet8_pair()
    x, y = _cifar_batch()
    like = keys_like(jg)
    jopt = joptim.LocalOptimizer(jg, JLocalDataSet([JMiniBatch(x, y)]),
                                 jnn.ClassNLLCriterion())
    topt = toptim.LocalOptimizer(tg, LocalDataSet([MiniBatch(x, y)]),
                                 tnn.ClassNLLCriterion(), device="cpu")
    losses = {}
    for name, opt, mod in (("jax", jopt, joptim), ("port", topt, toptim)):
        opt.set_graph_optimizations(True)
        opt.set_optim_method(mod.SGD(learning_rate=0.01, momentum=0.9))
        opt.set_end_when(mod.max_iteration(STEPS))
        losses[name] = []
        opt.set_iteration_hook(
            lambda s, out=losses[name]: out.append(s["loss"]))
        opt.optimize()
    assert len(losses["port"]) == STEPS
    _close(losses["port"], losses["jax"])
    tstate = module_state(tg, like=like)
    for path, stats in jg._state.items():
        for k in ("mean", "var"):
            _close(tstate[path][k], stats[k], what=f"{path} {k}")


# --------------------------------------------- freeze and stop_gradient
def _mlp_graph(nn, **kw):
    inp = nn.InputNode()
    h = nn.Linear(4, 6, name="fc1", **kw).inputs(inp)
    h = nn.Tanh(name="act").inputs(h)
    h = nn.Linear(6, 5, name="fc2", **kw).inputs(h)
    return nn.Graph([inp], [nn.Linear(5, 3, name="fc3", **kw).inputs(h)])


@pytest.mark.parametrize("gate", ["freeze", "stop_gradient"])
def test_freeze_and_stop_gradient_gradients_match_jax(gate):
    tg, jg = _mlp_graph(tnn, device="cpu"), _mlp_graph(jnn)
    carry_to_jax(tg, jg)
    getattr(tg, gate)(["fc2"])
    getattr(jg, gate)(["fc2"])
    x = _x(3, 4)
    w = _x(3, 3, seed=4)

    def f(p):
        out, _ = jfunctional_apply(jg, p, jnp.asarray(x))
        return jnp.sum(out * w)
    jgrad = _np_tree(jax.grad(f)(jg.ensure_params()))
    out = tg(torch.from_numpy(x))
    (out * torch.from_numpy(w)).sum().backward()
    for key, sub in jgrad.items():
        tkey = {n.name: k for k, n in tg.named_children()}[
            key.rsplit("_", 1)[0]]
        for leaf, want in sub.items():
            g = getattr(tg.get_submodule(tkey), leaf).grad
            got = np.zeros_like(want) if g is None else g.numpy()
            _close(got, want, GRAD_RTOL, GRAD_ATOL, f"{key}/{leaf}")
    fc1 = jgrad[[k for k in jgrad if k.startswith("fc1")][0]]
    assert np.abs(fc1["weight"]).max() == 0 if gate == "stop_gradient" \
        else np.abs(fc1["weight"]).max() > 0
    # unfreeze: the gradient comes back
    if gate == "freeze":
        tg.unfreeze(["fc2"])
        tg.zero_grad()
        tg(torch.from_numpy(x)).sum().backward()
        assert tg.get_submodule(
            [k for k in tg._modules if k.startswith("fc2")][0]
        ).weight.grad.abs().max() > 0


def test_freeze_gates_a_module_inside_a_composite_one():
    seq = tnn.Sequential().add(tnn.Linear(4, 3, name="inner",
                                          device="cpu"))
    seq.freeze()  # the container: every parameter under it
    x = torch.randn(2, 4, requires_grad=True)
    seq(x).sum().backward()
    assert seq.get_submodule("0_inner").weight.grad is None
    assert x.grad is not None and x.grad.abs().max() > 0
    assert seq.get_submodule("0_inner").weight.requires_grad
    with pytest.raises(KeyError, match="no sub-module named"):
        seq.freeze(["nope"])


# --------------------------------------------------------------- lenet
def test_lenet_graph_matches_jax():
    tg = lenet_graph(10, device="cpu",
                     generator=torch.Generator().manual_seed(1))
    jg = jlenet_graph(10)
    carry_to_jax(tg, jg)
    assert [type(n.module).__name__ for n in tg.exec_order] == \
        [type(n.module).__name__ for n in jg.exec_order]
    x = np.random.RandomState(2).rand(3, 28, 28).astype(np.float32)
    with torch.no_grad():
        got = tg.eval()(torch.from_numpy(x))
    _close(got, jg.forward(jnp.asarray(x), training=False))


# ------------------------------------------------------------------ IR
def _stem_graph(nn, **kw):
    inp = nn.InputNode()
    h = nn.SpatialConvolution(3, 8, 7, 7, 2, 2, 3, 3, with_bias=False,
                              **kw).inputs(inp)
    return nn.Graph([inp], [nn.ReLU().inputs(h)])


def test_graph_stem_restates_as_the_reference():
    tg, jg = _stem_graph(tnn, device="cpu"), _stem_graph(jnn)
    carry_to_jax(tg, jg)
    x = np.random.RandomState(1).rand(1, 16, 16, 3).astype(np.float32)
    with torch.no_grad():
        want = tg.eval()(torch.from_numpy(x))
    w = tg.exec_order[1].module.weight
    out = ConversionUtils.apply_tpu_restatements(tg)
    jout = JConversion.apply_tpu_restatements(jg)
    node = out.exec_order[1]
    assert type(node.module).__name__ == "SpaceToDepthStemConvolution"
    assert out._modules[node.key] is node.module and node.module.weight is w
    assert [type(n.module).__name__ for n in out.exec_order] == \
        [type(n.module).__name__ for n in jout.exec_order]
    with torch.no_grad():
        got = out(torch.from_numpy(x))
    _close(got, want)
    _close(got, jout.forward(jnp.asarray(x), training=False))


def test_convert_folds_no_bn_in_a_graph_and_drops_its_noise():
    def build(nn, **kw):
        inp = nn.InputNode()
        h = nn.Linear(4, 6, **kw).inputs(inp)
        b = nn.BatchNormalization(6, **kw).inputs(h)
        d = nn.Dropout(0.5).inputs(nn.ReLU().inputs(b))
        return nn.Graph([inp], [d])
    tg, jg = build(tnn, device="cpu"), build(jnn)
    carry_to_jax(tg, jg)
    out = ConversionUtils.convert(copy.deepcopy(tg).eval())
    jout = JConversion.convert(jg.evaluate())
    kinds = [type(n.module).__name__ for n in out.exec_order]
    assert kinds == [type(n.module).__name__ for n in jout.exec_order]
    assert kinds[2] == "BatchNormalization" and kinds[-1] == "Identity"
    assert [n.key for n in out.exec_order] == list(out._modules)
    x = _x(3, 4)
    with torch.no_grad():
        _close(out(torch.from_numpy(x)),
               jout.forward(jnp.asarray(x), training=False))


def test_set_graph_optimizations_restates_a_graph_and_trains_as_jax():
    rs = np.random.RandomState(0)
    x = rs.rand(16, 16, 16, 3).astype(np.float32)
    y = (rs.randint(0, 4, size=16) + 1).astype(np.int32)

    def build(nn, **kw):
        inp = nn.InputNode()
        h = nn.SpatialConvolution(3, 8, 7, 7, 2, 2, 3, 3, with_bias=False,
                                  **kw).inputs(inp)
        h = nn.Pooler().inputs(nn.ReLU().inputs(h))
        return nn.Graph([inp], [nn.LogSoftMax().inputs(
            nn.Linear(8, 4, **kw).inputs(h))])
    tg, jg = build(tnn, device="cpu"), build(jnn)
    carry_to_jax(tg, jg)
    shapes = [tuple(p.shape) for p in tg.parameters()]
    losses = {}
    for name, model, mod, ds in (
            ("jax", jg, joptim, JLocalDataSet([JMiniBatch(x, y)])),
            ("port", tg, toptim, LocalDataSet([MiniBatch(x, y)]))):
        kw = {} if name == "jax" else {"device": "cpu"}
        opt = mod.LocalOptimizer(model, ds, (jnn if name == "jax" else tnn)
                                 .ClassNLLCriterion(), **kw)
        opt.set_graph_optimizations(True)
        opt.set_optim_method(mod.SGD(learning_rate=0.05))
        opt.set_end_when(mod.max_iteration(4))
        losses[name] = []
        opt.set_iteration_hook(
            lambda s, out=losses[name]: out.append(s["loss"]))
        trained = opt.optimize()
        assert type(trained.exec_order[1].module).__name__ == \
            "SpaceToDepthStemConvolution"
    assert [tuple(p.shape) for p in tg.parameters()] == shapes
    _close(losses["port"], losses["jax"])


# ------------------------------------------------------------ quantizer
def test_graph_quantizes_bitwise_as_the_jax_graph():
    def build(nn, **kw):
        inp = nn.InputNode()
        h = nn.ReLU().inputs(nn.Linear(12, 24, **kw).inputs(inp))
        return nn.Graph([inp], [nn.Linear(24, 3, **kw).inputs(h)])
    tg = build(tnn, device="cpu",
               generator=torch.Generator().manual_seed(4))
    jg = build(jnn)
    like = carry_to_jax(tg, jg)
    tg.eval()
    jg.evaluate()
    x = np.random.RandomState(4).randn(5, 12).astype(np.float32)
    q = tg.quantize()
    jq = JQuantizer.quantize(jg)
    assert [type(n.module).__name__ for n in q.exec_order] == \
        ["Input", "QuantizedLinear", "ReLU", "QuantizedLinear"]
    assert [n.key for n in q.exec_order] == [n.key for n in tg.exec_order]
    assert [n.key for n in q.exec_order] == list(q._modules)
    assert all(type(n.module).__name__ == "Linear" for n in tg.exec_order
               if n.module.name == "Linear")  # the float graph intact
    jtree = _np_tree(jq.ensure_params())
    ttree = module_params_tree(q, like=like)
    for k in jtree:
        for leaf in jtree[k]:
            np.testing.assert_array_equal(ttree[k][leaf], jtree[k][leaf])
    with torch.no_grad():
        got = q(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jq.forward(
        jnp.asarray(x), training=False)))


# ------------------------------------------------- the functional core
def test_functional_apply_merge_state_and_param_count_match_jax():
    def build(nn, **kw):
        return (nn.Sequential().add(nn.Linear(4, 6, **kw))
                .add(nn.BatchNormalization(6, **kw)).add(nn.ReLU()))
    tm, jm = build(tnn, device="cpu"), build(jnn)
    carry_to_jax(tm, jm)
    x = _x(5, 4)
    tparams = {k: {n: p for n, p in c.named_parameters()}
               for k, c in tm.named_children()}
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    out, new = tnn.functional_apply(tm, tparams, torch.from_numpy(x),
                                    training=True)
    jout, jnew = jfunctional_apply(jm, jm.ensure_params(), jnp.asarray(x),
                                   state=jm._state, training=True)
    _close(out.detach(), jout)
    assert set(new) == set(jnew) == {("1_BatchNormalization",)}
    for k in ("mean", "var"):
        _close(new[("1_BatchNormalization",)][k],
               jnew[("1_BatchNormalization",)][k])
    for k, v in tm.state_dict().items():  # the module's own are untouched
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    # eval mode reads the given state and writes none; an orphan path and
    # a missing leaf are ignored, as in the reference
    state = tnn.merge_state({("9_Gone",): {"mean": torch.zeros(6)}}, new)
    assert set(state) == {("9_Gone",), ("1_BatchNormalization",)}
    ev, none = tnn.functional_apply(tm, {}, torch.from_numpy(x),
                                    state=state)
    jev, jnone = jfunctional_apply(
        jm, jm.ensure_params(), jnp.asarray(x),
        state=jmerge_state(jm._state, jnew))
    assert none == {} and jnone == {}
    _close(ev.detach(), jev)
    assert tm.training  # modes restored
    assert tnn.param_count(tparams) == jparam_count(jm.ensure_params()) \
        == 4 * 6 + 6 + 6 + 6
    # gradients reach the given tensors
    leaf = {k: {n: p.detach().clone().requires_grad_() for n, p in d.items()}
            for k, d in tparams.items()}
    y, _ = tnn.functional_apply(tm, leaf, torch.from_numpy(x),
                                training=True)
    y.sum().backward()
    assert leaf["0_Linear"]["weight"].grad is not None
    assert tm.get_submodule("0_Linear").weight.grad is None


# ----------------------------------------------------------- error probes
def test_a_cycle_raises_as_the_reference():
    for nn, kw in ((tnn, {"device": "cpu"}), (jnn, {})):
        inp = nn.InputNode()
        a = nn.Linear(4, 4, **kw).inputs(inp)
        b = nn.Linear(4, 4, **kw).inputs(a)
        a.prev.append(b)
        with pytest.raises(ValueError, match="cycle detected in graph"):
            nn.Graph([inp], [b])


def test_a_wrong_input_count_raises_as_the_reference():
    tg, jg = _mlp_graph(tnn, device="cpu"), _mlp_graph(jnn)
    carry_to_jax(tg, jg)
    x = _x(2, 4)
    with pytest.raises(ValueError, match="graph expects 1 inputs, got 2"):
        tg(T(torch.from_numpy(x), torch.from_numpy(x)))
    with pytest.raises(ValueError, match="graph expects 1 inputs, got 2"):
        jg.forward(JT(jnp.asarray(x), jnp.asarray(x)))


def test_a_dotted_key_raises_with_the_key():
    inp = tnn.InputNode()
    node = tnn.ReLU(name="block.relu").inputs(inp)
    with pytest.raises(ValueError, match=f"'{node.key}' holds a '.'"):
        tnn.Graph([inp], [node])


# ------------------------------------------------------------ deep copies
def test_deepcopy_of_a_300_node_chain_at_the_default_limit():
    assert sys.getrecursionlimit() <= 1000
    inp = tnn.InputNode()
    node = inp
    for i in range(300):
        node = (tnn.ReLU() if i % 2 else tnn.Identity()).inputs(node)
    g = tnn.Graph([inp], [node])
    c = copy.deepcopy(g)
    assert [n.key for n in c.exec_order] == [n.key for n in g.exec_order]
    for a, b in zip(c.exec_order, g.exec_order):
        assert a is not b and a.module is not b.module
        assert c._modules[a.key] is a.module
        assert [id(p) for p in a.prev] == [
            id(c.exec_order[g.exec_order.index(p)]) for p in b.prev]
    x = torch.randn(2, 3)
    torch.testing.assert_close(c(x), g(x), rtol=0, atol=0)


@pytest.fixture(scope="module")
def resnet50_graph():
    from bigdl_tpu_torch.models import ResNet50
    return graph_of(ResNet50(10, device="cpu"), tnn)


SITES = ["meta_twin", "local_predictor", "distri_predictor",
         "elastic_replica", "quantizer"]


@pytest.mark.parametrize("site", SITES)
def test_resnet50_graph_deep_copies_at_every_port_site(resnet50_graph, site):
    """The five places the port deep-copies a model, each on a ResNet-50
    Graph (over 150 nodes in one chain) at the default recursion limit."""
    from bigdl_tpu_torch.optim import DistriOptimizer, LocalPredictor
    from bigdl_tpu_torch.optim.local_optimizer import _meta
    from bigdl_tpu_torch.optim.predictor import DistriPredictor
    from bigdl_tpu_torch.parallel import Mesh
    g = resnet50_graph
    assert len(g.exec_order) > 150 and sys.getrecursionlimit() <= 1000
    if site == "meta_twin":
        c = _meta(g)
        assert next(c.parameters()).device.type == "meta"
    elif site == "local_predictor":
        c = LocalPredictor(g, device="cpu").model
    elif site == "distri_predictor":
        pred = DistriPredictor(g, 4, Mesh(["cpu", "cpu:0"], ("data",)))
        c = pred._model_on(torch.device("cpu", 0))
    elif site == "elastic_replica":
        x, y = np.zeros((1, 32, 32, 3), np.float32), np.ones(1, np.int32)
        opt = DistriOptimizer(g, LocalDataSet([MiniBatch(x, y)]),
                              tnn.ClassNLLCriterion(), devices=["cpu"])
        c = opt._slot_model(torch.device("cpu", 0), {})[0]
    else:
        c = g.quantize()
    assert c is not g and len(c.exec_order) == len(g.exec_order)
    assert all(c._modules[n.key] is n.module for n in c.exec_order)
    assert all(a.module is not b.module
               for a, b in zip(c.exec_order, g.exec_order))


# ------------------------------------------- weights carried by position
def test_jax_graph_weights_load_by_position():
    def build(nn, **kw):
        inp = nn.InputNode()
        h = nn.BatchNormalization(3, **kw).inputs(
            nn.Linear(2, 3, **kw).inputs(inp))
        return nn.Graph([inp], [nn.Linear(3, 2, **kw).inputs(h)])
    tg, jg = build(tnn, device="cpu"), build(jnn)
    jg.ensure_params()
    params = _np_tree(jg._params)  # JAX dict order: its exec_order
    state = {k: {s: np.asarray(v) + 0.5 for s, v in d.items()}
             for k, d in jg._state.items()}
    assert list(params) != [n.key for n in tg.exec_order]
    load_module_params(tg, params, state)
    _trees_close(module_params_tree(tg, like=params), params, 0, 0)
    got = module_state(tg, like=params)
    for path in state:
        for k in ("mean", "var"):
            np.testing.assert_array_equal(got[path][k], state[path][k])
    x = _x(4, 2)
    jg._state = {k: {s: jnp.asarray(v) for s, v in d.items()}
                 for k, d in state.items()}
    with torch.no_grad():
        _close(tg.eval()(torch.from_numpy(x)),
               jg.forward(jnp.asarray(x), training=False))
    # a tree of another graph raises, naming the mismatch
    swapped = dict(reversed(list(params.items())))
    with pytest.raises((ValueError, KeyError)):
        load_module_params(tg, swapped)


def test_inference_engine_serves_a_graph_as_offline_predict():
    """`InferenceEngine` over `lenet_graph` (its conversion deep-copies the
    graph): every served row equal to the graph's own eval forward."""
    from bigdl_tpu_torch.serving import InferenceEngine
    g = lenet_graph(10, device="cpu",
                    generator=torch.Generator().manual_seed(2))
    x = np.random.RandomState(3).rand(6, 28, 28).astype(np.float32)
    with torch.no_grad():
        want = g.eval()(torch.from_numpy(x)).numpy()
    with InferenceEngine(g, max_batch_size=4, device="cpu") as eng:
        futs = [eng.submit(img) for img in x]
        got = np.stack([f.result(60) for f in futs])
    _close(got, want)
