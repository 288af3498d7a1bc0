"""Port parity: `bigdl_tpu_torch.nn.dynamic_graph` (`DynamicGraph`, the
control ops, `Scheduler`, `FrameManager`, `switch_port`) against
`bigdl_tpu.nn.dynamic_graph`, on the reference's cases
(`tests/test_dynamic_graph.py`): a cond both ways, the dead branch never
run, while loops (a counter, zero iterations, a parametrised body, ops
after the loop's exit, nested loops, two loops in sequence), the runaway
guard.

Each graph is built twice with the node DSL, once from each package: the
TF-style operands of the reference's cases (`ops.Less`, `ops.Greater`,
`ops.FloorMod`, `ops.Sum`, the loader's `_TFConst`) are not ported, so
the port's side uses the small modules defined here with the same
arithmetic. Outputs equal the reference's within atol 1e-6 (f32; the
loops are exact); a layer's parameters in a loop body are carried from
the JAX graph into the port (`interop.load_module_params`, nodes paired
by position) and the gradients through the loop agree within 1e-5 of
their tensor's largest element. The model file of a `DynamicGraph` is
written as the reference writes it (no field for a Switch port) and
refused on load.
"""

import copy
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
import bigdl_tpu.ops as jops
from bigdl_tpu.interop._tf_modules import _TFConst
from bigdl_tpu.nn.dynamic_graph import switch_port as jswitch_port
from bigdl_tpu.nn.module import functional_apply
from bigdl_tpu.serialization.module_serializer import ModuleSerializer as JS
from bigdl_tpu.utils.table import Table as JTable
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.interop import load_module_params, module_params_tree
from bigdl_tpu_torch.serialization import ModuleSerializer
from bigdl_tpu_torch.utils import T

ATOL = 1e-6
GRAD_RTOL = 1e-5


class Const(tnn.Module):
    """A constant operand (the reference's loader-internal `_TFConst`)."""

    def __init__(self, value, name=None):
        super().__init__(name)
        self.value = torch.tensor(np.asarray(value))

    def forward(self, x):
        return self.value


class _Binary(tnn.Module):
    fn = None

    def forward(self, xs):
        return type(self).fn(xs[1], xs[2])


class Less(_Binary):
    fn = staticmethod(torch.lt)


class Greater(_Binary):
    fn = staticmethod(torch.gt)


class FloorMod(_Binary):
    fn = staticmethod(torch.remainder)


class Sum(tnn.Module):
    def __init__(self, axis, name=None):
        super().__init__(name)
        self.axis = axis

    def forward(self, x):
        return x.sum(self.axis)


JAX = types.SimpleNamespace(
    nn=jnn, switch_port=jswitch_port, Const=_TFConst, Less=jops.Less,
    Greater=jops.Greater, FloorMod=jops.FloorMod,
    Sum=lambda axis: jops.Sum(axis=axis), Linear=jnn.Linear,
    Table=JTable, tensor=jnp.asarray)
PORT = types.SimpleNamespace(
    nn=tnn, switch_port=tnn.switch_port, Const=Const, Less=Less,
    Greater=Greater, FloorMod=FloorMod, Sum=Sum,
    Linear=lambda i, o: tnn.Linear(i, o, device="cpu"), Table=T,
    tensor=lambda a: torch.from_numpy(np.asarray(a)))


def _f32(v):
    return np.asarray(v, np.float32)


def cond_graph(ns, true_module=None, false_module=None):
    """if pred: x * 2 else: x + 10 (the TF1 Switch/Merge lowering)."""
    nn = ns.nn
    x_in, p_in = nn.InputNode(), nn.InputNode()
    sw = nn.SwitchOps().inputs(x_in, p_in)
    t = ns.switch_port((true_module or nn.MulConstant(2.0)).inputs(sw), sw, 1)
    f = ns.switch_port((false_module or nn.AddConstant(10.0)).inputs(sw),
                       sw, 0)
    return nn.DynamicGraph([x_in, p_in], [nn.MergeOps().inputs(t, f)])


def _count_up_to(ns, src, limit, frame=""):
    nn = ns.nn
    enter = nn.Enter(frame).inputs(src)
    merge = nn.MergeOps().inputs(enter)
    pred = ns.Less().inputs(merge, ns.Const(_f32(limit)).inputs())
    sw = nn.SwitchOps().inputs(merge, nn.LoopCondOps().inputs(pred))
    body = ns.switch_port(nn.AddConstant(1.0).inputs(sw), sw, 1)
    merge.prev.append(nn.NextIteration().inputs(body))  # the back edge
    return ns.switch_port(nn.Exit().inputs(sw), sw, 0)


def loop_graph(ns, limit):
    """while i < limit: i = i + 1."""
    i_in = ns.nn.InputNode()
    return ns.nn.DynamicGraph([i_in], [_count_up_to(ns, i_in, limit,
                                                    "loop")])


def relu_loop_graph(ns):
    """x = relu(x) - 0.5 while sum(x) > 1."""
    nn = ns.nn
    x_in = nn.InputNode()
    merge = nn.MergeOps().inputs(nn.Enter().inputs(x_in))
    s = ns.Sum(0).inputs(merge)
    pred = ns.Greater().inputs(s, ns.Const(_f32(1.0)).inputs())
    sw = nn.SwitchOps().inputs(merge, nn.LoopCondOps().inputs(pred))
    relu = ns.switch_port(nn.ReLU().inputs(sw), sw, 1)
    merge.prev.append(nn.NextIteration().inputs(
        nn.AddConstant(-0.5).inputs(relu)))
    return nn.DynamicGraph([x_in], [ns.switch_port(nn.Exit().inputs(sw),
                                                   sw, 0)])


def post_exit_graph(ns):
    """(while i < 10: i += 1) * 2: a node after the loop's Exit."""
    i_in = ns.nn.InputNode()
    post = ns.nn.MulConstant(2.0).inputs(_count_up_to(ns, i_in, 10.0))
    return ns.nn.DynamicGraph([i_in], [post])


def nested_graph(ns):
    """3 rounds of x += 1, then round x up to a multiple of 4."""
    nn = ns.nn
    x_in = nn.InputNode()
    merge_c = nn.MergeOps().inputs(nn.Enter("outer").inputs(
        ns.Const(_f32(0.0)).inputs()))
    merge_x = nn.MergeOps().inputs(nn.Enter("outer").inputs(x_in))
    ocond = nn.LoopCondOps().inputs(ns.Less().inputs(
        merge_c, ns.Const(_f32(3.0)).inputs()))
    sw_c = nn.SwitchOps().inputs(merge_c, ocond)
    sw_x = nn.SwitchOps().inputs(merge_x, ocond)
    inner_in = ns.switch_port(nn.AddConstant(1.0).inputs(sw_x), sw_x, 1)
    merge_i = nn.MergeOps().inputs(nn.Enter("inner").inputs(inner_in))
    rem = ns.FloorMod().inputs(merge_i, ns.Const(_f32(4.0)).inputs())
    icond = nn.LoopCondOps().inputs(ns.Greater().inputs(
        rem, ns.Const(_f32(0.0)).inputs()))
    sw_i = nn.SwitchOps().inputs(merge_i, icond)
    ibody = ns.switch_port(nn.AddConstant(1.0).inputs(sw_i), sw_i, 1)
    merge_i.prev.append(nn.NextIteration().inputs(ibody))
    iexit = ns.switch_port(nn.Exit().inputs(sw_i), sw_i, 0)
    c_next = ns.switch_port(nn.AddConstant(1.0).inputs(sw_c), sw_c, 1)
    merge_c.prev.append(nn.NextIteration().inputs(c_next))
    merge_x.prev.append(nn.NextIteration().inputs(iexit))
    exit_x = ns.switch_port(nn.Exit().inputs(sw_x), sw_x, 0)
    return nn.DynamicGraph([x_in], [exit_x])


def two_loops_graph(ns):
    """count to 5, double, count to 13: two loops of default frame
    names that must not coalesce."""
    x_in = ns.nn.InputNode()
    first = _count_up_to(ns, x_in, 5.0)
    scaled = ns.nn.MulConstant(2.0).inputs(first)
    return ns.nn.DynamicGraph([x_in], [_count_up_to(ns, scaled, 13.0)])


def linear_loop_graph(ns):
    """Two loop variables: x = tanh(Linear(x)) three times, counted by
    c; the Linear's weights are the graph's parameters."""
    nn = ns.nn
    x_in = nn.InputNode()
    merge_c = nn.MergeOps().inputs(nn.Enter().inputs(
        ns.Const(_f32(0.0)).inputs()))
    merge_x = nn.MergeOps().inputs(nn.Enter().inputs(x_in))
    cond = nn.LoopCondOps().inputs(ns.Less().inputs(
        merge_c, ns.Const(_f32(3.0)).inputs()))
    sw_c = nn.SwitchOps().inputs(merge_c, cond)
    sw_x = nn.SwitchOps().inputs(merge_x, cond)
    lin = ns.switch_port(ns.Linear(4, 4).inputs(sw_x), sw_x, 1)
    merge_x.prev.append(nn.NextIteration().inputs(nn.Tanh().inputs(lin)))
    c_next = ns.switch_port(nn.AddConstant(1.0).inputs(sw_c), sw_c, 1)
    merge_c.prev.append(nn.NextIteration().inputs(c_next))
    out = ns.switch_port(nn.Exit().inputs(sw_x), sw_x, 0)
    return nn.DynamicGraph([x_in], [out])


def _np(tree):
    return {k: _np(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else np.asarray(tree)


#: name -> (graph factory, input as numpy: one array, or a list of them)
CASES = {
    "cond_true": (cond_graph, [_f32([3.0, 4.0]), np.asarray(True)]),
    "cond_false": (cond_graph, [_f32([3.0, 4.0]), np.asarray(False)]),
    "loop_counts_to_limit": (lambda ns: loop_graph(ns, 10.0), _f32(0.0)),
    "loop_zero_iterations": (lambda ns: loop_graph(ns, 10.0), _f32(42.0)),
    "loop_parametrized_body": (relu_loop_graph, _f32([2.0, 2.0])),
    "ops_after_loop_exit": (post_exit_graph, _f32(0.0)),
    "nested_while_loops": (nested_graph, _f32(1.0)),
    "two_sequential_loops": (two_loops_graph, _f32(0.0)),
}


def _run(ns, g, x):
    if isinstance(x, list):
        return g.forward(ns.Table(*[ns.tensor(v) for v in x])) \
            if ns is JAX else g(ns.Table(*[ns.tensor(v) for v in x]))
    return g.forward(ns.tensor(x)) if ns is JAX else g(ns.tensor(x))


@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_matches_the_reference(case):
    build, x = CASES[case]
    want = np.asarray(_run(JAX, build(JAX), x))
    got = _run(PORT, build(PORT), x)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    expected = {"cond_true": [6.0, 8.0], "cond_false": [13.0, 14.0],
                "loop_counts_to_limit": 10.0, "loop_zero_iterations": 42.0,
                "loop_parametrized_body": [0.5, 0.5],
                "ops_after_loop_exit": 20.0, "nested_while_loops": 12.0,
                "two_sequential_loops": 13.0}[case]
    np.testing.assert_allclose(got.numpy(), expected, atol=ATOL, rtol=0)


def test_dead_branch_never_runs():
    calls = []

    class Probe(tnn.Identity):
        def forward(self, x):
            calls.append(1)
            return x

    g = cond_graph(PORT, false_module=Probe())
    out = g(T(torch.tensor([1.0]), torch.tensor(True)))
    assert out.tolist() == [2.0] and calls == []
    g(T(torch.tensor([1.0]), torch.tensor(False)))
    assert calls == [1]


def test_runaway_loop_guard():
    g = loop_graph(PORT, float("inf"))
    old = tnn.Scheduler.MAX_ITERATIONS
    tnn.Scheduler.MAX_ITERATIONS = 50
    try:
        with pytest.raises(RuntimeError, match="MAX_ITERATIONS"):
            g(torch.tensor(0.0))
    finally:
        tnn.Scheduler.MAX_ITERATIONS = old


def test_wrong_input_count_raises():
    with pytest.raises(ValueError, match="expects 2 inputs"):
        cond_graph(PORT)(torch.tensor([1.0]))


def test_frames_are_the_reference_s():
    """FrameManager finds one frame a loop (keyed by its LoopCond), the
    same member counts as the reference's; exec_order lists the same
    modules in the same order."""
    for build in (nested_graph, two_loops_graph, linear_loop_graph):
        j, t = build(JAX), build(PORT)
        assert [type(n.module).__name__ for n in t.exec_order] == [
            {"_TFConst": "Const", "Sum": "Sum"}.get(
                type(n.module).__name__, type(n.module).__name__)
            for n in j.exec_order]
        assert sorted(len(f.members) for f in t._frames.frames) == \
            sorted(len(f.members) for f in j._frames.frames)
        assert t._frames.has_loops


def test_loop_body_parameters_and_gradients_match_the_reference():
    """A Linear inside a while loop: the JAX graph's tree holds only that
    node; carried into the port by position, the output and the gradients
    of sum(out * w) through three iterations agree."""
    jg, tg = linear_loop_graph(JAX), linear_loop_graph(PORT)
    params = _np(jg.init(jax.random.PRNGKey(2)))
    assert len(params) == 1
    load_module_params(tg, params)
    x = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    w = np.random.RandomState(1).randn(2, 4).astype(np.float32)

    def f(p):
        out, _ = functional_apply(jg, p, jnp.asarray(x))
        return jnp.sum(out * w), out
    (_, want), grads = jax.value_and_grad(f, has_aux=True)(params)
    out = tg(torch.from_numpy(x))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    got = module_params_tree(tg, grad=True, like=params)
    for key, leaves in _np(grads).items():
        for leaf, b in leaves.items():
            np.testing.assert_allclose(
                got[key][leaf], b, rtol=0,
                atol=GRAD_RTOL * max(float(np.abs(b).max()), 1e-6))


def test_deep_copy_keeps_the_switch_ports_and_loops():
    g = nested_graph(PORT)
    c = copy.deepcopy(g)
    assert c(torch.tensor(1.0)).item() == 12.0
    assert all(a is not b for a, b in zip(c.exec_order, g.exec_order))
    assert g(torch.tensor(5.0)).item() == c(torch.tensor(5.0)).item()
    cg = copy.deepcopy(cond_graph(PORT))
    assert cg(T(torch.tensor([3.0]), torch.tensor(False))).tolist() == [13.0]


def test_host_syncs_count_device_predicates_only():
    """On the CPU a Switch reads its predicate without a device sync."""
    tnn.SwitchOps.host_syncs = 0
    loop_graph(PORT, 4.0)(torch.tensor(0.0))
    assert tnn.SwitchOps.host_syncs == 0


def test_the_model_file_is_the_reference_s_and_is_refused_on_load(
        tmp_path):
    """The port writes a DynamicGraph as the reference does (the same node
    modules, wiring and outputs); neither package reads such a file back:
    the format has no field for a Switch port."""
    from bigdl_tpu.proto import bigdl_model_pb2 as pb2
    jg, tg = cond_graph(JAX), cond_graph(PORT)
    jp, tp = str(tmp_path / "j.bigdl"), str(tmp_path / "t.bigdl")
    JS.save(jg, jp)
    ModuleSerializer.save(tg, tp)

    def wiring(path):
        mp = pb2.ModelProto.FromString(open(path, "rb").read())
        gd = mp.module.graph
        return (mp.module.module_type,
                [(n.module.module_type, list(n.prev)) for n in gd.nodes],
                list(gd.input_nodes), list(gd.output_nodes))
    assert wiring(tp) == wiring(jp)
    with pytest.raises(NotImplementedError, match="Switch port"):
        ModuleSerializer.load(tp, device="cpu")
    with pytest.raises(IndexError):
        JS.load(tp)
