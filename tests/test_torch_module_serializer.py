"""The model-file format of the port (`serialization/module_serializer.py`,
`proto/bigdl_model.py`) against the reference's.

- the committed fixture `tests/resources/golden_model_v1.bigdl` loads and
  gives its stored output (the reference's rtol 1e-5 / atol 1e-6);
- the hand-written codec against the generated `bigdl_model_pb2` (every
  field kind: a map, packed ints, nested modules, a tensor attribute, a
  bf16 tensor, None, a tuple, a negative int64, a zero oneof), both ways;
- a registry-driven sweep: every class the port registers round-trips
  bitwise, or stands in `SKIP` with its reason;
- both directions for every class both registries hold, on the sweep's
  inputs: a JAX-written file loads in the port and gives the JAX forward,
  a port-written file loads in the JAX package and gives the port's
  forward, within ATOL (the zoo's single-layer parity tolerance: the same
  f32 arithmetic in another order);
- storage dedup, the quantized round trip of `tests/test_quantized.py`,
  the refusals, and a file written on either device.

The zoo models across packages and the module trees each package writes
are in `tests/test_torch_module_serializer_zoo.py`.
"""

import os
import subprocess
import sys
import tempfile
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
import bigdl_tpu.ops as jops
from bigdl_tpu.proto import bigdl_model_pb2 as pb2
from bigdl_tpu.serialization import ModuleSerializer as JS
from bigdl_tpu.serialization.module_serializer import \
    registered_modules as jregistered
from bigdl_tpu.utils.table import T as JT
import bigdl_tpu_torch.nn as tnn
import bigdl_tpu_torch.ops as tops
from bigdl_tpu_torch.interop import module_params_tree, module_state
from bigdl_tpu_torch.proto import bigdl_model as P
from bigdl_tpu_torch.serialization import (ModuleSerializer,
                                           register_module,
                                           registered_modules)
from bigdl_tpu_torch.serialization._reference_modules import REFERENCE_ONLY
from bigdl_tpu_torch.utils import T

RES = os.path.join(os.path.dirname(__file__), "resources")
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# the golden fixture
# --------------------------------------------------------------------------
def _golden_input():
    return np.linspace(-1, 1, 2 * 8 * 8 * 3).reshape(2, 8, 8, 3) \
        .astype(np.float32)


def test_golden_model_file_loads_and_matches():
    m = ModuleSerializer.load(os.path.join(RES, "golden_model_v1.bigdl"),
                              device="cpu")
    assert [type(c).__name__ for c in m.children_in_order()] == [
        "SpatialConvolution", "SpatialBatchNormalization", "ReLU",
        "Reshape", "Linear", "LogSoftMax"]
    assert m.name == "golden" and m.training  # saved in training mode
    with torch.no_grad():
        out = m.eval()(torch.from_numpy(_golden_input())).numpy()
    want = np.load(os.path.join(RES, "golden_model_v1_out.npy"))
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)


def test_load_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModuleSerializer.load(os.path.join(RES, "golden_model_v1.bigdl"))


# --------------------------------------------------------------------------
# the codec against the generated module
# --------------------------------------------------------------------------
def _pb2_rich():
    """A ModelProto using every field kind of the schema."""
    mp = pb2.ModelProto(framework_version="bigdl_tpu-0.1")
    bm = mp.module
    bm.module_type, bm.name, bm.evaluating = "Sequential", "root", True
    bm.ctor_args.add().i = 0                 # a zero oneof member
    bm.ctor_args.add().i = -7                # a negative int64
    bm.ctor_args.add().b = False
    bm.ctor_args.add().none = True
    bm.ctor_args.add().s = ""
    bm.ctor_args.add().d = -2.5
    bm.ctor_args.add().dtype = "bfloat16"
    tup = bm.ctor_args.add()
    tup.is_tuple = True
    for v in (3, 4):
        tup.list.items.add().i = v
    bm.ctor_args.add().tensor.storage_id = 1
    bm.ctor_kwargs["pad_w"].i = 1
    bm.ctor_kwargs["weight"].tensor.shape.extend([2, 3])
    bm.ctor_kwargs["inner"].module.module_type = "Linear"
    child = bm.children.add()
    child.module_type = "Linear"
    child.ctor_args.add().i = 4
    bm.graph.input_nodes.extend([0, -1])
    node = bm.graph.nodes.add()
    node.key, node.module.module_type = "n0", "ReLU"
    node.prev.extend([1, 2, 300])
    for path, shape, dtype, sid in (("0_Linear/weight", [4, 3], "float32", 0),
                                    ("0_Linear/bias", [3], "bfloat16", 1)):
        nt = mp.parameters.add(path=path)
        nt.tensor.shape.extend(shape)
        nt.tensor.dtype, nt.tensor.storage_id = dtype, sid
    nt = mp.state.add(path="1_BN::mean")
    nt.tensor.shape.append(3)
    mp.storages.add(id=0, data=np.arange(12, dtype=np.float32).tobytes())
    mp.storages.add(id=1, data=np.arange(3, dtype=np.uint16).tobytes())
    mp.storages.add(id=2, data=b"")
    return mp


def _port_rich():
    """The same message, built through the port's API."""
    mp = P.ModelProto(framework_version="bigdl_tpu-0.1",
                      module=P.BigDLModule(module_type="Sequential",
                                           name="root", evaluating=True))
    bm = mp.module
    bm.ctor_args.add(i=0)
    bm.ctor_args.add(i=-7)
    bm.ctor_args.add(b=False)
    bm.ctor_args.add(none=True)
    bm.ctor_args.add(s="")
    bm.ctor_args.add(d=-2.5)
    bm.ctor_args.add(dtype="bfloat16")
    bm.ctor_args.add(list=P.ListValue(items=[P.AttrValue(i=3),
                                             P.AttrValue(i=4)]),
                     is_tuple=True)
    bm.ctor_args.add(tensor=P.TensorProto(storage_id=1))
    bm.ctor_kwargs["pad_w"] = P.AttrValue(i=1)
    bm.ctor_kwargs["weight"] = P.AttrValue(tensor=P.TensorProto(shape=[2, 3]))
    bm.ctor_kwargs["inner"] = P.AttrValue(
        module=P.BigDLModule(module_type="Linear"))
    bm.children.add(module_type="Linear", ctor_args=[P.AttrValue(i=4)])
    bm.graph = P.GraphDef(input_nodes=[0, -1])
    bm.graph.nodes.add(key="n0", module=P.BigDLModule(module_type="ReLU"),
                       prev=[1, 2, 300])
    mp.parameters.add(path="0_Linear/weight", tensor=P.TensorProto(
        shape=[4, 3], dtype="float32", storage_id=0))
    mp.parameters.add(path="0_Linear/bias", tensor=P.TensorProto(
        shape=[3], dtype="bfloat16", storage_id=1))
    mp.state.add(path="1_BN::mean", tensor=P.TensorProto(shape=[3]))
    mp.storages.add(id=0, data=np.arange(12, dtype=np.float32).tobytes())
    mp.storages.add(id=1, data=np.arange(3, dtype=np.uint16).tobytes())
    mp.storages.add(id=2, data=b"")
    return mp


def test_pb2_parses_the_port_bytes_to_an_equal_message():
    want = _pb2_rich()
    got = pb2.ModelProto.FromString(_port_rich().SerializeToString())
    assert got == want


def test_the_port_parses_pb2_bytes_and_writes_them_back():
    want = _pb2_rich()
    port = P.ModelProto.FromString(want.SerializeToString())
    assert port == _port_rich()
    bm = port.module
    assert [a.WhichOneof("value") for a in bm.ctor_args] == [
        "i", "i", "b", "none", "s", "d", "dtype", "list", "tensor"]
    assert bm.ctor_args[1].i == -7 and bm.ctor_args[7].is_tuple
    assert bm.graph.input_nodes == [0, -1]
    assert bm.graph.nodes[0].prev == [1, 2, 300]
    assert bm.HasField("graph") and not bm.children[0].HasField("graph")
    assert pb2.ModelProto.FromString(port.SerializeToString()) == want


def test_default_scalars_are_left_out_and_oneof_members_written():
    assert P.BigDLModule(evaluating=False, name="").SerializeToString() \
        == b""
    assert P.TensorProto(storage_id=0).SerializeToString() == b""
    for field, value in (("i", 0), ("b", False), ("s", ""), ("d", 0.0),
                         ("none", True)):
        got = P.AttrValue(**{field: value}).SerializeToString()
        assert got == pb2.AttrValue(**{field: value}).SerializeToString()
        assert got != b""
    # negative varints take ten bytes; packed ints one length-delimited
    assert len(P.AttrValue(i=-1).SerializeToString()) == 11
    assert P.TensorProto(shape=[1, 2]).SerializeToString() == \
        b"\x0a\x02\x01\x02"


def test_unpacked_repeated_ints_and_unknown_fields_decode():
    # shape as two unpacked varints, then an unknown varint (field 9)
    # and an unknown length-delimited field (field 10)
    data = b"\x08\x05\x08\x06" + b"\x48\x07" + b"\x52\x02ab" + \
        b"\x12\x07float32"
    tp = P.TensorProto.FromString(data)
    assert tp.shape == [5, 6] and tp.dtype == "float32"
    assert tp == P.TensorProto.FromString(
        pb2.TensorProto.FromString(data).SerializeToString())


def test_golden_file_reencodes_to_an_equal_model_proto():
    with open(os.path.join(RES, "golden_model_v1.bigdl"), "rb") as f:
        data = f.read()
    port = P.ModelProto.FromString(data)
    assert pb2.ModelProto.FromString(port.SerializeToString()) == \
        pb2.ModelProto.FromString(data)


def test_the_port_imports_no_protobuf():
    code = ("import sys, numpy as np, torch\n"
            "import bigdl_tpu_torch.nn as nn\n"
            "from bigdl_tpu_torch.serialization import ModuleSerializer\n"
            "m = nn.Sequential().add(nn.Linear(4, 3, device='cpu'))\n"
            "ModuleSerializer.save(m, sys.argv[1])\n"
            "ModuleSerializer.load(sys.argv[1], device='cpu')\n"
            "bad = [k for k in sys.modules if k.startswith(("
            "'google.protobuf', 'jax', 'bigdl_tpu.'))]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory() as d:
        subprocess.run([sys.executable, "-c", code,
                        os.path.join(d, "m.bigdl")], check=True,
                       env={**os.environ, "PYTHONPATH": root}, timeout=120)


# --------------------------------------------------------------------------
# inputs and specs
# --------------------------------------------------------------------------
VEC = np.linspace(-1.0, 1.0, 8).astype(np.float32)
MAT = np.linspace(-1.0, 1.0, 8).reshape(2, 4).astype(np.float32)
SEQ = np.linspace(-1.0, 1.0, 40).reshape(2, 5, 4).astype(np.float32)
IMG = np.linspace(-1.0, 1.0, 2 * 8 * 8 * 3).reshape(2, 8, 8, 3).astype(
    np.float32)
IDS = np.array([[1, 2], [3, 4]], np.float32)  # 1-based lookup ids
EMB = np.random.RandomState(2).randn(2, 5, 8).astype(np.float32)
QKV = tuple(np.random.RandomState(i).randn(2, 2, 5, 4).astype(np.float32)
            for i in range(3))
WORDS = np.array([["a", "b"], ["c", "zz"]])
PAIR = ("table", MAT.copy(), (MAT * 0.5 + 0.1).astype(np.float32))
SPARSE = ("table", ("table", np.array([[0, 1], [2, -1]], np.int32),
                    np.array([[1.0, 2.0], [3.0, 0.0]], np.float32)),
          ("table", np.array([[1, -1], [0, 3]], np.int32),
           np.array([[4.0, 0.0], [5.0, 6.0]], np.float32)))
CROSS = ("table", np.array(["a", "b"]), np.array(["x", "y"]))


def _port_in(x):
    if isinstance(x, tuple) and x and x[0] == "table":
        return T(*[_port_in(v) for v in x[1:]])
    if x.dtype.kind in ("U", "S", "O"):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def _jax_in(x):
    if isinstance(x, tuple) and x and x[0] == "table":
        return JT(*[_jax_in(v) for v in x[1:]])
    if x.dtype.kind in ("U", "S", "O"):
        return x
    return jnp.asarray(x)


def _cpu(**kw):
    return {"device": "cpu", **kw}


def _quantized(kind):
    """A quantized layer from a float one of seeded weights (bare
    constructors hold zero weights)."""
    g = torch.Generator().manual_seed(3)
    if kind.endswith("Linear"):
        f = tnn.Linear(4, 3, device="cpu", generator=g)
    elif kind == "QuantizedSpatialDilatedConvolution":
        f = tnn.SpatialDilatedConvolution(3, 4, 3, 3, dilation_w=2,
                                          dilation_h=2, device="cpu",
                                          generator=g)
    else:
        f = tnn.SpatialConvolution(3, 4, 3, 3, device="cpu", generator=g)
    return getattr(tnn, kind).from_float(f)


#: name -> (port factory, JAX factory or None, input); JAX factory None:
#: a port-only registration
SPECS = {
    "Linear": (lambda: tnn.Linear(4, 3, **_cpu()),
               lambda: jnn.Linear(4, 3), MAT),
    "SparseLinear": (lambda: tnn.SparseLinear(4, 3, **_cpu()),
                     lambda: jnn.SparseLinear(4, 3), MAT),
    "LookupTable": (lambda: tnn.LookupTable(10, 4, **_cpu()),
                    lambda: jnn.LookupTable(10, 4), IDS),
    "LookupTableSparse": (lambda: tnn.LookupTableSparse(10, 4, **_cpu()),
                          lambda: jnn.LookupTableSparse(10, 4), IDS),
    "SparseJoinTable": (lambda: tnn.SparseJoinTable([4, 4]),
                        lambda: jnn.SparseJoinTable([4, 4]), SPARSE),
    "DenseToSparse": (lambda: tnn.DenseToSparse(),
                      lambda: jnn.DenseToSparse(), MAT),
    "SpatialConvolution": (
        lambda: tnn.SpatialConvolution(3, 4, 3, 3, pad_w=1, pad_h=1,
                                       **_cpu()),
        lambda: jnn.SpatialConvolution(3, 4, 3, 3, pad_w=1, pad_h=1), IMG),
    "SpaceToDepthStemConvolution": (
        lambda: tnn.SpaceToDepthStemConvolution(3, 4, 3, **_cpu()),
        lambda: jnn.SpaceToDepthStemConvolution(3, 4, 3), IMG),
    "SpatialDilatedConvolution": (
        lambda: tnn.SpatialDilatedConvolution(3, 4, 3, 3, dilation_w=2,
                                              dilation_h=2, **_cpu()),
        lambda: jnn.SpatialDilatedConvolution(3, 4, 3, 3, dilation_w=2,
                                              dilation_h=2), IMG),
    "SpatialMaxPooling": (lambda: tnn.SpatialMaxPooling(2, 2, 2, 2),
                          lambda: jnn.SpatialMaxPooling(2, 2, 2, 2), IMG),
    "SpatialAveragePooling": (
        lambda: tnn.SpatialAveragePooling(2, 2, 2, 2),
        lambda: jnn.SpatialAveragePooling(2, 2, 2, 2), IMG),
    "BatchNormalization": (lambda: tnn.BatchNormalization(4, **_cpu()),
                           lambda: jnn.BatchNormalization(4), MAT),
    "SpatialBatchNormalization": (
        lambda: tnn.SpatialBatchNormalization(3, **_cpu()),
        lambda: jnn.SpatialBatchNormalization(3), IMG),
    "LayerNormalization": (lambda: tnn.LayerNormalization(4, **_cpu()),
                           lambda: jnn.LayerNormalization(4), MAT),
    "SpatialCrossMapLRN": (lambda: tnn.SpatialCrossMapLRN(),
                           lambda: jnn.SpatialCrossMapLRN(), IMG),
    "Reshape": (lambda: tnn.Reshape([4]), lambda: jnn.Reshape([4]),
                np.ones((3, 2, 2), np.float32)),
    "Mean": (lambda: tnn.Mean(1), lambda: jnn.Mean(1), MAT),
    "Pooler": (lambda: tnn.Pooler(), lambda: jnn.Pooler(), IMG),
    "ReLU": (lambda: tnn.ReLU(), lambda: jnn.ReLU(), MAT),
    "Tanh": (lambda: tnn.Tanh(), lambda: jnn.Tanh(), MAT),
    "Sigmoid": (lambda: tnn.Sigmoid(), lambda: jnn.Sigmoid(), MAT),
    "LogSoftMax": (lambda: tnn.LogSoftMax(), lambda: jnn.LogSoftMax(), MAT),
    "Identity": (lambda: tnn.Identity(), lambda: jnn.Identity(), MAT),
    "CAddTable": (lambda: tnn.CAddTable(), lambda: jnn.CAddTable(), PAIR),
    "Dropout": (lambda: tnn.Dropout(0.5), lambda: jnn.Dropout(0.5), MAT),
    "Sequential": (
        lambda: tnn.Sequential().add(tnn.Linear(4, 3, **_cpu()))
        .add(tnn.Tanh()),
        lambda: jnn.Sequential().add(jnn.Linear(4, 3)).add(jnn.Tanh()),
        MAT),
    "Concat": (
        lambda: tnn.Concat(1).add(tnn.Linear(4, 2, **_cpu()))
        .add(tnn.Linear(4, 3, **_cpu())),
        lambda: jnn.Concat(1).add(jnn.Linear(4, 2)).add(jnn.Linear(4, 3)),
        MAT),
    "ConcatTable": (
        lambda: tnn.ConcatTable().add(tnn.Linear(4, 2, **_cpu()))
        .add(tnn.Identity()),
        lambda: jnn.ConcatTable().add(jnn.Linear(4, 2)).add(jnn.Identity()),
        MAT),
    "TimeDistributed": (
        lambda: tnn.TimeDistributed(tnn.Linear(4, 2, **_cpu())),
        lambda: jnn.TimeDistributed(jnn.Linear(4, 2)), SEQ),
    "Recurrent": (lambda: tnn.Recurrent(tnn.LSTMCell(4, 3, **_cpu())),
                  lambda: jnn.Recurrent(jnn.LSTMCell(4, 3)), SEQ),
    "RnnCell": (lambda: tnn.Recurrent(tnn.RnnCell(4, 3, **_cpu())),
                lambda: jnn.Recurrent(jnn.RnnCell(4, 3)), SEQ),
    "LSTMCell": (lambda: tnn.Recurrent(tnn.LSTMCell(4, 3, **_cpu()),
                                       return_sequences=False),
                 lambda: jnn.Recurrent(jnn.LSTMCell(4, 3),
                                       return_sequences=False), SEQ),
    "LSTM": (lambda: tnn.Recurrent(tnn.LSTM(4, 3, **_cpu())),
             lambda: jnn.Recurrent(jnn.LSTM(4, 3)), SEQ),
    "LSTM2": (lambda: tnn.Recurrent(tnn.LSTM2(4, 3, **_cpu())),
              lambda: jnn.Recurrent(jnn.LSTM2(4, 3)), SEQ),
    "MultiRNNCell": (
        lambda: tnn.Recurrent(tnn.MultiRNNCell(
            [tnn.LSTMCell(4, 4, **_cpu()), tnn.RnnCell(4, 3, **_cpu())])),
        lambda: jnn.Recurrent(jnn.MultiRNNCell(
            [jnn.LSTMCell(4, 4), jnn.RnnCell(4, 3)])), SEQ),
    "MultiHeadAttention": (
        lambda: tnn.MultiHeadAttention(8, 2, **_cpu()),
        lambda: jnn.MultiHeadAttention(8, 2), EMB),
    "ScaledDotProductAttention": (
        lambda: tnn.ScaledDotProductAttention(causal=True),
        lambda: jnn.ScaledDotProductAttention(causal=True),
        ("table",) + QKV),
    "TransformerBlock": (
        lambda: tnn.TransformerBlock(8, 2, 2, causal=True, **_cpu()),
        lambda: jnn.TransformerBlock(8, 2, 2, causal=True), EMB),
    "BucketizedCol": (lambda: tops.BucketizedCol([0.0, 0.5], **_cpu()),
                      lambda: jops.BucketizedCol([0.0, 0.5]), MAT),
    "CategoricalColHashBucket": (
        lambda: tops.CategoricalColHashBucket(10, **_cpu()),
        lambda: jops.CategoricalColHashBucket(10), WORDS),
    "CategoricalColVocaList": (
        lambda: tops.CategoricalColVocaList(["a", "b", "c"], **_cpu()),
        lambda: jops.CategoricalColVocaList(["a", "b", "c"]), WORDS),
    "CrossCol": (lambda: tops.CrossCol(10, **_cpu()),
                 lambda: jops.CrossCol(10), CROSS),
    "IndicatorCol": (lambda: tops.IndicatorCol(5, **_cpu()),
                     lambda: jops.IndicatorCol(5),
                     np.array([[1, 2], [3, 0]], np.int32)),
    "Kv2Tensor": (lambda: tops.Kv2Tensor(feat_len=4, **_cpu()),
                  lambda: jops.Kv2Tensor(feat_len=4),
                  np.array(["0:1.0,1:2.0", "2:3.0"])),
    "MkString": (lambda: tops.MkString("-"), lambda: jops.MkString("-"),
                 np.array([[1, 2, 3], [4, 5, 6]], np.int32)),
    "Substr": (lambda: tops.Substr(1, 2), lambda: jops.Substr(1, 2),
               np.array(["hello", "xyz"])),
}


def _graph(nn, **kw):
    """Linear -> BN -> ReLU fanned out to ReLU and Tanh, joined: a diamond
    with a fused site."""
    inp = nn.InputNode()
    h = nn.Linear(4, 6, **kw).inputs(inp)
    b = nn.BatchNormalization(6, **kw).inputs(h)
    r = nn.ReLU().inputs(b)
    out = nn.JoinTable(1).inputs(nn.ReLU().inputs(r), nn.Tanh().inputs(r))
    return nn.Graph([inp], [out])


GATES = np.array([[0.25, 0.75], [0.6, 0.4]], np.float32)
SPECS.update({
    "Input": (lambda: tnn.Input(), lambda: jnn.Input(), MAT),
    "ParallelTable": (
        lambda: tnn.ParallelTable().add(tnn.Linear(4, 2, **_cpu()))
        .add(tnn.Linear(4, 3, **_cpu())),
        lambda: jnn.ParallelTable().add(jnn.Linear(4, 2))
        .add(jnn.Linear(4, 3)), PAIR),
    "MapTable": (lambda: tnn.MapTable().add(tnn.Linear(4, 3, **_cpu())),
                 lambda: jnn.MapTable().add(jnn.Linear(4, 3)), PAIR),
    "Bottle": (lambda: tnn.Bottle(tnn.Linear(4, 3, **_cpu()), 2),
               lambda: jnn.Bottle(jnn.Linear(4, 3), 2), SEQ),
    **{name: (lambda name=name: getattr(tnn, name)(),
              lambda name=name: getattr(jnn, name)(), PAIR)
       for name in ("CSubTable", "CMulTable", "CDivTable", "CMaxTable",
                    "CMinTable", "CAveTable")},
    "JoinTable": (lambda: tnn.JoinTable(1), lambda: jnn.JoinTable(1), PAIR),
    "SplitTable": (lambda: tnn.SplitTable(1), lambda: jnn.SplitTable(1),
                   SEQ),
    "FlattenTable": (lambda: tnn.FlattenTable(),
                     lambda: jnn.FlattenTable(),
                     ("table", MAT, ("table", MAT * 2, (MAT - 1)))),
    "SelectTable": (lambda: tnn.SelectTable(2), lambda: jnn.SelectTable(2),
                    PAIR),
    "NarrowTable": (lambda: tnn.NarrowTable(1, 2),
                    lambda: jnn.NarrowTable(1, 2), PAIR),
    "MixtureTable": (lambda: tnn.MixtureTable(), lambda: jnn.MixtureTable(),
                     ("table", GATES, ("table", MAT, MAT * 0.5))),
    "Echo": (lambda: tnn.Echo(), lambda: jnn.Echo(), MAT),
    "BifurcateSplitTable": (lambda: tnn.BifurcateSplitTable(1),
                            lambda: jnn.BifurcateSplitTable(1), MAT),
    "Graph": (lambda: _graph(tnn, **_cpu()), lambda: _graph(jnn), MAT),
})
SPECS["StaticGraph"] = SPECS["Graph"]  # the reference's alias of Graph
SPECS["RNN"] = SPECS["RnnCell"]  # the reference's alias of RnnCell
SPECS["SpatialShareConvolution"] = SPECS["SpatialConvolution"]  # an alias
for _q, _x in (("QuantizedLinear", MAT), ("WeightOnlyQuantizedLinear", MAT),
               ("QuantizedSpatialConvolution", IMG),
               ("QuantizedSpatialDilatedConvolution", IMG),
               ("WeightOnlyQuantizedSpatialConvolution", IMG)):
    _kw = {"dilation_w": 2, "dilation_h": 2} \
        if _q == "QuantizedSpatialDilatedConvolution" else {}
    SPECS[_q] = (lambda _q=_q: _quantized(_q),
                 lambda _q=_q, _kw=_kw: getattr(jnn, _q)(
                     *((4, 3) if _q.endswith("Linear") else (3, 4, 3, 3)),
                     **_kw), _x)

IMG_SEQ = np.linspace(-1.0, 1.0, 2 * 3 * 4 * 4 * 3).reshape(
    2, 3, 4, 4, 3).astype(np.float32)
VOL_SEQ = np.linspace(-1.0, 1.0, 2 * 3 * 3 * 3 * 3).reshape(
    1, 2, 3, 3, 3, 3).astype(np.float32)
TREE = ("table", EMB[:, :3, :4].copy(),
        np.array([[[0, 0, 1], [0, 0, 2], [1, 2, 0], [0, 0, 0]],
                  [[0, 0, 2], [0, 0, 3], [0, 0, 1], [3, 1, 0]]], np.int32))


def _remat(nn, **kw):
    return nn.Remat(nn.Sequential().add(nn.Linear(4, 3, **kw))
                    .add(nn.BatchNormalization(3, **kw)).add(nn.Tanh()))


def _cell_spec(name, make, x):
    return (lambda: tnn.Recurrent(make(tnn, _cpu())),
            lambda: jnn.Recurrent(make(jnn, {})), x)


SPECS.update({
    "Add": (lambda: tnn.Add(4, **_cpu()), lambda: jnn.Add(4), MAT),
    "AddConstant": (lambda: tnn.AddConstant(1.5),
                    lambda: jnn.AddConstant(1.5), MAT),
    "Bilinear": (lambda: tnn.Bilinear(4, 4, 3, **_cpu()),
                 lambda: jnn.Bilinear(4, 4, 3), PAIR),
    "CAdd": (lambda: tnn.CAdd((1, 4), **_cpu()), lambda: jnn.CAdd((1, 4)),
             MAT),
    "CMul": (lambda: tnn.CMul((1, 4), **_cpu()), lambda: jnn.CMul((1, 4)),
             MAT),
    "Cosine": (lambda: tnn.Cosine(4, 3, **_cpu()),
               lambda: jnn.Cosine(4, 3), MAT),
    "Euclidean": (lambda: tnn.Euclidean(4, 3, **_cpu()),
                  lambda: jnn.Euclidean(4, 3), MAT),
    "Highway": (lambda: tnn.Highway(4, **_cpu()), lambda: jnn.Highway(4),
                MAT),
    "Maxout": (lambda: tnn.Maxout(4, 3, 2, **_cpu()),
               lambda: jnn.Maxout(4, 3, 2), MAT),
    "Mul": (lambda: tnn.Mul(**_cpu()), lambda: jnn.Mul(), MAT),
    "MulConstant": (lambda: tnn.MulConstant(2.0),
                    lambda: jnn.MulConstant(2.0), MAT),
    "Scale": (lambda: tnn.Scale((1, 4), **_cpu()), lambda: jnn.Scale((1, 4)),
              MAT),
    "Remat": (lambda: _remat(tnn, **_cpu()), lambda: _remat(jnn), MAT),
    "BiRecurrent": (lambda: tnn.BiRecurrent(tnn.LSTMCell(4, 3, **_cpu())),
                    lambda: jnn.BiRecurrent(jnn.LSTMCell(4, 3)), SEQ),
    "RecurrentDecoder": (
        lambda: tnn.RecurrentDecoder(tnn.LSTMCell(4, 4, **_cpu()), 3),
        lambda: jnn.RecurrentDecoder(jnn.LSTMCell(4, 4), 3), MAT),
    **{name: _cell_spec(name, lambda nn, kw, name=name: getattr(nn, name)(
        4, 3, **kw), SEQ)
       for name in ("GRU", "GRUCell", "LSTMPeephole", "LSTMPeepholeCell")},
    "ConvLSTMPeephole": _cell_spec(
        "ConvLSTMPeephole",
        lambda nn, kw: nn.ConvLSTMPeephole(3, 2, **kw), IMG_SEQ),
    "ConvLSTMPeephole3D": _cell_spec(
        "ConvLSTMPeephole3D",
        lambda nn, kw: nn.ConvLSTMPeephole3D(3, 2, **kw), VOL_SEQ),
    "BinaryTreeLSTM": (lambda: tnn.BinaryTreeLSTM(4, 3, **_cpu()),
                       lambda: jnn.BinaryTreeLSTM(4, 3), TREE),
    "SwitchOps": (lambda: tnn.SwitchOps(), lambda: jnn.SwitchOps(),
                  ("table", MAT, np.array(True))),
    "MergeOps": (lambda: tnn.MergeOps(), lambda: jnn.MergeOps(), PAIR),
    "Enter": (lambda: tnn.Enter("loop"), lambda: jnn.Enter("loop"), MAT),
    **{name: (lambda name=name: getattr(tnn, name)(),
              lambda name=name: getattr(jnn, name)(), MAT)
       for name in ("Exit", "NextIteration", "LoopCondOps",
                    "ControlTrigger")},
})

#: name -> why it is not round-tripped alone
SKIP = {
    "Module": "abstract base, never instantiated",
    "Container": "abstract base; Sequential, Concat, ConcatTable swept",
    "Cell": "abstract recurrent-cell base; the concrete cells swept",
    "Operation": "abstract base of ops.*; the feature columns swept",
    "ControlOps": "the control ops' marker base; each control op swept",
    "TreeLSTM": "abstract tree-LSTM base; BinaryTreeLSTM swept",
    "DynamicGraph": "the format has no field for a Switch port, so "
                    "neither package reads a DynamicGraph file back; "
                    "tests/test_torch_dynamic_graph.py holds the port's "
                    "file to the reference's and its refusal",
}


def _registry_names():
    return sorted(registered_modules())


def test_sweep_is_total():
    missing = [n for n in _registry_names()
               if n not in SKIP and n not in SPECS]
    assert not missing, f"registered without a spec or a skip: {missing}"


def _forward(m, x):
    m.eval()
    with torch.no_grad():
        if isinstance(m, tnn.ScaledDotProductAttention):
            return m(*[_port_in(v) for v in x[1:]])
        return m(_port_in(x))


def _as_list(out):
    if type(out).__name__ == "_Dead":  # each package has its own token
        return [np.array("<dead>")]
    if isinstance(out, (list, tuple)) or hasattr(out, "keys") \
            and not isinstance(out, (np.ndarray, torch.Tensor)):
        vals = list(out.values()) if hasattr(out, "values") else list(out)
        return [v for o in vals for v in _as_list(o)]
    if isinstance(out, torch.Tensor):
        return [out.detach().cpu().numpy()]
    return [np.asarray(out)]


def _assert_outputs(got, want, atol=ATOL, exact=False):
    got, want = _as_list(got), _as_list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w.dtype.kind in ("U", "S", "O") or exact:
            assert g.shape == w.shape and g.tolist() == w.tolist()
        else:
            np.testing.assert_allclose(g, w.astype(g.dtype), atol=atol,
                                       rtol=0)


def _settle(m):
    """Non-trivial BN running statistics."""
    for mod in m.modules():
        if isinstance(mod, tnn.BatchNormalization):
            rs = np.random.RandomState(7)
            with torch.no_grad():
                mod.mean.copy_(torch.from_numpy(
                    rs.randn(*mod.mean.shape).astype(np.float32)))
                mod.var.copy_(torch.from_numpy(
                    rs.rand(*mod.var.shape).astype(np.float32) + 0.5))


@pytest.mark.parametrize("name", [n for n in _registry_names()
                                  if n not in SKIP])
def test_round_trip(name, tmp_path):
    factory, _, x = SPECS[name]
    m = factory()
    _settle(m)
    want = _forward(m, x)
    path = str(tmp_path / "m.bigdl")
    ModuleSerializer.save(m, path)
    loaded = ModuleSerializer.load(path, device="cpu")
    assert type(loaded) is type(m) and loaded.name == m.name
    got = _forward(loaded, x)
    _assert_outputs(got, want, exact=True)


# --------------------------------------------------------------------------
# across packages
# --------------------------------------------------------------------------
BOTH = sorted(n for n in SPECS if n in jregistered())


def _np_tree(t):
    return {k: _np_tree(v) for k, v in t.items()} if isinstance(t, dict) \
        else np.array(t)


def _keys_like(jm):
    """The JAX model's tree keys in its own order (a graph's node keys in
    `exec_order`, which differ from the port twin's ids)."""
    if hasattr(jm, "_child_keys"):
        return {k: _keys_like(c) for k, c in zip(jm._child_keys, jm.children)}
    return {}


def _jax_twin(name, m):
    """The JAX layer of `name` holding `m`'s parameters and BN state (no
    JAX init: set from the port's trees, a graph's nodes by position)."""
    jm = SPECS[name][1]()
    like = _keys_like(jm)
    jm.set_params(jax.tree_util.tree_map(
        jnp.asarray, _np_tree(module_params_tree(m, like=like))))
    jm._state = {k: {s: jnp.asarray(v) for s, v in d.items()}
                 for k, d in module_state(m, like=like).items()}
    return jm


def _jax_forward(jm, x):
    return jm.forward(_jax_in(x), training=False)


@pytest.mark.parametrize("name", BOTH)
def test_a_jax_file_loads_in_the_port(name, tmp_path):
    factory, _, x = SPECS[name]
    m = factory()
    _settle(m)
    jm = _jax_twin(name, m)
    path = str(tmp_path / "j.bigdl")
    JS.save(jm, path)
    loaded = ModuleSerializer.load(path, device="cpu")
    assert type(loaded).__name__ == type(jm).__name__
    _assert_outputs(_forward(loaded, x), _jax_forward(jm, x))


@pytest.mark.parametrize("name", BOTH)
def test_a_port_file_loads_in_the_jax_package(name, tmp_path):
    factory, _, x = SPECS[name]
    m = factory()
    _settle(m)
    path = str(tmp_path / "t.bigdl")
    ModuleSerializer.save(m, path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no dropped leaf
        loaded = JS.load(path)
    _assert_outputs(_jax_forward(loaded, x), _forward(m, x))


def test_the_port_registry_and_the_reference_only_list():
    port, ref = set(registered_modules()), set(jregistered())
    assert port <= ref  # the port registers only reference types
    assert REFERENCE_ONLY == ref - port


# --------------------------------------------------------------------------
# storage dedup (the reference's TestStorageDedup), mode, state
# --------------------------------------------------------------------------
def test_shared_parameter_stored_once(tmp_path):
    a = tnn.Linear(8, 8, device="cpu")
    b = tnn.Linear(8, 8, device="cpu",
                   generator=torch.Generator().manual_seed(1))
    b.weight = a.weight  # tied
    seq = tnn.Sequential().add(a).add(b)
    path = str(tmp_path / "tied.bigdl")
    ModuleSerializer.save(seq, path)
    with open(path, "rb") as f:
        mp = pb2.ModelProto.FromString(f.read())
    weight_ids = [nt.tensor.storage_id for nt in mp.parameters
                  if nt.path.endswith("weight")]
    assert len(weight_ids) == 2 and weight_ids[0] == weight_ids[1]
    assert len(mp.storages) == 3  # one weight, two biases
    loaded = ModuleSerializer.load(path, device="cpu")
    l0, l1 = loaded.children_in_order()
    torch.testing.assert_close(l0.weight, l1.weight, rtol=0, atol=0)
    # ...and the reference reads the deduped file the same way
    jl = JS.load(path).parameters()
    np.testing.assert_array_equal(np.asarray(jl["0_Linear"]["weight"]),
                                  np.asarray(jl["1_Linear"]["weight"]))


def test_bf16_leaves_round_trip_as_uint16(tmp_path):
    m = tnn.Sequential().add(tnn.Linear(4, 3, device="cpu")) \
        .add(tnn.LogSoftMax()).to(torch.bfloat16)
    path = str(tmp_path / "bf16.bigdl")
    ModuleSerializer.save(m, path)
    with open(path, "rb") as f:
        mp = pb2.ModelProto.FromString(f.read())
    assert {nt.tensor.dtype for nt in mp.parameters} == {"bfloat16"}
    loaded = ModuleSerializer.load(path, device="cpu")
    assert loaded.get_submodule("0_Linear").weight.dtype == torch.bfloat16
    x = torch.from_numpy(MAT).to(torch.bfloat16)
    torch.testing.assert_close(loaded.eval()(x), m.eval()(x), rtol=0,
                               atol=0)
    # the reference reads the bf16 leaves as bf16
    jw = JS.load(path).parameters()["0_Linear"]["weight"]
    assert jw.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(jw).astype(np.float32),
        m.get_submodule("0_Linear").weight.float().detach().numpy())


def test_mode_is_per_module(tmp_path):
    m = tnn.Sequential().add(tnn.Linear(4, 3, device="cpu")) \
        .add(tnn.Dropout(0.5))
    m.eval()
    m.get_submodule("0_Linear").train()
    path = str(tmp_path / "mode.bigdl")
    ModuleSerializer.save(m, path)
    loaded = ModuleSerializer.load(path, device="cpu")
    assert [loaded.training, loaded.get_submodule("0_Linear").training,
            loaded.get_submodule("1_Dropout").training] == [False, True,
                                                            False]


def test_a_dropped_leaf_warns_with_the_reference_message(tmp_path):
    m = tnn.Sequential().add(tnn.Linear(4, 3, device="cpu"))
    path = str(tmp_path / "m.bigdl")
    ModuleSerializer.save(m, path)
    with open(path, "rb") as f:
        mp = P.ModelProto.FromString(f.read())
    mp.parameters.add(path="0_Linear/extra", tensor=mp.parameters[0].tensor)
    with open(path, "wb") as f:
        f.write(mp.SerializeToString())
    with pytest.warns(UserWarning, match="1 saved parameter leaves have no "
                      "slot .*0_Linear/extra.*will NOT match"):
        ModuleSerializer.load(path, device="cpu")


# --------------------------------------------------------------------------
# quantized models (tests/test_quantized.py's round trip)
# --------------------------------------------------------------------------
def _toy_port():
    g = torch.Generator().manual_seed(5)
    return (tnn.Sequential()
            .add(tnn.SpatialConvolution(1, 8, 3, 3, 1, 1, 1, 1,
                                        device="cpu", generator=g))
            .add(tnn.ReLU())
            .add(tnn.SpatialMaxPooling(2, 2, 2, 2))
            .add(tnn.Reshape([8 * 7 * 7]))
            .add(tnn.Linear(8 * 7 * 7, 10, device="cpu", generator=g))
            .add(tnn.LogSoftMax()))


def test_quantized_round_trip_is_bitwise(tmp_path):
    q = _toy_port().eval().quantize()
    x = torch.from_numpy(np.random.RandomState(5).rand(2, 14, 14, 1)
                         .astype(np.float32))
    with torch.no_grad():
        want = q(x)
    path = str(tmp_path / "q.bigdl")
    ModuleSerializer.save(q, path)
    loaded = ModuleSerializer.load(path, device="cpu")
    assert [type(c).__name__ for c in loaded.children_in_order()] == [
        type(c).__name__ for c in q.children_in_order()]
    with torch.no_grad():
        torch.testing.assert_close(loaded.eval()(x), want, rtol=0, atol=0)


def test_a_jax_quantized_file_loads_in_the_port(tmp_path):
    from bigdl_tpu.nn.quantized import Quantizer as JQ
    m = _toy_port()
    jm = (jnn.Sequential()
          .add(jnn.SpatialConvolution(1, 8, 3, 3, 1, 1, 1, 1))
          .add(jnn.ReLU()).add(jnn.SpatialMaxPooling(2, 2, 2, 2))
          .add(jnn.Reshape([8 * 7 * 7])).add(jnn.Linear(8 * 7 * 7, 10))
          .add(jnn.LogSoftMax()))
    jm.set_params(jax.tree_util.tree_map(
        jnp.asarray, _np_tree(module_params_tree(m))))
    jm._state = {}
    jm.evaluate()
    jq = JQ.quantize(jm)
    path = str(tmp_path / "jq.bigdl")
    JS.save(jq, path)
    loaded = ModuleSerializer.load(path, device="cpu")
    assert [type(c).__name__ for c in loaded.children_in_order()] == [
        type(c).__name__ for c in jq.children]
    x = np.random.RandomState(5).rand(2, 14, 14, 1).astype(np.float32)
    with torch.no_grad():
        got = loaded.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jq.forward(
        jnp.asarray(x), training=False)), atol=ATOL, rtol=0)


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------
def test_an_unregistered_module_refuses(tmp_path):
    class NotRegistered(tnn.Module):
        def forward(self, x):
            return x

    with pytest.raises(ValueError, match="not a registered"):
        ModuleSerializer.save(NotRegistered(), str(tmp_path / "x.bigdl"))
    # register_module makes it savable and loadable
    register_module(NotRegistered)
    try:
        ModuleSerializer.save(NotRegistered(name="n"),
                              str(tmp_path / "x.bigdl"))
        assert ModuleSerializer.load(str(tmp_path / "x.bigdl"),
                                     device="cpu").name == "n"
    finally:
        from bigdl_tpu_torch.serialization import module_serializer as ms
        ms._REGISTRY.pop("NotRegistered")


def test_resnet50_and_inception_v1_refuse_as_the_reference(tmp_path):
    from bigdl_tpu.models.resnet import ResNet50 as JResNet50
    from bigdl_tpu_torch.models import Inception_v1_NoAuxClassifier
    from bigdl_tpu_torch.models import ResNet50
    with pytest.raises(TypeError) as port:
        ModuleSerializer.save(ResNet50(1000, device="cpu"),
                              str(tmp_path / "r.bigdl"))
    with pytest.raises(TypeError) as ref:
        JS.save(JResNet50(1000), str(tmp_path / "j.bigdl"))
    msg = "cannot serialize constructor argument of type"
    assert msg in str(port.value) and msg in str(ref.value)
    assert "MsraFiller" in str(port.value) and "MsraFiller" in str(ref.value)
    with pytest.raises(TypeError, match=f"{msg} .*Xavier"):
        ModuleSerializer.save(Inception_v1_NoAuxClassifier(10, device="cpu"),
                              str(tmp_path / "i.bigdl"))


def test_transformer_lm_refuses_as_the_reference(tmp_path):
    from bigdl_tpu_torch.models import TransformerLM
    with pytest.raises(ValueError,
                       match="TransformerLM is not a registered module"):
        ModuleSerializer.save(TransformerLM(32, 16, 1, 2, device="cpu"),
                              str(tmp_path / "lm.bigdl"))


def test_a_graph_file_loads_across_packages(tmp_path):
    # a JAX-written graph loads in the port with its keys, the JAX output
    m = _graph(tnn, **_cpu())
    _settle(m)
    jg = _jax_twin("Graph", m)
    path = str(tmp_path / "g.bigdl")
    JS.save(jg, path)
    loaded = ModuleSerializer.load(path, device="cpu")
    assert type(loaded) is tnn.Graph
    assert [n.key for n in loaded.exec_order] == \
        [n.key for n in jg.exec_order] == list(loaded._modules)
    _assert_outputs(_forward(loaded, MAT), _jax_forward(jg, MAT))
    # a port-written graph loads in the JAX package, its keys kept
    path = str(tmp_path / "t.bigdl")
    ModuleSerializer.save(m, path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no dropped leaf
        jl = JS.load(path)
    assert [n.key for n in jl.exec_order] == [n.key for n in m.exec_order]
    _assert_outputs(_jax_forward(jl, MAT), _forward(m, MAT))
    # a graph field on a type that is no graph is ignored, as the
    # reference ignores it
    seq = SPECS["Sequential"][0]()
    ModuleSerializer.save(seq, path)
    with open(path, "rb") as f:
        mp = P.ModelProto.FromString(f.read())
    mp.module.graph = P.GraphDef(input_nodes=[0])
    with open(path, "wb") as f:
        f.write(mp.SerializeToString())
    for load in (lambda: ModuleSerializer.load(path, device="cpu"),
                 lambda: JS.load(path)):
        got = load()
        assert type(got).__name__ == "Sequential"
        _assert_outputs(_forward(got, MAT) if isinstance(got, torch.nn.Module)
                        else _jax_forward(got, MAT), _forward(seq, MAT))


def test_graph_wiring_and_keys_round_trip(tmp_path):
    """`tests/test_serialization.py:69` on the port: a diamond keeps its
    wiring, and the parameter keys survive the load."""
    inp = tnn.InputNode()
    h = tnn.Linear(6, 4, **_cpu()).inputs(inp)
    a = tnn.ReLU().inputs(h)
    b = tnn.Tanh().inputs(h)
    g = tnn.Graph([inp], [tnn.JoinTable(1).inputs(a, b)])
    x = np.random.RandomState(1).randn(3, 6).astype(np.float32)
    path = str(tmp_path / "g.bigdl")
    ModuleSerializer.save(g, path)
    loaded = ModuleSerializer.load(path, device="cpu")
    assert set(dict(loaded.named_parameters())) == \
        set(dict(g.named_parameters()))
    assert [[loaded.exec_order.index(p) for p in n.prev]
            for n in loaded.exec_order] == \
        [[g.exec_order.index(p) for p in n.prev] for n in g.exec_order]
    _assert_outputs(_forward(loaded, x), _forward(g, x), exact=True)


def test_a_reference_only_type_refuses_naming_the_roadmap(tmp_path):
    jm = jnn.Sequential().add(jnn.Abs())
    jm.set_params({"0_Abs": {}})
    jm._state = {}
    path = str(tmp_path / "abs.bigdl")
    JS.save(jm, path)
    with pytest.raises(NotImplementedError,
                       match="Abs is registered by the reference but not "
                       "ported yet .*queue 1 item 5"):
        ModuleSerializer.load(path, device="cpu")
    mp = P.ModelProto(module=P.BigDLModule(module_type="NoSuchLayer"))
    with open(path, "wb") as f:
        f.write(mp.SerializeToString())
    with pytest.raises(ValueError, match="unknown module type: NoSuchLayer"):
        ModuleSerializer.load(path, device="cpu")


def test_ctor_spec_leaves_out_the_port_keywords():
    g = torch.Generator().manual_seed(0)
    conv = tnn.SpatialConvolution(3, 4, 3, 3, pad_w=1, device="cpu",
                                  generator=g)
    assert conv._ctor_spec == ("SpatialConvolution", (3, 4, 3, 3),
                               {"pad_w": 1})
    # the outermost constructor records; a subclass's super() call does not
    stem = tnn.SpaceToDepthStemConvolution(3, 4, 3, device="cpu")
    assert stem._ctor_spec == ("SpaceToDepthStemConvolution", (3, 4, 3), {})
    # the ceil builder records its mode
    pool = tnn.SpatialMaxPooling(3, 3, 2, 2).ceil()
    assert pool._ctor_spec == ("SpatialMaxPooling", (3, 3, 2, 2),
                               {"ceil_mode": True})


@pytest.mark.parametrize("pool_cls", ["SpatialMaxPooling",
                                      "SpatialAveragePooling"])
def test_ceil_builder_rebinds_a_positional_ceil_mode(pool_cls, tmp_path):
    # ceil_mode given as the 7th positional: `.ceil()` sets it in place
    # rather than adding a keyword the rebuild would pass twice
    cls = getattr(tnn, pool_cls)
    pool = cls(3, 3, 2, 2, 0, 0, False).ceil()
    assert pool._ctor_spec == (pool_cls, (3, 3, 2, 2, 0, 0, True), {})
    model = tnn.Sequential().add(pool)
    path = str(tmp_path / "pool.bigdl")
    ModuleSerializer.save(model, path)
    loaded = ModuleSerializer.load(path, device="cpu")
    assert loaded.get_submodule(f"0_{pool_cls}").ceil_mode
    x = torch.from_numpy(np.random.RandomState(0).rand(
        1, 8, 8, 2).astype(np.float32))
    assert loaded(x).shape == model(x).shape == (1, 4, 4, 2)
    torch.testing.assert_close(loaded(x), model(x), rtol=0, atol=0)
